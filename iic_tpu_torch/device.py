"""The device the port's entry points run on."""

import subprocess

import torch


def resolve_device(device=None):
    """``cuda:0`` unless a device is given; no GPU is an error."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("found no GPU: the default device is cuda:0 (pass "
                           "a device, e.g. cpu, to run elsewhere)")
    return torch.device("cuda:0")


def pop_device(argv):
    """(argv without ``--device DEVICE``, DEVICE or None): the option of
    the tools whose other arguments are positional."""
    argv = list(argv)
    if "--device" not in argv:
        return argv, None
    i = argv.index("--device")
    if i + 1 == len(argv):
        raise ValueError("--device needs a value")
    return argv[:i] + argv[i + 2:], argv[i + 1]


def card_line(device):
    """One line naming what ``device`` is: for a card, its name
    (``torch.cuda.get_device_name``) and its power limit as ``nvidia-smi
    --query-gpu=power.limit`` reads it (a card set below its maximum runs
    slower under load); off CUDA, that the times are the host's."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"device: {device} (no card: every time is the host's)"
    index = device.index if device.index is not None else 0
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        limit = (smi.stdout or smi.stderr).strip() or "not read"
    except (OSError, subprocess.TimeoutExpired) as e:
        limit = f"not read ({type(e).__name__})"
    return (f"card: {torch.cuda.get_device_name(device)}, power limit "
            f"{limit}")
