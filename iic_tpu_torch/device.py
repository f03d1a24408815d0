"""The device the port's entry points run on."""

import torch


def resolve_device(device=None):
    """``cuda:0`` unless a device is given; no GPU is an error."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("found no GPU: the default device is cuda:0 (pass "
                           "a device, e.g. cpu, to run elsewhere)")
    return torch.device("cuda:0")
