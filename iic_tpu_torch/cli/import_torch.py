"""Import a reference (xu-ji/IIC) PyTorch run directory into a port run
(``iic_tpu/cli/import_torch.py``):

    python -m iic_tpu_torch.cli.import_torch --ref_dir <reference out/NNN> \\
      --out_root out --model_ind NNN [--greyscale] [--arch NAME] \\
      [--net_file FILE] [--set key=value ...] [--allow_pickle]

Converts the reference's trained checkpoints (cluster-format
``latest_net.pytorch`` / ``best_net.pytorch``, segmentation-format
``latest.pytorch`` / ``best.pytorch``, or an explicit ``--net_file``) into
a port run directory ``out_root/model_ind`` with ``latest.pytorch`` /
``best.pytorch``, ``config.pickle`` and ``config.txt``, which every run
reader takes: the trainers under ``--restart``, ``infer.load_run`` and
``cli/export_model``, the analysis CLIs.

The config comes from the reference dir's ``config.pickle`` when readable
(a py2 pickle of an argparse.Namespace whose fields map onto the port's
dataclasses; unknown keys dropped), completed or overridden by ``--arch``
and repeated ``--set key=value`` (values parsed as JSON, else strings).
The optimiser is not imported: each checkpoint holds a freshly built
Adam's state, so ``--restart`` starts it anew (``last_epoch`` from
``--last_epoch``, default 0). ``--sup_head5``: ``--net_file`` is a
SupHead5 wrapper, and its wrapped cluster net (``trunk.*``) is imported;
``compat.torch_import.sup_head5_to_port`` maps the whole wrapper onto
``models.semisup.SemisupNet``.

Net files are read as weights only and config.pickle builds no class but
a Namespace's and numpy's; ``--allow_pickle`` unpickles either in full,
which runs whatever code the file names, so it is for trusted files only
(the JAX CLI always falls back to a full unpickle, and has no such flag).

The nets are built and filled on the CPU, then moved to the device
(cuda:0 unless ``main`` is given one; no GPU is an error) for the save.
"""

import argparse
import collections
import json
import os

from iic_tpu_torch import models
from iic_tpu_torch.compat import torch_import as ti
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.train.config import SegConfig, config_from_dict

# reference filename -> the port's checkpoint name, in discovery order
_NET_FILES = [
    ("best_net.pytorch", "best"),      # cluster + semisup scripts
    ("latest_net.pytorch", "latest"),
    ("best.pytorch", "best"),          # segmentation scripts
    ("latest.pytorch", "latest"),
]


def build_net(config, semisup_head_B=False):
    """The net of any registry arch (baselines included)."""
    if semisup_head_B:
        config.semisup = True  # models.build reads getattr(config, ...)
    return models.build(config.arch, config)


def _fresh_history(arch):
    if arch.startswith("Triplets"):
        from iic_tpu_torch.train.triplets_trainer import make_history
        return make_history()
    if arch.endswith(("Doersch", "Isola")):
        return {"epoch_acc": [], "epoch_loss": [], "step_seconds": []}
    from iic_tpu_torch.train.seg_trainer import make_history
    return make_history()


def assemble_config(args):
    ref_cfg, notes = {}, []
    if args.ref_dir:
        p = os.path.join(args.ref_dir, "config.pickle")
        if os.path.exists(p):
            try:
                ref_cfg = ti.read_reference_config(
                    p, allow_pickle=args.allow_pickle)
            except ti.TorchImportError as e:
                notes.append(f"reference config unreadable ({e}); "
                             "relying on --arch/--set flags")
    overrides = {}
    for kv in args.set or []:
        k, _, v = kv.partition("=")
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    merged = {**ref_cfg, **overrides}
    if args.arch:
        merged["arch"] = args.arch
    if "arch" not in merged:
        raise SystemExit("no arch: pass --arch or a readable reference "
                         "config.pickle")
    merged["out_root"] = args.out_root
    merged["model_ind"] = args.model_ind
    config = config_from_dict(merged)
    twohead = "TwoHead" in config.arch
    if isinstance(config, SegConfig):
        config.finalize(twohead=twohead)
    else:
        config.finalize(twohead=twohead, sobel=not args.greyscale)
    # explicit overrides win over finalize()'s derivations (e.g. an
    # in_channels the reference run dir recorded)
    for k, v in overrides.items():
        if hasattr(config, k):
            setattr(config, k, v)
    return config, notes


def import_one(config, net_path, name, sup_head5=False, last_epoch=0,
               device="cpu", allow_pickle=False):
    """Import one reference net file into config's run dir as
    <name>.pytorch, beside a fresh optimiser's state. A two-head net is
    built with the semisup head B where the file's head B is one Linear.
    Returns the warnings list."""
    from iic_tpu_torch.parallel.train_step import make_optimizer
    from iic_tpu_torch.train import checkpoint as ckpt

    sd = ti.load_torch_file(net_path, allow_pickle=allow_pickle)
    if sup_head5:
        sd = collections.OrderedDict(
            (k[len("trunk."):], v) for k, v in sd.items()
            if k.startswith("trunk."))
        if not sd:
            raise ti.TorchImportError(
                f"{net_path}: no trunk.* keys: not a SupHead5 checkpoint")
    warnings = []
    net = build_net(config, semisup_head_B=ti.has_semisup_head_B(sd))
    ti.load_into(net, ti.reference_to_port(config.arch, sd), warnings)
    net.to(device)
    ckpt.save_checkpoint(config, net, make_optimizer(net, config),
                         _fresh_history(config.arch), name=name,
                         last_epoch=last_epoch)
    return warnings


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(
        description="Import reference IIC torch checkpoints")
    parser.add_argument("--ref_dir", type=str, default="",
                        help="reference run dir (out/<model_ind>)")
    parser.add_argument("--net_file", type=str, default="",
                        help="explicit .pytorch file instead of scanning "
                        "--ref_dir")
    parser.add_argument("--out_root", type=str, required=True)
    parser.add_argument("--model_ind", type=int, required=True)
    parser.add_argument("--arch", type=str, default="")
    parser.add_argument("--greyscale", default=False, action="store_true",
                        help="greyscale (non-sobel) cluster config")
    parser.add_argument("--sup_head5", default=False, action="store_true",
                        help="--net_file is a SupHead5 wrapper: import the "
                        "wrapped cluster net (--arch = the wrapped arch)")
    parser.add_argument("--last_epoch", type=int, default=0)
    parser.add_argument("--set", action="append", metavar="KEY=VALUE",
                        help="config field override (JSON value)")
    parser.add_argument("--allow_pickle", default=False, action="store_true",
                        help="unpickle a net file in full where it holds "
                        "more than tensors and plain containers: runs any "
                        "code the file names, so only for a trusted file")
    args = parser.parse_args(argv)

    if not args.ref_dir and not args.net_file:
        parser.error("need --ref_dir and/or --net_file")
    device = resolve_device(device)
    config, notes = assemble_config(args)
    for n in notes:
        print(f"note: {n}")

    jobs = []
    if args.net_file:
        name = "best" if "best" in os.path.basename(args.net_file) \
            else "latest"
        jobs.append((args.net_file, name))
    else:
        for fname, name in _NET_FILES:
            p = os.path.join(args.ref_dir, fname)
            if os.path.exists(p) and not any(n == name for _, n in jobs):
                jobs.append((p, name))
    if not jobs:
        raise SystemExit(f"no .pytorch net files found in {args.ref_dir}")

    for path, name in jobs:
        warnings = import_one(config, path, name, sup_head5=args.sup_head5,
                              last_epoch=args.last_epoch, device=device,
                              allow_pickle=args.allow_pickle)
        for w in warnings:
            print(f"warning: {w}")
        print(f"imported {path} -> "
              f"{os.path.join(config.out_root, str(config.model_ind))}"
              f"/{name}.pytorch")


if __name__ == "__main__":
    main()
