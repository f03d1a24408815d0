"""Eval wall time of the two epoch-eval shapes that dominate the published
configs (``tools/eval_cost_bench.py`` of the JAX package).

    python -m iic_tpu_torch.tools.eval_cost_bench [all|cluster|seg] \\
        [--device cpu]

On cuda:0 by default; no GPU is an error unless ``--device cpu`` is given.

1. STL10-scale clustering mapping pass: 13,000 images (the train+test
   mapping partitions of the paper's STL10 runs, commands.txt:18), 96^2
   raw -> tf3 centre-crop 85 -> 64^2, sobel 5-ch, ClusterNet5gTwoHead
   head B (k=10, 5 sub-heads) -> the whole ``cluster_subheads_eval`` with
   the per-sub-head Hungarian matching, through ``MappingLoader``.
2. COCO-shaped segmentation eval: 1,000 images at 128^2,
   SegmentationNet10aTwoHead head B (k=3) -> ``segmentation_eval``'s
   per-pixel argmax, masked per-batch accumulation and Hungarian match,
   through ``SegMappingLoader``.

Each net is built as the port's trainers build it (``models.build`` under
``torch.manual_seed(config.seed)``, the eval forward by
``make_apply_fn``), random weights. Each eval runs once to warm up, then
once timed on the host's clock. The barrier is the stats dict itself: the
eval copies every batch's predictions to the host (``.cpu()``) and
matches there, so the card is done when it returns. Prints one JSON line
a measurement, with the TPU tool's keys.
"""

import json
import sys
import time

import torch

from iic_tpu_torch import models
from iic_tpu_torch.device import card_line, pop_device, resolve_device
from iic_tpu_torch.parallel.train_step import make_apply_fn
from iic_tpu_torch.train.config import ClusterConfig, SegConfig

WHICH = ("all", "cluster", "seg")


def cluster_config():
    """The TPU tool's clustering eval config."""
    return ClusterConfig(
        arch="ClusterNet5gTwoHead", mode="IID",
        dataset="Synthetic10x96x3x13000", dataset_root="", gt_k=10,
        output_k_A=70, output_k_B=10, num_sub_heads=5, batch_sz=512,
        num_dataloaders=1, include_rgb=True, crop_orig=True,
        rand_crop_sz=85, input_sz=64, batchnorm_track=True,
    ).finalize(twohead=True, sobel=True)


def seg_config():
    """The TPU tool's segmentation eval config."""
    return SegConfig(
        arch="SegmentationNet10aTwoHead", mode="IID",
        dataset="SyntheticSeg3x128x1000", dataset_root="", gt_k=3,
        output_k_A=15, output_k_B=3, num_sub_heads=1, batch_sz=120,
        num_dataloaders=1, input_sz=128, include_rgb=True,
        batchnorm_track=True, half_T_side_dense=10,
    ).finalize(twohead=True)


def build_net(cfg, device):
    """The config's net, initialised as the trainers do."""
    torch.manual_seed(cfg.seed)
    return models.build(cfg.arch, cfg).to(device)


def time_eval(run):
    """(stats of a timed ``run()``, its seconds), after one warm-up run."""
    run()
    t0 = time.perf_counter()
    stats = run()
    return stats, time.perf_counter() - t0


def cluster_eval_cost(device, cfg=None):
    """The clustering mapping eval's record, printed as a JSON line."""
    from iic_tpu_torch.data.pipeline import MappingLoader
    from iic_tpu_torch.evals.cluster_eval import cluster_subheads_eval

    cfg = cfg or cluster_config()
    apply_fn = make_apply_fn(build_net(cfg, device), head="B",
                             sobel=cfg.sobel, include_rgb=cfg.include_rgb)
    loader = MappingLoader(cfg, [True], device=device)
    n = len(loader.images)
    stats, dt = time_eval(lambda: cluster_subheads_eval(
        cfg, apply_fn, mapping_assignment_dataloader=loader,
        mapping_test_dataloader=loader))
    out = {"measurement": "STL10-scale cluster mapping eval "
                          "(13k imgs, 96^2 raw -> 64^2 sobel 5ch, "
                          "net5g twohead head B, 5 sub-heads, Hungarian)",
           "wall_s": round(dt, 2), "imgs_per_s": round(n / dt, 1),
           "best_acc_sanity": float(stats["best"])}
    print(json.dumps(out), flush=True)
    return out


def seg_eval_cost(device, cfg=None):
    """The segmentation eval's record, printed as a JSON line."""
    from iic_tpu_torch.data.seg_pipeline import SegMappingLoader
    from iic_tpu_torch.evals.segmentation_eval import segmentation_eval

    cfg = cfg or seg_config()
    apply_fn = make_apply_fn(build_net(cfg, device), head="B",
                             sobel=cfg.sobel, include_rgb=cfg.include_rgb,
                             using_IR=cfg.using_IR)
    loader = SegMappingLoader(cfg, ["train"], device=device)
    n = loader.total
    stats, dt = time_eval(lambda: segmentation_eval(
        cfg, apply_fn, loader, loader, return_only=True))
    px = n * cfg.input_sz * cfg.input_sz
    out = {"measurement": "COCO-shaped seg eval (1k imgs 128^2, net10a "
                          "twohead head B k=3, per-pixel Hungarian)",
           "wall_s": round(dt, 2), "imgs_per_s": round(n / dt, 1),
           "mpix_per_s": round(px / dt / 1e6, 1),
           "best_acc_sanity": float(stats["best"])}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device=None):
    """Runs ``all`` (default), ``cluster`` or ``seg``; returns the
    records."""
    argv, dev_arg = pop_device(sys.argv[1:] if argv is None else argv)
    which = argv[0] if argv else "all"
    if which not in WHICH or len(argv) > 1:
        raise ValueError(f"usage: [{'|'.join(WHICH)}] [--device DEVICE], "
                         f"got {argv}")
    device = resolve_device(device or dev_arg)
    print(card_line(device))
    results = []
    if which in ("all", "cluster"):
        results.append(cluster_eval_cost(device))
    if which in ("all", "seg"):
        results.append(seg_eval_cost(device))
    return results


if __name__ == "__main__":
    main()
