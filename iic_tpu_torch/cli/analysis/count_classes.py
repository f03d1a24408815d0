"""Analysis: the label distribution over a segmentation dataset's
mapping-assignment set (``iic_tpu/cli/analysis/count_classes.py``):

    python -m iic_tpu_torch.cli.analysis.count_classes --model_inds 555
    python -m iic_tpu_torch.cli.analysis.count_classes <segmentation flags>

``--model_inds`` counts the datasets of stored runs (their configs);
otherwise the segmentation scripts' flags give the dataset. The loader
runs on cuda:0 unless ``main`` is given a device.
"""

import sys

import numpy as np


def main(argv=None, device=None):
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.device import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    if "--model_inds" in argv:
        import argparse

        from iic_tpu_torch.train import checkpoint as ckpt
        from iic_tpu_torch.train.config import config_from_dict
        parser = argparse.ArgumentParser()
        parser.add_argument("--model_inds", type=int, nargs="+",
                            required=True)
        parser.add_argument("--out_root", type=str, default="out")
        args = parser.parse_args(argv)
        device = resolve_device(device)
        out = None
        for model_ind in args.model_inds:
            print(f"model {model_ind}")
            cfg = config_from_dict(
                ckpt.read_meta(args.out_root, model_ind)["config"])
            out = _count(cfg, device)
        return out
    cfg = parse_seg_args(argv)
    cfg.finalize(twohead=True)
    return _count(cfg, resolve_device(device))


def _count(cfg, device):
    from iic_tpu_torch.data.seg_pipeline import (
        SegMappingLoader, seg_partitions)

    _, map_a, _ = seg_partitions(cfg)
    counts = np.zeros(cfg.gt_k, np.int64)
    masked_out = 0
    for _, labels, masks in SegMappingLoader(cfg, map_a, device=device):
        m = np.asarray(masks).astype(bool)
        vals, cnts = np.unique(np.asarray(labels)[m], return_counts=True)
        for v, c in zip(vals, cnts):
            if 0 <= v < cfg.gt_k:
                counts[v] += c
        masked_out += (~m).sum()
    total = counts.sum()
    for c in range(cfg.gt_k):
        print(f"class {c}: {counts[c]} ({counts[c] / max(total, 1):.4f})")
    print(f"masked out: {masked_out}")
    return counts


if __name__ == "__main__":
    main()
