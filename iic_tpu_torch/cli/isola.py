"""CLI: the Isola adjacency-prediction segmentation baseline, on one GPU
(``iic_tpu/cli/isola.py``). COCO-Stuff-3's data flags:

    python -m iic_tpu_torch.cli.isola --dataset Coco164kCuratedFew \\
      --dataset_root DIR --gt_k 3 --batch_sz 120 --input_sz 128 \\
      --include_rgb --isola_patch_side 11 [--per_sample_patches]

The arch defaults to ``SegmentationNet10aIsola``, as the JAX CLI sets it.
Runs on cuda:0 and raises when there is no GPU.
"""

from iic_tpu_torch.cli._args import parse_seg_args
from iic_tpu_torch.train.seg_baseline_trainers import train_seg_baseline


def config(argv=None):
    """The script's config from its flags ``argv``."""
    cfg = parse_seg_args(argv, defaults={"arch": "SegmentationNet10aIsola"})
    return cfg.finalize(twohead=False)


def main(argv=None, device=None):
    return train_seg_baseline(config(argv), kind="isola", device=device)


if __name__ == "__main__":
    main()
