"""CLI: the Doersch context-prediction segmentation baseline, on one GPU
(``iic_tpu/cli/doersch.py``). COCO-Stuff-3's data flags:

    python -m iic_tpu_torch.cli.doersch --dataset Coco164kCuratedFew \\
      --dataset_root DIR --gt_k 3 --batch_sz 120 --input_sz 128 \\
      --include_rgb --doersch_patch_side 11 [--per_sample_patches]

The arch defaults to ``SegmentationNet10aDoersch`` and the colour
dropping is on (``use_doersch_datasets``), as the JAX CLI sets them. Runs
on cuda:0 and raises when there is no GPU.
"""

from iic_tpu_torch.cli._args import parse_seg_args
from iic_tpu_torch.train.seg_baseline_trainers import train_seg_baseline


def config(argv=None):
    """The script's config from its flags ``argv``."""
    cfg = parse_seg_args(argv, defaults={"arch": "SegmentationNet10aDoersch",
                                         "use_doersch_datasets": True})
    return cfg.finalize(twohead=False)


def main(argv=None, device=None):
    return train_seg_baseline(config(argv), kind="doersch", device=device)


if __name__ == "__main__":
    main()
