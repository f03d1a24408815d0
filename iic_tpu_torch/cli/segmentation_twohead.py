"""CLI: two-head IIC segmentation on one GPU
(``iic_tpu/cli/segmentation_twohead.py``).

    python -m iic_tpu_torch.cli.segmentation_twohead --mode IID \\
      --dataset SyntheticSeg3x146x480 --arch SegmentationNet10aTwoHead \\
      --output_k_A 15 --output_k_B 3 --gt_k 3 --input_sz 128 \\
      --half_T_side_dense 10 --include_rgb --use_uncollapsed_loss ...

Runs on cuda:0 and raises when there is no GPU.
"""

from iic_tpu_torch.cli._args import parse_seg_args
from iic_tpu_torch.train.seg_trainer import train_segmentation_twohead


def main(argv=None, device=None):
    cfg = parse_seg_args(argv)
    cfg.finalize(twohead=True)
    return train_segmentation_twohead(cfg, device=device)


if __name__ == "__main__":
    main()
