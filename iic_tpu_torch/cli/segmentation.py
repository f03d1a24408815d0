"""CLI: single-head IID+ segmentation (overclustering) on one GPU
(``iic_tpu/cli/segmentation.py``). Potsdam-3 overclustering:

    python -m iic_tpu_torch.cli.segmentation --mode IID+ \\
      --dataset Potsdam --dataset_root DIR --arch SegmentationNet10a \\
      --output_k 24 --gt_k 3 --use_coarse_labels --input_sz 200 \\
      --half_T_side_dense 10 --include_rgb --no_sobel ...

It runs mode IID+ whatever ``--mode`` says, as the JAX CLI does. Runs on
cuda:0 and raises when there is no GPU.
"""

from iic_tpu_torch.cli._args import parse_seg_args
from iic_tpu_torch.train.seg_trainer import train_segmentation_single


def main(argv=None, device=None):
    cfg = parse_seg_args(argv, defaults={"mode": "IID+"})
    cfg.finalize(twohead=False)
    return train_segmentation_single(cfg, device=device)


if __name__ == "__main__":
    main()
