"""CLI: two-head IIC clustering of colour images with sobel filtering, on
one GPU (``iic_tpu/cli/cluster_sobel_twohead.py``). Model 640 (CIFAR10):

    python -m iic_tpu_torch.cli.cluster_sobel_twohead --model_ind 640 \\
      --arch ClusterNet5gTwoHead --mode IID --dataset CIFAR10 \\
      --dataset_root DIR --gt_k 10 --output_k_A 70 --output_k_B 10 \\
      --lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 660 \\
      --num_dataloaders 3 --num_sub_heads 5 --crop_orig --rand_crop_sz 20 \\
      --input_sz 32 --head_A_first --head_B_epochs 2 --double_eval \\
      --batchnorm_track --fused_loss

``--dataset Synthetic10x32x3`` trains on generated images of the same
shape. Runs on cuda:0 and raises when there is no GPU.
"""

from iic_tpu_torch.cli._args import parse_cluster_args
from iic_tpu_torch.train.cluster_trainer import train_cluster_twohead


def config(argv=None):
    """The script's config from its flags ``argv``."""
    cfg = parse_cluster_args(argv)
    cfg.lamb_A = cfg.lamb
    cfg.lamb_B = cfg.lamb
    cfg.finalize(twohead=True, sobel=True)
    return cfg


def main(argv=None, device=None):
    return train_cluster_twohead(config(argv), device=device)


if __name__ == "__main__":
    main()
