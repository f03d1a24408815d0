"""CLI: the KL-triplets baseline on colour images with sobel filtering, on
one GPU (``iic_tpu/cli/triplets_sobel.py``). CIFAR10's data flags:

    python -m iic_tpu_torch.cli.triplets_sobel --arch TripletsNet5g \\
      --dataset CIFAR10 --dataset_root DIR --gt_k 10 --lr 0.0001 \\
      --num_epochs 2000 --batch_sz 660 --num_dataloaders 3 --crop_orig \\
      --rand_crop_sz 20 --input_sz 32 [--kmeans_on_features]

Mode IID whatever ``--mode`` says, ``--output_k`` defaulting to
``--gt_k``, and a ClusterNet arch replaced by ``TripletsNet5g``, as the
JAX CLI has them. Runs on cuda:0 and raises when there is no GPU.
"""

from iic_tpu_torch.cli._args import parse_cluster_args
from iic_tpu_torch.train.triplets_trainer import train_triplets


def config(argv=None, sobel=True, arch="TripletsNet5g"):
    """The script's config from its flags ``argv``."""
    cfg = parse_cluster_args(argv, defaults={"mode": "IID"})
    if cfg.output_k is None:
        cfg.output_k = cfg.gt_k
    cfg.finalize(twohead=False, sobel=sobel)
    if cfg.arch.startswith("ClusterNet"):
        cfg.arch = arch
    return cfg


def main(argv=None, device=None):
    return train_triplets(config(argv), device=device)


if __name__ == "__main__":
    main()
