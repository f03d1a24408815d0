"""CLI: the KL-triplets baseline on greyscale images, on one GPU
(``iic_tpu/cli/triplets_greyscale.py``). MNIST's data flags:

    python -m iic_tpu_torch.cli.triplets_greyscale --arch TripletsNet6c \\
      --dataset MNIST --dataset_root DIR --gt_k 10 --lr 0.0001 \\
      --batch_sz 700 --num_dataloaders 5 --crop_orig --crop_other \\
      --tf1_crop centre_half --tf2_crop random --tf1_crop_sz 20 \\
      --tf2_crop_szs 16 20 24 --input_sz 24 --rot_val 25 --no_flip

Mode IID whatever ``--mode`` says, ``--output_k`` defaulting to
``--gt_k``, and a ClusterNet arch replaced by ``TripletsNet6c``, as the
JAX CLI has them. Runs on cuda:0 and raises when there is no GPU.
"""

from iic_tpu_torch.cli import triplets_sobel
from iic_tpu_torch.train.triplets_trainer import train_triplets


def config(argv=None):
    """The script's config from its flags ``argv``."""
    return triplets_sobel.config(argv, sobel=False, arch="TripletsNet6c")


def main(argv=None, device=None):
    return train_triplets(config(argv), device=device)


if __name__ == "__main__":
    main()
