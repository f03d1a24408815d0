"""CLI: single-head IID+ overclustering of greyscale images, on one GPU
(``iic_tpu/cli/cluster_greyscale.py``), e.g. MNIST with model 685's
transform and batch flags and one overclustering head:

    python -m iic_tpu_torch.cli.cluster_greyscale --arch ClusterNet6c \\
      --mode IID+ --dataset MNIST --dataset_root DIR --gt_k 10 \\
      --output_k 50 --lr 0.0001 --batch_sz 700 --num_dataloaders 5 \\
      --num_sub_heads 5 --crop_orig --crop_other --tf1_crop centre_half \\
      --tf2_crop random --tf1_crop_sz 20 --tf2_crop_szs 16 20 24 \\
      --input_sz 24 --rot_val 25 --no_flip

It runs mode IID+ whatever ``--mode`` says, as the JAX CLI does, and the
plain loss
(see ``train_cluster_single``). Runs on cuda:0 and raises when there is no
GPU.
"""

from iic_tpu_torch.cli._args import parse_cluster_args
from iic_tpu_torch.train.cluster_trainer import train_cluster_single


def config(argv=None):
    """The script's config from its flags ``argv``."""
    cfg = parse_cluster_args(argv, defaults={"mode": "IID+"})
    cfg.finalize(twohead=False, sobel=False)
    return cfg


def main(argv=None, device=None):
    return train_cluster_single(config(argv), device=device)


if __name__ == "__main__":
    main()
