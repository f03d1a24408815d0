"""CLI: two-head IIC clustering of greyscale images, on one GPU
(``iic_tpu/cli/cluster_greyscale_twohead.py``). Model 685 (MNIST):

    python -m iic_tpu_torch.cli.cluster_greyscale_twohead --model_ind 685 \\
      --arch ClusterNet6cTwoHead --mode IID --dataset MNIST \\
      --dataset_root DIR --gt_k 10 --output_k_A 50 --output_k_B 10 \\
      --lamb_A 1.0 --lamb_B 1.0 --lr 0.0001 --num_epochs 3200 \\
      --batch_sz 700 --num_dataloaders 5 --num_sub_heads 5 --crop_orig \\
      --crop_other --tf1_crop centre_half --tf2_crop random \\
      --tf1_crop_sz 20 --tf2_crop_szs 16 20 24 --input_sz 24 --rot_val 25 \\
      --no_flip --head_B_epochs 2

``--dataset Digits`` trains on the UCI optical digits the port carries
(no ``--dataset_root``). Unlike the sobel script, ``--lamb`` does not set
the heads' lambdas: ``--lamb_A`` and ``--lamb_B`` do. Runs on cuda:0 and
raises when there is no GPU.
"""

from iic_tpu_torch.cli._args import parse_cluster_args
from iic_tpu_torch.train.cluster_trainer import train_cluster_twohead


def config(argv=None):
    """The script's config from its flags ``argv``."""
    cfg = parse_cluster_args(argv)
    cfg.finalize(twohead=True, sobel=False)
    return cfg


def main(argv=None, device=None):
    return train_cluster_twohead(config(argv), device=device)


if __name__ == "__main__":
    main()
