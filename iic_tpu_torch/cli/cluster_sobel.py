"""CLI: single-head IID+ overclustering of colour images with sobel
filtering, on one GPU (``iic_tpu/cli/cluster_sobel.py``). Model 653
(STL10):

    python -m iic_tpu_torch.cli.cluster_sobel --model_ind 653 \\
      --arch ClusterNet5g --dataset STL10 --dataset_root DIR \\
      --num_epochs 3200 --output_k 140 --gt_k 10 --lr 0.0001 --lamb 1.0 \\
      --num_sub_heads 5 --batch_sz 1400 --num_dataloaders 5 --mix_train \\
      --crop_orig --rand_crop_sz 64 --input_sz 64 --mode IID+ \\
      --batchnorm_track

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
    cfg.finalize(twohead=False, sobel=True)
    return cfg


def main(argv=None, device=None):
    return train_cluster_single(config(argv), device=device)


if __name__ == "__main__":
    main()
