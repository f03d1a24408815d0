"""Analysis: print a net's structure, its parameters' names, shapes and
counts (``iic_tpu/cli/analysis/print_nets.py``):

    python -m iic_tpu_torch.cli.analysis.print_nets \\
      --arch ClusterNet5gTwoHead --input_sz 32 --in_channels 5

The names are the port's ``state_dict`` names (the reference's). The net
is built on cuda:0 unless ``main`` is given a device.
"""

import argparse
from types import SimpleNamespace


def main(argv=None, device=None):
    from iic_tpu_torch import models
    from iic_tpu_torch.device import resolve_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", type=str, default="ClusterNet5gTwoHead")
    parser.add_argument("--input_sz", type=int, default=64)
    parser.add_argument("--in_channels", type=int, default=5)
    parser.add_argument("--output_k", type=int, default=10)
    parser.add_argument("--output_k_A", type=int, default=70)
    parser.add_argument("--output_k_B", type=int, default=10)
    parser.add_argument("--num_sub_heads", type=int, default=5)
    args = parser.parse_args(argv)

    cfg = SimpleNamespace(**vars(args), batchnorm_track=True)
    net = models.build(args.arch, cfg).to(resolve_device(device))
    total = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        print(f"{name}: {tuple(p.shape)} ({n})")
    print(f"total params: {total:,}")
    return total


if __name__ == "__main__":
    main()
