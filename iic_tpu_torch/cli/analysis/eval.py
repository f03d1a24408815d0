"""Analysis: reload a trained clustering run and re-evaluate it
(``iic_tpu/cli/analysis/eval.py``):

    python -m iic_tpu_torch.cli.analysis.eval --model_ind 640 --out_root out

Prints the eval stats (best sub-head, its match, every sub-head's
accuracy). Runs on cuda:0 unless ``main`` is given a device.
"""

import argparse

from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.infer import load_weights


def cluster_loaders(config, device):
    """(mapping assignment loader, mapping test loader) of a clustering
    run, its partitions set on ``config``."""
    from iic_tpu_torch.data.pipeline import (
        cluster_create_dataloaders, cluster_twohead_create_dataloaders)
    if config.twohead:
        return cluster_twohead_create_dataloaders(config, device=device)[2:]
    return cluster_create_dataloaders(config, device=device)[1:]


def eval_apply(config, net, train_mode=False):
    """The run's eval forward: head B of a two-head net, sobel as trained."""
    from iic_tpu_torch.parallel.train_step import make_apply_fn
    return make_apply_fn(net, head="B" if config.twohead else None,
                         sobel=config.sobel, include_rgb=config.include_rgb,
                         using_IR=getattr(config, "using_IR", False),
                         train_mode=train_mode)


def main(argv=None, device=None):
    from iic_tpu_torch.evals.cluster_eval import cluster_eval

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_ind", type=int, required=True)
    parser.add_argument("--out_root", type=str, default="out")
    args = parser.parse_args(argv)

    device = resolve_device(device)
    config, net, _, _ = load_weights(args.out_root, args.model_ind,
                                     device=device)
    map_a, map_t = cluster_loaders(config, device)
    _, stats = cluster_eval(config, eval_apply(config, net), map_a, map_t)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
