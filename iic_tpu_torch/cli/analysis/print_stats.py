"""Analysis: print the metric history of stored runs
(``iic_tpu/cli/analysis/print_stats.py``):

    python -m iic_tpu_torch.cli.analysis.print_stats --model_inds 640 685

Reads each run's config.pickle only, so it needs no device (``device`` is
taken for the CLIs' common signature).
"""

import argparse

import numpy as np


def main(argv=None, device=None):
    from iic_tpu_torch.train import checkpoint as ckpt

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_inds", type=int, nargs="+", required=True)
    parser.add_argument("--out_root", type=str, default="out")
    args = parser.parse_args(argv)

    for model_ind in args.model_inds:
        ev = ckpt.read_meta(args.out_root, model_ind)["history"]["eval"]
        best_epoch = int(np.argmax(ev.epoch_acc))
        avg = ev.epoch_avg_subhead_acc[best_epoch]
        print(f"model {model_ind}: epochs {len(ev.epoch_acc)} "
              f"best acc {max(ev.epoch_acc):.6f} (epoch {best_epoch}) "
              f"avg subhead acc at best {avg:.6f}")
        if ev.double_eval_acc:
            print(f"  double eval best: {max(ev.double_eval_acc):.6f}")


if __name__ == "__main__":
    main()
