"""Analysis: loss-based against eval-based sub-head selection for trained
two-head clustering runs (``iic_tpu/cli/analysis/print_sub_heads_eval.py``;
the output format of examples/subheads_lowest_loss.out):

    python -m iic_tpu_torch.cli.analysis.print_sub_heads_eval \\
      --model_inds 640 --out_root out

The loss-based pick is the sub-head of lowest IID loss (the plain loss)
over head B's epoch-0 pairs, eval-mode BN. Runs on cuda:0 unless ``main``
is given a device.
"""

import argparse

import numpy as np


def main(argv=None, device=None):
    from iic_tpu_torch.cli.analysis.eval import eval_apply
    from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
    from iic_tpu_torch.device import resolve_device
    from iic_tpu_torch.evals.cluster_eval import get_subhead_using_loss
    from iic_tpu_torch.infer import load_weights

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_inds", type=int, nargs="+", required=True)
    parser.add_argument("--out_root", type=str, default="out")
    args = parser.parse_args(argv)

    device = resolve_device(device)
    results = {}
    for model_ind in args.model_inds:
        config, net, meta, _ = load_weights(args.out_root, model_ind,
                                            device=device)
        history = meta["history"]
        ev = history["eval"]
        best_epoch = int(np.argmax(ev.epoch_acc))
        stats = ev.epoch_stats[best_epoch]
        best_sub_head_eval = stats["best_train_sub_head"]
        test_accs = stats["test_accs"]

        _, pipe_b, _, _ = cluster_twohead_create_dataloaders(config,
                                                             device=device)
        apply_fn = eval_apply(config, net)

        def pairs():
            for imgs, imgs_tf in pipe_b.epoch(0, augmented=True):
                yield apply_fn(imgs), apply_fn(imgs_tf)

        best_sub_head_loss = get_subhead_using_loss(
            config, pairs(), lamb=getattr(config, "lamb_B", config.lamb))

        print(f"model {model_ind}:")
        print(f"best sub_head by loss: {best_sub_head_loss}")
        print(f"best sub_head by eval: {best_sub_head_eval}")
        print(f"... loss select acc: {test_accs[best_sub_head_loss]:f}, "
              f"eval select acc: {test_accs[best_sub_head_eval]:f}")
        results[model_ind] = {
            "loss_select_acc": test_accs[best_sub_head_loss],
            "eval_select_acc": test_accs[best_sub_head_eval],
        }
    return results


if __name__ == "__main__":
    main()
