"""Analysis: render predictions, labels and masks of trained segmentation
runs (``iic_tpu/cli/analysis/render_general.py``, which is also
render_potsdam: the dataset comes from the stored config):

    python -m iic_tpu_torch.cli.analysis.render_general --model_inds 555 \\
      [--net_name best|latest] [--num 10] [--imgs_dataloaders test train] \\
      [--reassess_acc | --get_match_only | --best_match 2 0 1]

``--reassess_acc`` recomputes the accuracy and stops; ``--get_match_only``
prints the best sub-head's Hungarian match and stops; ``--best_match``
gives the match (index = predicted cluster) and skips the eval pass.
Rendered predictions are the best sub-head's, reordered by its match, in
``out_root/<model_ind>/renders/<dataloader>/<net_name>`` (PNG by PIL).
Runs on cuda:0 unless ``main`` is given a device.
"""

import argparse
import os

import numpy as np


def load_seg_run(out_root, model_ind, name=None, device=None):
    """Reload a stored segmentation run: (config, net, history), the
    partition tables rebuilt on ``config``."""
    from iic_tpu_torch.data.seg_pipeline import seg_partitions
    from iic_tpu_torch.infer import load_weights

    config, net, meta, _ = load_weights(out_root, model_ind, name or "best",
                                        device)
    (config.train_partitions, config.mapping_assignment_partitions,
     config.mapping_test_partitions) = seg_partitions(config)
    return config, net, meta["history"]


def seg_loaders(config, device):
    """(mapping assignment loader, mapping test loader)."""
    from iic_tpu_torch.data.seg_pipeline import SegMappingLoader
    return (SegMappingLoader(config, config.mapping_assignment_partitions,
                             device=device),
            SegMappingLoader(config, config.mapping_test_partitions,
                             device=device))


def main(argv=None, device=None):
    from iic_tpu_torch.cli.analysis.eval import eval_apply
    from iic_tpu_torch.device import resolve_device
    from iic_tpu_torch.evals.metrics import reorder_preds
    from iic_tpu_torch.evals.segmentation_eval import segmentation_eval
    from iic_tpu_torch.utils.render import render

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_ind", type=int, default=-1)
    parser.add_argument("--model_inds", type=int, nargs="+", default=[])
    parser.add_argument("--out_root", type=str, default="out")
    parser.add_argument("--net_name", type=str, default="",
                        help="best | latest ('' = best if present)")
    parser.add_argument("--num", "--num_images", dest="num", type=int,
                        default=10)
    parser.add_argument("--imgs_dataloaders", type=str, nargs="+",
                        default=["test"], choices=["test", "train"])
    parser.add_argument("--reassess_acc", default=False,
                        action="store_true")
    parser.add_argument("--get_match_only", default=False,
                        action="store_true")
    parser.add_argument("--best_match", type=int, nargs="+", default=[],
                        help="explicit cluster->gt match (index = pred "
                        "id), skipping the eval pass")
    args = parser.parse_args(argv)
    model_inds = args.model_inds or ([args.model_ind]
                                     if args.model_ind >= 0 else [])
    if not model_inds:
        parser.error("pass --model_ind or --model_inds")

    device = resolve_device(device)
    results = {}
    for model_ind in model_inds:
        config, net, history = load_seg_run(
            args.out_root, model_ind, name=args.net_name or None,
            device=device)
        apply_fn = eval_apply(config, net)
        map_a, map_t = seg_loaders(config, device)

        if args.best_match and not args.reassess_acc:
            # an explicit match: no eval pass; the sub-head from the
            # stored history when there is one
            match = list(enumerate(args.best_match))
            ev = history.get("eval") if isinstance(history, dict) else None
            sub_head = 0
            if ev is not None and list(getattr(ev, "epoch_stats", [])):
                sub_head = ev.epoch_stats[-1].get(
                    "best_train_sub_head", 0)
            stats = {"best_train_sub_head": sub_head,
                     "best_train_sub_head_match": match}
        else:
            stats = segmentation_eval(config, apply_fn, map_a, map_t,
                                      return_only=True)
            sub_head = stats["best_train_sub_head"]
            match = stats["best_train_sub_head_match"]
        print(f"model {model_ind}: best sub-head {sub_head} "
              f"match {match}")
        results[model_ind] = stats
        if args.reassess_acc:
            print(f"model {model_ind}: reassessed acc "
                  f"{stats['best']:.6f}")
            continue
        if args.get_match_only:
            continue

        for dl_name in args.imgs_dataloaders:
            loader = map_t if dl_name == "test" else map_a
            out_dir = os.path.join(
                args.out_root, str(model_ind), "renders", dl_name,
                args.net_name or "best")
            imgs, labels, masks = next(iter(loader))
            n = min(args.num, imgs.shape[0])
            outs = apply_fn(imgs)  # (H, bn, k, h, w)
            preds = outs[sub_head].argmax(dim=1).cpu().numpy()
            # cluster ids -> gt ids via the best sub-head's match
            preds = reorder_preds(preds.reshape(-1), match).reshape(
                preds.shape)

            render(imgs[:n], mode="image", name="img", out_dir=out_dir)
            render(np.asarray(labels)[:n], mode="label", name="label",
                   out_dir=out_dir)
            render(preds[:n], mode="preds", name="preds", out_dir=out_dir)
            render(np.asarray(masks)[:n], mode="mask", name="mask",
                   out_dir=out_dir)
            print(f"wrote renders to {out_dir}")
    return results


if __name__ == "__main__":
    main()
