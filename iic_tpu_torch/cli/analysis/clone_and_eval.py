"""Analysis: clone a stored segmentation run and re-evaluate it
(``iic_tpu/cli/analysis/clone_and_eval.py``):

    python -m iic_tpu_torch.cli.analysis.clone_and_eval --model_ind 556 \\
      --old_model_ind 555 --out_root out

With ``--old_model_ind`` the old run's config.pickle (its model_ind
changed), checkpoints and config.txt are copied into a new run directory
``out_root/<model_ind>`` first; then the run at ``--model_ind`` is
re-evaluated (the Hungarian match included). Runs on cuda:0 unless
``main`` is given a device.
"""

import argparse
import os
import pickle
import shutil


def _clone_run(out_root, old_model_ind, model_ind):
    old_dir = os.path.join(out_root, str(old_model_ind))
    new_dir = os.path.join(out_root, str(model_ind))
    os.makedirs(new_dir, exist_ok=True)
    with open(os.path.join(old_dir, "config.pickle"), "rb") as f:
        meta = pickle.load(f)
    assert meta["config"]["model_ind"] == old_model_ind
    meta["config"]["model_ind"] = model_ind
    with open(os.path.join(new_dir, "config.pickle"), "wb") as f:
        pickle.dump(meta, f)
    copied = []
    for name in ("best.pytorch", "latest.pytorch", "config.txt"):
        src = os.path.join(old_dir, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(new_dir, name))
            copied.append(name)
    assert any(n.endswith(".pytorch") for n in copied), (
        f"no checkpoints found in {old_dir}")
    print(f"cloned run {old_model_ind} -> {model_ind} ({copied})")


def main(argv=None, device=None):
    from iic_tpu_torch.cli.analysis.eval import eval_apply
    from iic_tpu_torch.cli.analysis.render_general import (
        load_seg_run, seg_loaders)
    from iic_tpu_torch.device import resolve_device
    from iic_tpu_torch.evals.segmentation_eval import segmentation_eval

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_ind", type=int, required=True)
    parser.add_argument("--old_model_ind", type=int, default=-1,
                        help="clone this run into model_ind first")
    parser.add_argument("--out_root", type=str, default="out")
    args = parser.parse_args(argv)

    device = resolve_device(device)
    if args.old_model_ind >= 0:
        _clone_run(args.out_root, args.old_model_ind, args.model_ind)

    config, net, history = load_seg_run(args.out_root, args.model_ind,
                                        device=device)
    map_a, map_t = seg_loaders(config, device)
    stats = segmentation_eval(config, eval_apply(config, net), map_a, map_t,
                              return_only=True)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
