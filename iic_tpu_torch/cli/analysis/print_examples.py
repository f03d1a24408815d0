"""Analysis: render example images and write their predictions for a
trained clustering run (``iic_tpu/cli/analysis/print_examples.py``):

    python -m iic_tpu_torch.cli.analysis.print_examples --model_ind 640 \\
      --num_imgs 20

Writes ``out_root/<model_ind>/examples/example_<i>.png`` (PIL) and
``preds.txt`` (sub-head 0's cluster and the label of each). Runs on cuda:0
unless ``main`` is given a device.
"""

import argparse
import os


def main(argv=None, device=None):
    from iic_tpu_torch.cli.analysis.eval import (
        cluster_loaders, eval_apply)
    from iic_tpu_torch.device import resolve_device
    from iic_tpu_torch.infer import load_weights
    from iic_tpu_torch.utils.render import render

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_ind", type=int, required=True)
    parser.add_argument("--out_root", type=str, default="out")
    parser.add_argument("--num_imgs", "--num_examples",
                        dest="num_examples", type=int, default=20)
    args = parser.parse_args(argv)

    device = resolve_device(device)
    config, net, _, _ = load_weights(args.out_root, args.model_ind,
                                     device=device)
    map_a, _ = cluster_loaders(config, device)
    apply_fn = eval_apply(config, net)

    out_dir = os.path.join(args.out_root, str(args.model_ind), "examples")
    imgs, labels = next(iter(map_a))
    preds = apply_fn(imgs)[0].argmax(dim=1).cpu().numpy()  # sub-head 0
    n = min(args.num_examples, imgs.shape[0])
    render(imgs[:n], mode="image", name="example", out_dir=out_dir)
    with open(os.path.join(out_dir, "preds.txt"), "w") as f:
        for i in range(n):
            f.write(f"example_{i}: pred {int(preds[i])} "
                    f"gt {int(labels[i])}\n")
    print(f"wrote {n} examples to {out_dir}")


if __name__ == "__main__":
    main()
