"""CLI: export a trained run as a servable ``torch.export`` predictor
(``iic_tpu/cli/export_model.py``). Loads the run's best (or latest)
checkpoint and match, builds the predictor (preprocessing, forward, match)
and serializes it with a symbolic batch dim unless ``--fixed_batch``:

    python -m iic_tpu_torch.cli.export_model --out_root out --model_ind 640 \\
      --dest model.pt2 [--raw_sz 32] [--raw_channels 3] [--fixed_batch 64]

The artifact loads with ``torch.export.load`` alone. It is traced on
cuda:0 (raises when there is no GPU) and holds that device's tensors.
"""

import argparse

import numpy as np


def main(argv=None, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_root", required=True)
    p.add_argument("--model_ind", type=int, required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--raw_sz", type=int, default=0,
                   help="raw input H=W (default: the run's pre-crop size)")
    p.add_argument("--raw_channels", type=int, default=0,
                   help="raw input channels (default from the run config)")
    p.add_argument("--fixed_batch", type=int, default=0,
                   help="export a fixed batch size instead of symbolic")
    args = p.parse_args(argv)

    from iic_tpu_torch import infer

    config, net, stats = infer.load_run(args.out_root, args.model_ind,
                                        name=args.which, device=device)
    is_seg = "Segmentation" in config.arch
    predict = infer.make_predictor(config, net, stats)
    if is_seg:
        sz = args.raw_sz or config.input_sz
        c = args.raw_channels or (4 if config.using_IR else 3)
    else:
        sz = args.raw_sz or config.rand_crop_sz or config.input_sz
        c = args.raw_channels or (1 if config.in_channels in (1, 2) else 3)

    b = args.fixed_batch or 1
    example = np.zeros((b, sz, sz, c), np.uint8)
    infer.export_predictor(predict, example, path=args.dest,
                           symbolic_batch=not args.fixed_batch)
    print(f"exported {'seg' if is_seg else 'cluster'} predictor "
          f"(input ({'b' if not args.fixed_batch else b}, {sz}, {sz}, {c}) "
          f"uint8) -> {args.dest}")


if __name__ == "__main__":
    main()
