"""Analysis: re-colour saved prediction renders with the palette rotated
(``iic_tpu/cli/analysis/colour_scheme_change.py``):

    python -m iic_tpu_torch.cli.analysis.colour_scheme_change \\
      --in_dir DIR --out_dir OUT --num_classes 3 [--rotate 1]
    python -m iic_tpu_torch.cli.analysis.colour_scheme_change --in_dir DIR \\
      --file_pattern 'preds_%d.png' --file_indices 0 1 --num_classes 3

The second form selects files by a printf pattern and writes into
``in_dir/<out_subdir>``. Reads and writes PNGs (PIL) and touches no device
(``device`` is taken for the CLIs' common signature).
"""

import argparse
import glob
import os

import numpy as np


def main(argv=None, device=None):
    from PIL import Image

    from iic_tpu_torch.utils.render import _palette

    parser = argparse.ArgumentParser()
    parser.add_argument("--in_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, default="")
    parser.add_argument("--num_classes", type=int, required=True)
    parser.add_argument("--rotate", type=int, default=1,
                        help="rotate palette by this many hues")
    parser.add_argument("--file_pattern", type=str, default="",
                        help="e.g. 'preds_%%d.png'; with --file_indices, "
                        "selects files the reference way")
    parser.add_argument("--file_indices", type=int, nargs="+", default=[])
    parser.add_argument("--out_subdir", type=str, default="colour_change")
    args = parser.parse_args(argv)

    if args.file_pattern:
        assert args.file_indices, "--file_pattern needs --file_indices"
        paths = [os.path.join(args.in_dir, args.file_pattern % i)
                 for i in args.file_indices]
        out_dir = args.out_dir or os.path.join(args.in_dir,
                                               args.out_subdir)
    else:
        assert args.out_dir, "pass --out_dir (or --file_pattern mode)"
        paths = glob.glob(os.path.join(args.in_dir, "*.png"))
        out_dir = args.out_dir

    os.makedirs(out_dir, exist_ok=True)
    old = _palette(args.num_classes)
    new = np.roll(old, args.rotate, axis=0)
    for path in paths:
        img = np.array(Image.open(path).convert("RGB"))
        out = img.copy()
        for c in range(args.num_classes):
            sel = (img == old[c]).all(axis=-1)
            out[sel] = new[c]
        Image.fromarray(out).save(
            os.path.join(out_dir, os.path.basename(path)))
    print(f"recoloured renders written to {out_dir}")


if __name__ == "__main__":
    main()
