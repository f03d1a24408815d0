"""Analysis: set a field in a stored run's config.pickle
(``iic_tpu/cli/analysis/update_config.py``):

    python -m iic_tpu_torch.cli.analysis.update_config --model_ind 640 \\
      --field lamb --value 1.5

The value is read as a Python literal where it parses as one, else kept
as a string. Touches no device (``device`` is taken for the CLIs' common
signature).
"""

import argparse
import ast
import os
import pickle


def main(argv=None, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_ind", type=int, required=True)
    parser.add_argument("--out_root", type=str, default="out")
    parser.add_argument("--field", type=str, required=True)
    parser.add_argument("--value", type=str, required=True)
    args = parser.parse_args(argv)

    path = os.path.join(args.out_root, str(args.model_ind), "config.pickle")
    with open(path, "rb") as f:
        meta = pickle.load(f)
    try:
        value = ast.literal_eval(args.value)
    except (ValueError, SyntaxError):
        value = args.value
    old = meta["config"].get(args.field, "<unset>")
    meta["config"][args.field] = value
    with open(path, "wb") as f:
        pickle.dump(meta, f)
    print(f"model {args.model_ind}: {args.field}: {old} -> {value}")


if __name__ == "__main__":
    main()
