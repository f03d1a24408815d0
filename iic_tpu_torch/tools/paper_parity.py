"""The BASELINE.md accuracy-parity harness (``tools/paper_parity.py`` of
the JAX package), driving the port's CLIs.

Maps every accuracy row of BASELINE.md to its exact paper command line
(reference: examples/commands.txt:18-89, flags reproduced verbatim minus
the host-specific --dataset_root / output redirection), verifies the
dataset directory layout the readers expect, launches the run, and emits
the accuracy-vs-baseline table from the stored run histories:

    python -m iic_tpu_torch.tools.paper_parity list
    python -m iic_tpu_torch.tools.paper_parity check \\
        --dataset_root /data/MNIST --rows mnist
    python -m iic_tpu_torch.tools.paper_parity run \\
        --dataset_root /data/MNIST --rows mnist --out_root /data/out \\
        [--device cpu] [-- --test_code]
    python -m iic_tpu_torch.tools.paper_parity report --out_root /data/out

``run`` trains each row on ``--device`` (cuda:0 by default; no GPU is an
error unless ``--device cpu`` is given) in a child process of its own,
which calls the row's CLI ``main(argv, device=...)``, so a crash or a hang
of one row cannot take the harness down. It appends the child's stdout and
stderr to <out_root>/<model_ind>.out (like the reference's nohup
redirection), refuses a row whose dataset check fails, and returns 1 when
any row was refused or failed. ``report`` reads
<out_root>/<model_ind>/config.pickle and prints best-sub-head accuracy
(max over epochs, exactly the number the reference's logs report as
`best:`) against the BASELINE.md value with the 1-pt parity verdict.
Everything after a literal `--` is passed through to the trainer
(e.g. `-- --test_code`, `-- --num_epochs 50`).

The COCO rows' reader needs OpenCV; where it is not installed those rows
can be checked but not run.
"""

import argparse
import dataclasses
import importlib
import os
import subprocess
import sys

# the directory that holds this iic_tpu_torch: a row's child imports the
# same port whatever its working directory
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --------------------------------------------------------- dataset checks

def _exists_any(root, *cands):
    for c in cands:
        p = os.path.join(root, c)
        if os.path.exists(p):
            return p
    return None


def check_mnist(root):
    problems = []
    for prefix in ("train", "t10k"):
        found = None
        for sub in ("", "raw", "MNIST/raw"):
            base = os.path.join(root, sub)
            if _exists_any(base, f"{prefix}-images-idx3-ubyte",
                           f"{prefix}-images-idx3-ubyte.gz") and \
               _exists_any(base, f"{prefix}-labels-idx1-ubyte",
                           f"{prefix}-labels-idx1-ubyte.gz"):
                found = base
                break
        if not found:
            problems.append(
                f"missing {prefix}-images-idx3-ubyte[.gz] + labels under "
                f"{root}[/raw|/MNIST/raw] (standard MNIST idx layout)")
    return problems


def check_cifar10(root):
    base = _exists_any(root, "cifar-10-batches-py", "")
    if base is None or not os.path.isdir(base):
        return [f"missing cifar-10-batches-py/ under {root}"]
    problems = []
    for f in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        if not os.path.exists(os.path.join(base, f)):
            problems.append(f"missing {f} in {base}")
    return problems


def check_cifar20(root):
    base = _exists_any(root, "cifar-100-python", "")
    if base is None or not os.path.isdir(base):
        return [f"missing cifar-100-python/ under {root}"]
    return [f"missing {f} in {base}" for f in ("train", "test")
            if not os.path.exists(os.path.join(base, f))]


def check_stl10(root, need_unlabeled=True):
    base = _exists_any(root, "stl10_binary", "")
    if base is None or not os.path.isdir(base):
        return [f"missing stl10_binary/ under {root}"]
    need = ["train_X.bin", "train_y.bin", "test_X.bin", "test_y.bin"]
    if need_unlabeled:
        need.append("unlabeled_X.bin")
    return [f"missing {f} in {base}" for f in need
            if not os.path.exists(os.path.join(base, f))]


def check_stl10_no_unlabelled(root):
    return check_stl10(root, need_unlabeled=False)


def _check_coco164k(root, curated_list):
    problems = []
    for split in ("train2017", "val2017"):
        for sub in ("images", "annotations"):
            d = os.path.join(root, sub, split)
            if not os.path.isdir(d):
                problems.append(f"missing {sub}/{split}/ under {root}")
        lst = os.path.join(root, "curated", split, curated_list + ".txt")
        if not os.path.exists(lst):
            problems.append(
                f"missing curated/{split}/{curated_list}.txt (generate "
                f"with iic_tpu_torch.data.prepare coco164k curated lists)")
    if not (os.path.exists(os.path.join(root, "fine_to_coarse_dict.pickle"))
            or (os.path.exists(os.path.join(root, "cocostuff_fine_raw.txt"))
                and os.path.exists(
                    os.path.join(root, "cocostuff_hierarchy.yaml")))):
        problems.append(
            f"missing fine_to_coarse_dict.pickle (or cocostuff_fine_raw.txt"
            f" + cocostuff_hierarchy.yaml to regenerate) under {root}")
    return problems


def check_coco3(root):
    return _check_coco164k(root, "Coco164kFew_Stuff_6")


def check_coco15(root):
    return _check_coco164k(root, "Coco164kFull_Stuff_Coarse_7")


def check_potsdam(root):
    problems = []
    for sub in ("imgs", "gt"):
        if not os.path.isdir(os.path.join(root, sub)):
            problems.append(f"missing {sub}/ (.mat tiles) under {root} — "
                            f"prepare with iic_tpu_torch.data.prepare "
                            f"potsdam")
    for lst in ("unlabelled_train.txt", "labelled_train.txt",
                "labelled_test.txt"):
        if not os.path.exists(os.path.join(root, lst)):
            problems.append(f"missing split list {lst} under {root}")
    return problems


# ------------------------------------------------------------------- rows

@dataclasses.dataclass
class Row:
    key: str
    model_ind: int
    baseline: float
    desc: str
    module: str
    argv: str          # exact paper flags (commands.txt), sans dataset_root
    check: object      # dataset-layout validator(root) -> [problems]
    source: str        # commands.txt line of the reference invocation


ROWS = [
    Row("stl10", 569, 0.6103,
        "STL10 unsup clustering (model 569)",
        "iic_tpu_torch.cli.cluster_sobel_twohead",
        "--model_ind 569 --arch ClusterNet5gTwoHead --mode IID "
        "--dataset STL10 --gt_k 10 --output_k_A 70 --output_k_B 10 "
        "--lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 700 "
        "--num_dataloaders 5 --num_sub_heads 5 --mix_train --crop_orig "
        "--rand_crop_sz 64 --input_sz 64 --head_A_first --double_eval "
        "--batchnorm_track",
        check_stl10, "commands.txt:18"),
    Row("stl10_b", 570, 0.6183,
        "STL10 unsup clustering (model 570, head_B_epochs 2)",
        "iic_tpu_torch.cli.cluster_sobel_twohead",
        "--model_ind 570 --arch ClusterNet5gTwoHead --mode IID "
        "--dataset STL10 --gt_k 10 --output_k_A 70 --output_k_B 10 "
        "--lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 700 "
        "--num_dataloaders 5 --num_sub_heads 5 --mix_train --crop_orig "
        "--rand_crop_sz 64 --input_sz 64 --head_B_epochs 2 --double_eval "
        "--batchnorm_track",
        check_stl10, "commands.txt:21"),
    Row("cifar10", 640, 0.6172,
        "CIFAR10 unsup clustering (model 640)",
        "iic_tpu_torch.cli.cluster_sobel_twohead",
        "--model_ind 640 --arch ClusterNet5gTwoHead --mode IID "
        "--dataset CIFAR10 --gt_k 10 --output_k_A 70 --output_k_B 10 "
        "--lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 660 "
        "--num_dataloaders 3 --num_sub_heads 5 --crop_orig "
        "--rand_crop_sz 20 --input_sz 32 --head_A_first --head_B_epochs 2",
        check_cifar10, "commands.txt:24"),
    Row("cifar20", 579, 0.2574,
        "CIFAR100-20 unsup clustering (model 579)",
        "iic_tpu_torch.cli.cluster_sobel_twohead",
        "--model_ind 579 --arch ClusterNet5gTwoHead --mode IID "
        "--dataset CIFAR20 --gt_k 20 --output_k_A 140 --output_k_B 20 "
        "--lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 1000 "
        "--num_dataloaders 5 --num_sub_heads 5 --crop_orig "
        "--rand_crop_sz 20 --input_sz 32 --batchnorm_track",
        check_cifar20, "commands.txt:27"),
    Row("mnist", 685, 0.9925,
        "MNIST unsup clustering (model 685)",
        "iic_tpu_torch.cli.cluster_greyscale_twohead",
        "--model_ind 685 --arch ClusterNet6cTwoHead --mode IID "
        "--dataset MNIST --gt_k 10 --output_k_A 50 --output_k_B 10 "
        "--lamb_A 1.0 --lamb_B 1.0 --lr 0.0001 --num_epochs 3200 "
        "--batch_sz 700 --num_dataloaders 5 --num_sub_heads 5 "
        "--crop_orig --crop_other --tf1_crop centre_half "
        "--tf2_crop random --tf1_crop_sz 20 --tf2_crop_szs 16 20 24 "
        "--input_sz 24 --rot_val 25 --no_flip --head_B_epochs 2",
        check_mnist, "commands.txt:30"),
    Row("stl10_abl_noaux", 692, 0.4402,
        "STL10 ablation: no aux overclustering (model 692)",
        "iic_tpu_torch.cli.cluster_sobel_twohead",
        "--model_ind 692 --arch ClusterNet5gTwoHead --mode IID "
        "--dataset STL10 --gt_k 10 --output_k_A 10 --output_k_B 10 "
        "--lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 700 "
        "--num_dataloaders 5 --num_sub_heads 5 --mix_train --crop_orig "
        "--rand_crop_sz 64 --input_sz 64 --head_A_first --double_eval "
        "--batchnorm_track",
        check_stl10, "commands.txt:57"),
    Row("stl10_abl_1head", 693, 0.5762,
        "STL10 ablation: single sub-head (model 693)",
        "iic_tpu_torch.cli.cluster_sobel_twohead",
        "--model_ind 693 --arch ClusterNet5gTwoHead --mode IID "
        "--dataset STL10 --gt_k 10 --output_k_A 70 --output_k_B 10 "
        "--lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 700 "
        "--num_dataloaders 5 --num_sub_heads 1 --mix_train --crop_orig "
        "--rand_crop_sz 64 --input_sz 64 --head_A_first --double_eval "
        "--batchnorm_track",
        check_stl10, "commands.txt:60"),
    Row("stl10_abl_norep", 694, 0.5235,
        "STL10 ablation: no data repeats (model 694)",
        "iic_tpu_torch.cli.cluster_sobel_twohead",
        "--model_ind 694 --arch ClusterNet5gTwoHead --mode IID "
        "--dataset STL10 --gt_k 10 --output_k_A 70 --output_k_B 10 "
        "--lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 700 "
        "--num_dataloaders 1 --num_sub_heads 5 --mix_train --crop_orig "
        "--rand_crop_sz 64 --input_sz 64 --head_A_first --double_eval "
        "--batchnorm_track",
        check_stl10, "commands.txt:63"),
    Row("stl10_abl_nounlab", 695, 0.5203,
        "STL10 ablation: no unlabelled data (model 695)",
        "iic_tpu_torch.cli.cluster_sobel_twohead",
        "--model_ind 695 --arch ClusterNet5gTwoHead --mode IID "
        "--dataset STL10 --gt_k 10 --output_k_A 70 --output_k_B 10 "
        "--lamb 1.0 --lr 0.0001 --num_epochs 2000 --batch_sz 700 "
        "--num_dataloaders 5 --num_sub_heads 5 --mix_train --crop_orig "
        "--rand_crop_sz 64 --input_sz 64 --head_A_first --double_eval "
        "--batchnorm_track --stl_leave_out_unlabelled",
        check_stl10_no_unlabelled, "commands.txt:66"),
    Row("coco3", 555, 0.7228,
        "COCO-Stuff-3 unsup segmentation (model 555)",
        "iic_tpu_torch.cli.segmentation_twohead",
        "--mode IID --dataset Coco164kCuratedFew --model_ind 555 "
        "--arch SegmentationNet10aTwoHead --num_epochs 4800 --lr 0.0001 "
        "--lamb_A 1.0 --lamb_B 1.5 --num_sub_heads 1 --batch_sz 120 "
        "--num_dataloaders 1 --use_coarse_labels --output_k_A 15 "
        "--output_k_B 3 --gt_k 3 --pre_scale_all --pre_scale_factor 0.33 "
        "--input_sz 128 --half_T_side_sparse_min 0 "
        "--half_T_side_sparse_max 0 --half_T_side_dense 10 --include_rgb "
        "--coco_164k_curated_version 6 --use_uncollapsed_loss "
        "--batchnorm_track",
        check_coco3, "commands.txt:74"),
    Row("coco15", 512, 0.2767,
        "COCO-Stuff (15 coarse classes) unsup segmentation (model 512)",
        "iic_tpu_torch.cli.segmentation_twohead",
        "--mode IID --dataset Coco164kCuratedFull --model_ind 512 "
        "--arch SegmentationNet10aTwoHead --num_epochs 4800 --lr 0.0001 "
        "--lamb_A 1.0 --lamb_B 1.0 --num_sub_heads 1 --batch_sz 60 "
        "--num_dataloaders 1 --use_coarse_labels --output_k_A 45 "
        "--output_k_B 15 --gt_k 15 --pre_scale_all "
        "--pre_scale_factor 0.33 --input_sz 128 "
        "--half_T_side_sparse_min 0 --half_T_side_sparse_max 0 "
        "--half_T_side_dense 10 --include_rgb "
        "--coco_164k_curated_version 7 --use_uncollapsed_loss "
        "--batchnorm_track",
        check_coco15, "commands.txt:80"),
    Row("potsdam3", 545, 0.6509,
        "Potsdam-3 unsup segmentation (model 545)",
        "iic_tpu_torch.cli.segmentation_twohead",
        "--mode IID --dataset Potsdam --model_ind 545 "
        "--arch SegmentationNet10aTwoHead --num_epochs 4800 --lr 0.00001 "
        "--lamb_A 1.0 --lamb_B 1.5 --num_sub_heads 1 --batch_sz 75 "
        "--num_dataloaders 1 --use_coarse_labels --output_k_A 24 "
        "--output_k_B 3 --gt_k 3 --input_sz 200 "
        "--half_T_side_sparse_min 0 --half_T_side_sparse_max 0 "
        "--half_T_side_dense 10 --include_rgb --no_sobel "
        "--jitter_brightness 0.1 --jitter_contrast 0.1 "
        "--jitter_saturation 0.1 --jitter_hue 0.1 "
        "--use_uncollapsed_loss --batchnorm_track",
        check_potsdam, "commands.txt:83"),
    Row("potsdam6", 544, 0.4307,
        "Potsdam (6 classes) unsup segmentation (model 544; paper 0.454)",
        "iic_tpu_torch.cli.segmentation_twohead",
        "--mode IID --dataset Potsdam --model_ind 544 "
        "--arch SegmentationNet10aTwoHead --num_epochs 4800 "
        "--lr 0.000001 --lamb_A 1.0 --lamb_B 1.0 --num_sub_heads 1 "
        "--batch_sz 60 --num_dataloaders 1 --output_k_A 36 "
        "--output_k_B 6 --gt_k 6 --input_sz 200 "
        "--half_T_side_sparse_min 0 --half_T_side_sparse_max 0 "
        "--half_T_side_dense 5 --include_rgb --no_sobel "
        "--jitter_brightness 0.1 --jitter_contrast 0.1 "
        "--jitter_saturation 0.1 --jitter_hue 0.1 "
        "--use_uncollapsed_loss --batchnorm_track",
        check_potsdam, "commands.txt:89"),
]

ROW_MAP = {r.key: r for r in ROWS}


def _select(keys):
    if not keys or keys == ["all"]:
        return ROWS
    missing = [k for k in keys if k not in ROW_MAP]
    if missing:
        raise SystemExit(f"unknown rows {missing}; known: "
                         f"{[r.key for r in ROWS]}")
    return [ROW_MAP[k] for k in keys]


# ------------------------------------------------------- the row's child

# The program of a row's child: argv[1] the CLI module, argv[2] the device,
# the rest the CLI's flags.
CHILD_CODE = ("import sys; from iic_tpu_torch.tools.paper_parity import "
              "run_row; run_row(sys.argv[1], sys.argv[2], sys.argv[3:])")


def run_row(module, device, argv):
    """Train one row in this process: the CLI ``module``'s
    ``main(argv, device=device)``."""
    return importlib.import_module(module).main(argv, device=device)


def row_argv(row, dataset_root, out_root, extra):
    """The flags ``run`` gives ``row``'s CLI."""
    return (row.argv.split() + ["--dataset_root", dataset_root,
                                "--out_root", out_root] + list(extra))


def child_command(row, argv, device):
    """The command of the child process that trains ``row`` on ``device``
    with the CLI flags ``argv``."""
    return [sys.executable, "-c", CHILD_CODE, row.module, str(device), *argv]


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    return env


# ---------------------------------------------------------- subcommands

def cmd_list(_args):
    for r in ROWS:
        print(f"{r.key:18s} model {r.model_ind:3d}  baseline {r.baseline:.4f}"
              f"  [{r.source}]  {r.desc}")
        print(f"{'':18s} python -m {r.module} {r.argv} "
              f"--dataset_root <ROOT> --out_root <OUT>")


def cmd_check(args):
    rows = _select(args.rows)
    ok = True
    for r in rows:
        problems = r.check(args.dataset_root)
        status = "OK" if not problems else "MISSING"
        print(f"{r.key:18s} {status}")
        for p in problems:
            print(f"  - {p}")
        ok = ok and not problems
    return 0 if ok else 1


def cmd_run(args):
    from iic_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    rows = _select(args.rows)
    os.makedirs(args.out_root, exist_ok=True)
    rc = 0
    for r in rows:
        problems = r.check(args.dataset_root)
        if problems:
            print(f"{r.key}: dataset check FAILED, not running:")
            for p in problems:
                print(f"  - {p}")
            rc = 1
            continue
        argv = row_argv(r, args.dataset_root, args.out_root, args.extra)
        log_path = os.path.join(args.out_root, f"{r.model_ind}.out")
        print(f"{r.key}: launching model {r.model_ind} on {device} "
              f"(log: {log_path})")
        print(f"  {r.module}.main(argv, device={str(device)!r}) in a child "
              f"process, argv: " + " ".join(argv), flush=True)
        with open(log_path, "a") as log:
            proc = subprocess.run(child_command(r, argv, device),
                                  stdout=log, stderr=subprocess.STDOUT,
                                  env=_child_env())
        if proc.returncode != 0:
            print(f"{r.key}: FAILED rc={proc.returncode} "
                  f"(tail of {log_path}):")
            with open(log_path) as log:
                print("".join(log.readlines()[-20:]))
            rc = 1
        else:
            print(f"{r.key}: done")
    return rc


def cmd_report(args):
    from iic_tpu_torch.train.checkpoint import read_meta

    rows = _select(args.rows)
    print(f"{'row':18s} {'model':>5s} {'baseline':>9s} {'ours':>9s} "
          f"{'delta':>8s}  {'epochs':>6s}  verdict")
    for r in rows:
        d = os.path.join(args.out_root, str(r.model_ind))
        if not os.path.exists(os.path.join(d, "config.pickle")):
            print(f"{r.key:18s} {r.model_ind:5d} {r.baseline:9.4f} "
                  f"{'—':>9s} {'—':>8s}  {'—':>6s}  no run at {d}")
            continue
        meta = read_meta(args.out_root, r.model_ind)
        accs = [float(a) for a in meta["history"]["eval"].epoch_acc]
        best = max(accs) if accs else float("nan")
        delta = best - r.baseline
        verdict = ("PARITY (within 1 pt)" if abs(delta) <= 0.01
                   else ("ABOVE baseline" if delta > 0 else "BELOW baseline"))
        print(f"{r.key:18s} {r.model_ind:5d} {r.baseline:9.4f} {best:9.4f} "
              f"{delta:+8.4f}  {len(accs) - 1:6d}  {verdict}")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list")
    p_list.set_defaults(fn=cmd_list)
    for name, fn, needs_ds in (("check", cmd_check, True),
                               ("run", cmd_run, True),
                               ("report", cmd_report, False)):
        p = sub.add_parser(name)
        p.add_argument("--rows", nargs="+", default=["all"],
                       help="row keys (see `list`), default all")
        if needs_ds:
            p.add_argument("--dataset_root", required=True)
        if name != "check":
            p.add_argument("--out_root", required=True)
        if name == "run":
            p.add_argument("--device", default=None,
                           help="the device the rows train on (default "
                                "cuda:0; no GPU is an error)")
        p.set_defaults(fn=fn)
    args = parser.parse_args(argv)
    args.extra = extra
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
