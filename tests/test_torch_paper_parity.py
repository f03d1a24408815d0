"""The port's BASELINE.md parity harness
(``iic_tpu_torch/tools/paper_parity.py``) against the JAX package's
(``tools/paper_parity.py``), on the CPU: the same 13 rows letter for
letter, each row's command parsed into the same config by both packages'
argument parsers, the same dataset-check problems on fixture trees of
every format and on partial and empty roots, the same ``list`` and
``report`` lines (module names aside), and ``run --device cpu`` end to
end on the MNIST, COCO-Stuff-3 and Potsdam-3 fixture trees, each row in a
child process. The JAX harness imports no JAX and is imported by file
path (``tools/`` is not a package)."""

import dataclasses
import os
import shutil
import sys

import pytest

from iic_tpu.cli._args import parse_cluster_args as jax_parse_cluster
from iic_tpu.cli._args import parse_seg_args as jax_parse_seg
from iic_tpu.evals.cluster_eval import EvalHistory as JaxEvalHistory
from iic_tpu.train import checkpoint as jax_ckpt
from iic_tpu.train.config import ClusterConfig as JaxClusterConfig
from iic_tpu_torch.cli._args import parse_cluster_args, parse_seg_args
from iic_tpu_torch.evals.cluster_eval import EvalHistory
from iic_tpu_torch.tools import paper_parity as tpp
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import ClusterConfig

from test_lazy_readers import _make_mnist, _make_stl10
from test_paper_parity_run import (
    RUN_ROWS, _make_cifar10, _make_cifar20, _make_coco164k_curated,
    _make_potsdam)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import paper_parity as jpp  # noqa: E402

ROW_KEYS = [r.key for r in jpp.ROWS]
# the rows run end to end here, with test_paper_parity_run.py's overrides
CPU_RUN_ROWS = ("mnist", "coco3", "potsdam3")


def _port_text(text):
    """JAX's text with the port's module names."""
    return text.replace("iic_tpu.", "iic_tpu_torch.")


def test_rows_equal_jax_rows():
    assert [r.key for r in tpp.ROWS] == ROW_KEYS
    assert list(tpp.ROW_MAP) == list(jpp.ROW_MAP)
    for t, j in zip(tpp.ROWS, jpp.ROWS):
        assert (t.key, t.model_ind, t.baseline, t.desc, t.argv, t.source) \
            == (j.key, j.model_ind, j.baseline, j.desc, j.argv, j.source)
        assert t.module == _port_text(j.module)
        assert t.check.__name__ == j.check.__name__
    assert tpp._select(["all"]) == tpp.ROWS
    assert [r.key for r in tpp._select(["mnist", "coco3"])] == \
        ["mnist", "coco3"]
    with pytest.raises(SystemExit, match="unknown rows"):
        tpp._select(["mnist", "nope"])


@pytest.mark.parametrize("key", ROW_KEYS)
def test_row_argv_parses_into_jax_config(key):
    """Both packages' parsers on the row's argv, then the finalize of the
    row's script: the same config, field for field."""
    row = tpp.ROW_MAP[key]
    argv = row.argv.split() + ["--dataset_root", "/data",
                               "--out_root", "/out"]
    if "segmentation" in row.module:
        got = parse_seg_args(argv).finalize(twohead=True)
        want = jax_parse_seg(argv).finalize(twohead=True)
    else:
        sobel = "sobel" in row.module
        got = parse_cluster_args(argv).finalize(twohead=True, sobel=sobel)
        want = jax_parse_cluster(argv).finalize(twohead=True, sobel=sobel)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model_ind == row.model_ind


def _roots(base):
    """{name: dataset root}: every format's fixture tree in one root, each
    format alone, partial trees of each, and an empty root."""
    roots = {}

    def new(name):
        roots[name] = os.path.join(base, name)
        os.makedirs(roots[name])
        return roots[name]

    full = new("full")
    _make_mnist(full, n_train=6, n_test=4)
    _make_stl10(full, n_train=4, n_test=4, n_unlab=4)
    _make_cifar10(full, n_per_batch=2, n_test=2)
    _make_cifar20(full, n_train=4, n_test=2)
    _make_coco164k_curated(full, n_train=2, n_val=2, sz=16)
    for split in ("train2017", "val2017"):  # coco15's list beside coco3's
        lists = os.path.join(full, "curated", split)
        shutil.copy(os.path.join(lists, "Coco164kFew_Stuff_6.txt"),
                    os.path.join(lists, "Coco164kFull_Stuff_Coarse_7.txt"))
    _make_potsdam(full, n_unlab=1, n_lab_train=1, n_lab_test=1)
    # each format alone, in the other layouts the checks accept
    _make_mnist(os.path.join(new("mnist_raw"), "raw"), n_train=6, n_test=4)
    _make_mnist(os.path.join(new("mnist_nested"), "MNIST", "raw"),
                n_train=6, n_test=4)
    flat = new("flat")  # cifar and stl10 files directly under the root
    for name in ("cifar-10-batches-py", "stl10_binary"):
        src = os.path.join(full, name)
        for f in os.listdir(src):
            shutil.copy(os.path.join(src, f), flat)
    # partial trees: one piece of each format missing
    part = new("partial")
    _make_mnist(os.path.join(part, "raw"), n_train=6, n_test=4)
    for f in ("t10k-labels-idx1-ubyte",):
        os.remove(os.path.join(part, "raw", f))
    _make_stl10(part, n_train=4, n_test=4, n_unlab=4)
    for f in ("unlabeled_X.bin", "test_y.bin"):
        os.remove(os.path.join(part, "stl10_binary", f))
    _make_cifar10(part, n_per_batch=2, n_test=2)
    for f in ("data_batch_3", "test_batch"):
        os.remove(os.path.join(part, "cifar-10-batches-py", f))
    _make_cifar20(part, n_train=4, n_test=2)
    os.remove(os.path.join(part, "cifar-100-python", "test"))
    _make_coco164k_curated(part, n_train=2, n_val=2, sz=16)
    shutil.rmtree(os.path.join(part, "annotations", "val2017"))
    os.remove(os.path.join(part, "curated", "train2017",
                           "Coco164kFew_Stuff_6.txt"))
    os.remove(os.path.join(part, "fine_to_coarse_dict.pickle"))
    open(os.path.join(part, "cocostuff_fine_raw.txt"), "w").close()
    _make_potsdam(part, n_unlab=1, n_lab_train=1, n_lab_test=1)
    shutil.rmtree(os.path.join(part, "gt"))
    os.remove(os.path.join(part, "labelled_test.txt"))
    # COCO's regeneration sources in place of the pickle
    coco_src = new("coco_sources")
    _make_coco164k_curated(coco_src, n_train=2, n_val=2, sz=16)
    os.remove(os.path.join(coco_src, "fine_to_coarse_dict.pickle"))
    for f in ("cocostuff_fine_raw.txt", "cocostuff_hierarchy.yaml"):
        open(os.path.join(coco_src, f), "w").close()
    new("empty")
    roots["absent"] = os.path.join(base, "absent")
    return roots


def test_checks_give_jax_problems(tmp_path):
    pytest.importorskip("cv2")  # the COCO fixture writer
    roots = _roots(str(tmp_path))
    for name, root in roots.items():
        for t, j in zip(tpp.ROWS, jpp.ROWS):
            assert t.check(root) == [_port_text(p) for p in j.check(root)], \
                (name, t.key)
    # the trees exercise both outcomes of every check
    full = {r.key: r.check(roots["full"]) for r in tpp.ROWS}
    assert not any(full.values()), full
    assert all(r.check(roots["partial"]) for r in tpp.ROWS)
    assert not tpp.check_coco3(roots["coco_sources"])
    assert any("iic_tpu_torch.data.prepare" in p
               for p in tpp.check_potsdam(roots["empty"]))
    assert tpp.check_mnist(roots["mnist_nested"]) == []
    assert tpp.check_cifar10(roots["flat"]) == []


def _cmd(module, argv, capsys):
    capsys.readouterr()
    rc = module.main(argv)
    return rc, capsys.readouterr().out


def test_list_and_check_print_jax_lines(tmp_path, capsys):
    rc_t, out_t = _cmd(tpp, ["list"], capsys)
    rc_j, out_j = _cmd(jpp, ["list"], capsys)
    assert rc_t == rc_j == 0
    assert out_t.splitlines() == _port_text(out_j).splitlines()
    assert len(out_t.splitlines()) == 2 * len(tpp.ROWS)
    _make_mnist(str(tmp_path), n_train=6, n_test=4)
    for rows in (["mnist"], ["mnist", "potsdam3"], ["all"]):
        argv = ["check", "--dataset_root", str(tmp_path), "--rows", *rows]
        rc_t, out_t = _cmd(tpp, argv, capsys)
        rc_j, out_j = _cmd(jpp, argv, capsys)
        assert (rc_t, out_t) == (rc_j, _port_text(out_j))
        assert rc_t == (0 if rows == ["mnist"] else 1)


# (row key, eval accuracies): below, at and above the baseline, one
# epoch's list empty
REPORT_ACCS = {"mnist": [0.1, 0.5, 0.6], "cifar10": [0.2, 0.612, 0.62],
               "potsdam3": [0.3, 0.7], "coco3": [0.1, 0.72],
               "stl10": []}


def test_report_prints_jax_table(tmp_path, capsys):
    """Run dirs with the same accuracies, written by the port's
    ``save_meta`` and by JAX's, give the same table (the roots aside);
    rows without a run say so."""
    troot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    for key, accs in REPORT_ACCS.items():
        model_ind = tpp.ROW_MAP[key].model_ind
        ckpt.save_meta(ClusterConfig(model_ind=model_ind, out_root=troot),
                       {"eval": EvalHistory(epoch_acc=list(accs))}, 1)
        jax_ckpt.save_meta(
            JaxClusterConfig(model_ind=model_ind, out_root=jroot),
            {"eval": JaxEvalHistory(epoch_acc=list(accs))}, 1)
    rc_t, out_t = _cmd(tpp, ["report", "--out_root", troot], capsys)
    rc_j, out_j = _cmd(jpp, ["report", "--out_root", jroot], capsys)
    assert rc_t == rc_j == 0
    assert out_t.replace(troot, "ROOT") == out_j.replace(jroot, "ROOT")
    lines = {ln.split()[0]: ln for ln in out_t.splitlines()[1:]}
    assert "BELOW baseline" in lines["mnist"]
    assert "PARITY" in lines["cifar10"] and "PARITY" in lines["coco3"]
    assert "ABOVE baseline" in lines["potsdam3"]
    assert "nan" in lines["stl10"]
    assert "no run at" in lines["coco15"]


def test_run_end_to_end_on_cpu(tmp_path, capsys):
    """``run --device cpu`` of the MNIST, COCO-Stuff-3 and Potsdam-3 rows
    on fixture trees, each in a child process: rc 0, the trainer's output
    in <out_root>/<model_ind>.out, the run's config.pickle, then a report
    with a parsed accuracy for each."""
    pytest.importorskip("cv2")  # the COCO reader
    data_root, out_root = tmp_path / "data", tmp_path / "out"
    _make_mnist(str(data_root), n_train=60, n_test=20)
    _make_coco164k_curated(str(data_root))
    _make_potsdam(str(data_root))
    overrides = dict(RUN_ROWS)
    for key in CPU_RUN_ROWS:
        row = tpp.ROW_MAP[key]
        rc, out = _cmd(tpp, [
            "run", "--dataset_root", str(data_root), "--out_root",
            str(out_root), "--rows", key, "--device", "cpu", "--",
            "--test_code", "--num_epochs", "2", *overrides[key]], capsys)
        log = out_root / f"{row.model_ind}.out"
        assert rc == 0, out + (log.read_text()[-3000:] if log.exists()
                               else "<no log>")
        assert f"{key}: done" in out and "on cpu" in out
        assert log.stat().st_size > 0
        assert "device: cpu" in log.read_text()
        assert (out_root / str(row.model_ind) / "config.pickle").exists()
    rc, out = _cmd(tpp, ["report", "--out_root", str(out_root), "--rows",
                         *CPU_RUN_ROWS], capsys)
    assert rc == 0 and "no run at" not in out
    for key in CPU_RUN_ROWS:
        (line,) = [ln for ln in out.splitlines() if ln.startswith(key + " ")]
        assert 0.0 <= float(line.split()[3]) <= 1.0


def test_run_refuses_missing_dataset(tmp_path, capsys):
    """An empty root: every row refused, rc 1, no run dir, no child."""
    data_root, out_root = tmp_path / "empty", tmp_path / "out"
    data_root.mkdir()
    rc, out = _cmd(tpp, ["run", "--dataset_root", str(data_root),
                         "--out_root", str(out_root), "--rows", "mnist",
                         "coco3", "--device", "cpu"], capsys)
    assert rc == 1
    assert out.count("dataset check FAILED") == 2
    assert os.listdir(out_root) == []


def test_failed_row_returns_1(tmp_path, capsys):
    """A child that fails: rc 1, FAILED with its rc and the log's tail."""
    data_root, out_root = tmp_path / "data", tmp_path / "out"
    _make_mnist(str(data_root), n_train=6, n_test=4)
    rc, out = _cmd(tpp, ["run", "--dataset_root", str(data_root),
                         "--out_root", str(out_root), "--rows", "mnist",
                         "--device", "cpu", "--", "--no_such_flag"], capsys)
    assert rc == 1
    assert "mnist: FAILED rc=2" in out
    assert "unrecognized arguments: --no_such_flag" in out


def test_run_without_gpu_raises(tmp_path, monkeypatch):
    """No --device and no GPU: an error, not the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found no GPU"):
        tpp.main(["run", "--dataset_root", str(tmp_path), "--out_root",
                  str(tmp_path / "out"), "--rows", "mnist"])
    assert not (tmp_path / "out").exists()


def test_child_command_hands_over_the_device():
    row = tpp.ROW_MAP["mnist"]
    argv = tpp.row_argv(row, "/data", "/out", ["--test_code"])
    assert argv == row.argv.split() + ["--dataset_root", "/data",
                                       "--out_root", "/out", "--test_code"]
    cmd = tpp.child_command(row, argv, "cuda:0")
    assert cmd[:2] == [sys.executable, "-c"]
    assert cmd[3:5] == [row.module, "cuda:0"] and cmd[5:] == argv
