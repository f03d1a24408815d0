"""The port's analysis tools (``iic_tpu_torch/cli/analysis``) and
``utils/render.py``, each test the counterpart of one in
tests/test_analysis.py, on runs the port's CLIs train on the CPU (a tiny
net6c clustering run with ``--save_progression`` and a tiny net10a
segmentation run), and against the JAX tools where both can read the same
thing: print_stats' and update_config's output on the same history, the
rows a truncated mapping loader keeps for a seed, print_nets' parameter
count, the PNGs of ``render`` and ``save_progress`` for the same inputs
(pixel for pixel), colour_scheme_change's PNGs and count_classes' counts.
Re-evaluations are held to the stored accuracy of the weights they load,
exactly (the CPU is deterministic here)."""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_infer import write_runs

PIL = pytest.importorskip("PIL.Image")

GREY_ARGV = [
    "--model_ind", "31", "--arch", "ClusterNet6cTwoHead", "--mode", "IID",
    "--dataset", "Synthetic10x28x1x128", "--dataset_root", "", "--gt_k",
    "10", "--output_k_A", "20", "--output_k_B", "10", "--lr", "1e-3",
    "--num_epochs", "2", "--batch_sz", "32", "--num_dataloaders", "2",
    "--num_sub_heads", "2", "--crop_orig", "--crop_other", "--tf1_crop",
    "centre_half", "--tf1_crop_sz", "20", "--tf2_crop", "random",
    "--tf2_crop_szs", "16", "20", "24", "--input_sz", "24", "--rot_val",
    "25.0", "--no_flip", "--batchnorm_track", "--test_code",
    "--save_freq", "1", "--save_progression"]
SEG_ARGV = [
    "--model_ind", "41", "--arch", "SegmentationNet10aTwoHead", "--mode",
    "IID", "--dataset", "SyntheticSeg3x48x16", "--dataset_root", "",
    "--gt_k", "3", "--output_k_A", "6", "--output_k_B", "3",
    "--num_sub_heads", "2", "--lr", "1e-3", "--num_epochs", "2",
    "--batch_sz", "4", "--num_dataloaders", "1", "--input_sz", "40",
    "--half_T_side_dense", "1", "--half_T_side_sparse_min", "0",
    "--half_T_side_sparse_max", "0", "--include_rgb", "--batchnorm_track",
    "--test_code", "--save_freq", "1"]


@pytest.fixture(scope="module")
def stored_run(tmp_path_factory):
    """A tiny two-head greyscale run, with the progression plots on."""
    from iic_tpu_torch.cli import cluster_greyscale_twohead

    tmp = str(tmp_path_factory.mktemp("runs"))
    cluster_greyscale_twohead.main(GREY_ARGV + ["--out_root", tmp],
                                   device="cpu")
    return tmp, 31


@pytest.fixture(scope="module")
def stored_seg_run(tmp_path_factory):
    """A tiny two-head segmentation run."""
    from iic_tpu_torch.cli import segmentation_twohead

    tmp = str(tmp_path_factory.mktemp("seg_runs"))
    segmentation_twohead.main(SEG_ARGV + ["--out_root", tmp], device="cpu")
    return tmp, 41


def _stored_acc(out_root, model_ind):
    """The stored accuracy of the weights the tools reload (best, else
    latest)."""
    from iic_tpu_torch.train import checkpoint as ckpt
    meta = ckpt.read_meta(out_root, model_ind)
    ev = meta["history"]["eval"]
    if os.path.exists(os.path.join(out_root, str(model_ind),
                                   "best.pytorch")):
        return ev.epoch_acc[int(np.argmax(ev.epoch_acc))]
    return ev.epoch_acc[meta["last_epoch"]]


def test_analysis_eval_reload(stored_run):
    from iic_tpu_torch.cli.analysis.eval import main

    out_root, model_ind = stored_run
    stats = main(["--model_ind", str(model_ind), "--out_root", out_root],
                 device="cpu")
    assert len(stats["test_accs"]) == 2
    assert stats["best"] == _stored_acc(out_root, model_ind)


def test_analysis_needs_a_gpu_without_a_device(stored_run):
    from iic_tpu_torch.cli.analysis.eval import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out_root, model_ind = stored_run
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["--model_ind", str(model_ind), "--out_root", out_root])


def _both_runs(tmp_path):
    """The same fake run in both packages (tests/test_torch_infer.py),
    with double-eval entries added to both histories."""
    jroot, troot = write_runs(tmp_path, "cluster_grey")
    for root in (jroot, troot):
        path = os.path.join(root, "7", "config.pickle")
        with open(path, "rb") as f:
            meta = pickle.load(f)
        meta["history"]["eval"].double_eval_acc = [0.25, 0.7, 0.4]
        with open(path, "wb") as f:
            pickle.dump(meta, f)
    return jroot, troot


def test_analysis_print_stats_equal_jax(tmp_path, capsys):
    from iic_tpu.cli.analysis import print_stats as jax_print_stats
    from iic_tpu_torch.cli.analysis.print_stats import main

    jroot, troot = _both_runs(tmp_path)
    jax_print_stats.main(["--model_inds", "7", "--out_root", jroot])
    want = capsys.readouterr().out
    main(["--model_inds", "7", "--out_root", troot])
    got = capsys.readouterr().out
    assert got == want
    assert "model 7: epochs 3 best acc 0.600000 (epoch 1)" in got
    assert "double eval best: 0.700000" in got


def test_analysis_update_config(tmp_path, capsys):
    from iic_tpu.cli.analysis import update_config as jax_update_config
    from iic_tpu_torch.cli.analysis.update_config import main

    jroot, troot = write_runs(tmp_path, "cluster_grey")
    outs = []
    for mod, root in ((jax_update_config, jroot), (None, troot)):
        (mod.main if mod else main)([
            "--model_ind", "7", "--out_root", root, "--field", "lamb",
            "--value", "1.5"])
        outs.append(capsys.readouterr().out)
        with open(os.path.join(root, "7", "config.pickle"), "rb") as f:
            assert pickle.load(f)["config"]["lamb"] == 1.5
    assert outs[0] == outs[1] == "model 7: lamb: 1.0 -> 1.5\n"


@pytest.mark.parametrize("pc,seed", [(0.5, 0), (0.1, 3), (1.0, 1)])
def test_truncated_rows_equal_jax(pc, seed):
    """The port's MappingLoader keeps the rows the JAX one keeps."""
    from iic_tpu.data.pipeline import MappingLoader as JaxMappingLoader
    from iic_tpu.train.config import ClusterConfig as JaxClusterConfig
    from iic_tpu_torch.data.pipeline import MappingLoader
    from iic_tpu_torch.train.config import ClusterConfig

    kw = dict(dataset="Synthetic10x28x1x128", gt_k=10, crop_orig=True,
              tf1_crop_sz=20, input_sz=24, batch_sz=32)
    jcfg = JaxClusterConfig(**kw).finalize(twohead=True, sobel=False)
    tcfg = ClusterConfig(**kw).finalize(twohead=True, sobel=False)
    parts = [True, False]
    want = JaxMappingLoader(jcfg, parts, truncate_pc=pc, truncate_seed=seed)
    got = MappingLoader(tcfg, parts, truncate_pc=pc, truncate_seed=seed)
    assert len(got.images) == int((128 + 40) * pc)  # train + test
    np.testing.assert_array_equal(got.images, np.asarray(want.images))
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))


def test_overcluster_fewer_labels(stored_run):
    """Results keyed str(pc) -> (num_imgs, acc), stored into the run's
    config as assign_set_szs_pc_acc; --rewrite resets; --use_eval runs
    eval-mode BN; --dont_save leaves the stored dict as it was."""
    from iic_tpu_torch.cli.analysis.overcluster_fewer_labels_example import (
        main)

    out_root, model_ind = stored_run
    base = ["--model_ind", str(model_ind), "--out_root", out_root]
    results = main(base + ["--new_assign_set_szs_pc", "1.0", "0.5"],
                   device="cpu")
    assert set(results) == {"1.0", "0.5"}
    assert results["0.5"][0] == results["1.0"][0] // 2
    assert all(0.0 <= acc <= 1.0 for _, acc in results.values())
    p = os.path.join(out_root, str(model_ind), "config.pickle")
    with open(p, "rb") as f:
        assert set(pickle.load(f)["config"]["assign_set_szs_pc_acc"]) == {
            "1.0", "0.5"}
    main(base + ["--new_assign_set_szs_pc", "0.25", "--rewrite",
                 "--use_eval"], device="cpu")
    main(base + ["--new_assign_set_szs_pc", "0.75", "--dont_save"],
         device="cpu")
    with open(p, "rb") as f:
        assert set(pickle.load(f)["config"]["assign_set_szs_pc_acc"]) == {
            "0.25"}


def test_print_nets_total_equal_jax(capsys):
    from iic_tpu.cli.analysis import print_nets as jax_print_nets
    from iic_tpu_torch.cli.analysis.print_nets import main

    argv = ["--arch", "ClusterNet6cTwoHead", "--input_sz", "24",
            "--in_channels", "1", "--output_k_A", "20", "--output_k_B",
            "10", "--num_sub_heads", "2"]
    want = jax_print_nets.main(argv)
    capsys.readouterr()
    got = main(argv, device="cpu")
    out = capsys.readouterr().out
    assert got == want > 1_000_000
    assert f"total params: {want:,}" in out
    assert "trunk.features.0.weight: (64, 1, 5, 5) (1600)" in out


def _pngs(d):
    return {name: np.asarray(PIL.open(os.path.join(d, name)))
            for name in sorted(os.listdir(d))}


def _same_dirs(a, b):
    pa, pb = _pngs(a), _pngs(b)
    assert list(pa) == list(pb) and pa
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


def test_render_pngs_equal_jax(tmp_path):
    """Every mode of ``render`` on the same inputs: the same files, the
    same pixels (and the port also takes tensors)."""
    from iic_tpu.utils.render import render as jax_render
    from iic_tpu_torch.utils.render import render

    rng = np.random.default_rng(0)
    cases = [
        (rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32), "image"),
        (rng.uniform(0, 1, (4, 16, 16)).astype(np.float32), "image_ir"),
        (rng.normal(0, 1, (3, 8, 8)).astype(np.float32), "image_as_feat"),
        (rng.integers(0, 4, (2, 16, 16)), "preds"),
        (rng.integers(-1, 5, (2, 16, 16)), "label"),
        (rng.integers(0, 2, (16, 16)), "mask"),
        (rng.normal(0, 1, (2, 3)), "matrix")]
    for data, mode in cases:
        jax_render(data, mode=mode, name=mode, out_dir=str(tmp_path / "j"))
        render(torch.from_numpy(np.asarray(data)), mode=mode, name=mode,
               out_dir=str(tmp_path / "t"))
    assert sorted(os.listdir(tmp_path / "j")) == sorted(
        os.listdir(tmp_path / "t"))
    for name in os.listdir(tmp_path / "j"):
        if name.endswith(".txt"):
            assert (tmp_path / "j" / name).read_text() == (
                tmp_path / "t" / name).read_text()
        else:
            np.testing.assert_array_equal(
                np.asarray(PIL.open(tmp_path / "j" / name)),
                np.asarray(PIL.open(tmp_path / "t" / name)))


def test_save_progress_png_equal_jax(tmp_path):
    """The MNIST progression point cloud for the same soft predictions
    and images: pixel for pixel the JAX tool's (the match comes from the
    same Hungarian eval in each package)."""
    from iic_tpu.utils.render import save_progress as jax_save_progress
    from iic_tpu_torch.utils.render import save_progress

    rng = np.random.default_rng(1)
    proj = rng.normal(0, 3, (2, 28 * 28, 10))
    batches = [(rng.uniform(0, 1, (24, 1, 28, 28)).astype(np.float32),
                rng.integers(0, 10, 24).astype(np.int32)) for _ in range(3)]

    def soft(imgs):
        z = np.einsum("bp,spk->sbk", imgs.reshape(len(imgs), -1), proj)
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    cfg = SimpleNamespace(gt_k=10, output_k=10, num_sub_heads=2,
                          eval_mode="hung", model_ind=5, out_root="")
    jdir = jax_save_progress(
        cfg, lambda x: jnp.asarray(soft(np.asarray(x))), batches, batches,
        index=3, out_dir=str(tmp_path / "j"))
    tb = [(torch.from_numpy(i), torch.from_numpy(t)) for i, t in batches]
    tdir = save_progress(
        cfg, lambda x: torch.from_numpy(soft(x.numpy())), tb, tb, index=3,
        out_dir=str(tmp_path / "t"))
    _same_dirs(jdir, tdir)
    assert list(_pngs(tdir)) == ["5_run_50_colour_0_pointcloud_3.png"]


def test_save_progression_in_the_trainer(stored_run):
    """--save_progression draws the epoch's point cloud (the reference's
    file name, a 148 x 148 canvas) in the two-head trainer."""
    out_root, model_ind = stored_run
    path = os.path.join(out_root, str(model_ind), "progression",
                        f"{model_ind}_run_50_colour_0_pointcloud_1.png")
    assert PIL.open(path).size == (148, 148)


def test_print_sub_heads_eval(stored_run, capsys):
    from iic_tpu_torch.cli.analysis.print_sub_heads_eval import main

    out_root, model_ind = stored_run
    results = main(["--model_inds", str(model_ind), "--out_root", out_root],
                   device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"model {model_ind}:"
    assert out[1].startswith("best sub_head by loss: ")
    assert out[2].startswith("best sub_head by eval: ")
    assert out[3].startswith("... loss select acc: ")
    assert set(results[model_ind]) == {"loss_select_acc",
                                       "eval_select_acc"}


def test_print_examples(stored_run):
    from iic_tpu_torch.cli.analysis.print_examples import main

    out_root, model_ind = stored_run
    main(["--model_ind", str(model_ind), "--out_root", out_root,
          "--num_imgs", "3"], device="cpu")
    d = os.path.join(out_root, str(model_ind), "examples")
    assert os.path.exists(os.path.join(d, "example_2.png"))
    with open(os.path.join(d, "preds.txt")) as f:
        assert len(f.read().splitlines()) == 3


def test_render_general_reference_surface(stored_seg_run, capsys):
    """--get_match_only and --reassess_acc render nothing (the latter
    gives the stored accuracy back); a full render covers both
    dataloaders with the best sub-head's reordered predictions."""
    from iic_tpu_torch.cli.analysis.render_general import main

    out_root, model_ind = stored_seg_run
    base = ["--out_root", out_root]
    main(base + ["--model_inds", str(model_ind), "--get_match_only"],
         device="cpu")
    out = capsys.readouterr().out
    assert "best sub-head" in out and "match" in out
    assert not os.path.exists(os.path.join(out_root, str(model_ind),
                                           "renders"))
    stats = main(base + ["--model_ind", str(model_ind), "--reassess_acc"],
                 device="cpu")
    assert stats[model_ind]["best"] == _stored_acc(out_root, model_ind)
    assert "reassessed acc" in capsys.readouterr().out
    main(base + ["--model_inds", str(model_ind), "--net_name", "latest",
                 "--num", "2", "--imgs_dataloaders", "test", "train"],
         device="cpu")
    for dl in ("test", "train"):
        d = os.path.join(out_root, str(model_ind), "renders", dl, "latest")
        # labels (b, h, w) render as one image, as in the JAX tool
        for name in ("preds_0.png", "img_1.png", "label.png",
                     "mask_1.png"):
            assert os.path.exists(os.path.join(d, name)), (d, name)


def test_render_best_match_override(stored_seg_run):
    from iic_tpu_torch.cli.analysis.render_general import main

    out_root, model_ind = stored_seg_run
    results = main(["--model_ind", str(model_ind), "--out_root", out_root,
                    "--best_match", "2", "0", "1", "--num", "1",
                    "--net_name", "latest", "--imgs_dataloaders", "test"],
                   device="cpu")
    assert results[model_ind]["best_train_sub_head_match"] == [
        (0, 2), (1, 0), (2, 1)]
    assert os.path.exists(os.path.join(out_root, str(model_ind), "renders",
                                       "test", "latest", "preds_0.png"))


def test_render_potsdam_is_render_general():
    from iic_tpu_torch.cli.analysis import render_general, render_potsdam

    assert render_potsdam.main is render_general.main


def test_clone_and_eval_clones_old_run(stored_seg_run):
    from iic_tpu_torch.cli.analysis.clone_and_eval import main

    out_root, model_ind = stored_seg_run
    stats = main(["--model_ind", "42", "--old_model_ind", str(model_ind),
                  "--out_root", out_root], device="cpu")
    assert stats["best"] == _stored_acc(out_root, model_ind)
    new_dir = os.path.join(out_root, "42")
    assert os.path.exists(os.path.join(new_dir, "latest.pytorch"))
    with open(os.path.join(new_dir, "config.pickle"), "rb") as f:
        assert pickle.load(f)["config"]["model_ind"] == 42


def test_count_classes_equal_jax(stored_seg_run, capsys):
    """Both modes: the stored run's dataset (--model_inds) and the
    segmentation flags, the latter against the JAX tool's counts and
    output."""
    from iic_tpu.cli.analysis import count_classes as jax_count_classes
    from iic_tpu_torch.cli.analysis.count_classes import main

    out_root, model_ind = stored_seg_run
    counts = main(["--model_inds", str(model_ind), "--out_root", out_root],
                  device="cpu")
    assert f"model {model_ind}" in capsys.readouterr().out
    assert counts.sum() > 0 and len(counts) == 3
    flags = [a for a in SEG_ARGV if a not in ("--test_code",)]
    want = jax_count_classes.main(flags)
    jout = capsys.readouterr().out
    got = main(flags, device="cpu")
    assert capsys.readouterr().out == jout
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, counts)


def test_colour_scheme_change_equal_jax(stored_seg_run, tmp_path):
    """--file_pattern / --file_indices / --out_subdir and --out_dir modes:
    the JAX tool's PNGs."""
    import shutil

    from iic_tpu.cli.analysis import colour_scheme_change as jax_colour
    from iic_tpu_torch.cli.analysis.colour_scheme_change import main
    from iic_tpu_torch.cli.analysis.render_general import main as render

    out_root, model_ind = stored_seg_run
    in_dir = os.path.join(out_root, str(model_ind), "renders", "test",
                          "best")
    render(["--model_ind", str(model_ind), "--out_root", out_root, "--num",
            "2"], device="cpu")
    for tag, mod in (("j", jax_colour), ("t", None)):
        d = tmp_path / tag
        shutil.copytree(in_dir, d)
        (mod.main if mod else main)([
            "--in_dir", str(d), "--file_pattern", "preds_%d.png",
            "--file_indices", "0", "1", "--num_classes", "3"])
        (mod.main if mod else main)([
            "--in_dir", str(d), "--out_dir", str(d / "all"),
            "--num_classes", "3", "--rotate", "2"])
    for sub in ("colour_change", "all"):
        _same_dirs(tmp_path / "j" / sub, tmp_path / "t" / sub)
    assert sorted(os.listdir(tmp_path / "t" / "colour_change")) == [
        "preds_0.png", "preds_1.png"]
