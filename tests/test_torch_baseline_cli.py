"""The four baseline CLIs on the CPU at small sizes: triplets (sobel and
greyscale, with --kmeans_on_features and --restart), Doersch and Isola
(with --per_sample_patches, --verbose, --max_num_kmeans_samples,
--restart and --save_multiple); the flags the port still lacks, refused by
name; the IIC trainers still refusing the baselines' flags; and cuda:0 as
the default device."""

import pickle
import shutil

import numpy as np
import pytest
import torch

from iic_tpu_torch.cli import doersch, isola, triplets_greyscale
from iic_tpu_torch.cli import triplets_sobel


@pytest.fixture(autouse=True)
def _drop_run_dirs(request):
    """Removes a test's temporary directory (its CLI runs' directories,
    each a checkpoint or more) once the test is done: pytest keeps the
    temporary directories of its last runs."""
    root = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if root is not None:
        shutil.rmtree(root, ignore_errors=True)


TRIPLETS_CLI = ["--dataset", "Synthetic10x32x3x16", "--gt_k", "10",
                "--lr", "0.0001", "--num_epochs", "3", "--batch_sz", "12",
                "--num_dataloaders", "3", "--crop_orig", "--rand_crop_sz",
                "20", "--input_sz", "32", "--test_code", "--save_freq", "1"]
GREY_CLI = ["--dataset", "Synthetic10x24x1x16", "--gt_k", "10",
            "--batch_sz", "10", "--num_dataloaders", "2", "--input_sz",
            "24", "--num_epochs", "2", "--crop_orig", "--crop_other",
            "--tf1_crop", "centre_half", "--tf2_crop", "random",
            "--tf1_crop_sz", "20", "--tf2_crop_szs", "16", "20", "24",
            "--test_code"]
SEG_CLI = ["--mode", "IID", "--dataset", "SyntheticSeg3x40x8", "--gt_k",
           "3", "--batch_sz", "4", "--input_sz", "32", "--include_rgb",
           "--doersch_patch_side", "3", "--isola_patch_side", "3",
           "--test_code", "--num_epochs", "3"]


def _finite(history, steps=2):
    assert len(history["step_seconds"]) == steps
    assert np.isfinite(history["epoch_loss"]).all()
    assert len(history["epoch_acc"]) >= 2
    assert all(0.0 <= a <= 1.0 for a in history["epoch_acc"])


@pytest.mark.parametrize("extra", [[], ["--kmeans_on_features",
                                        "--batchnorm_track"]])
def test_triplets_sobel_cli_and_restart(tmp_path, extra):
    """Two steps and an epoch's eval, then ``--restart`` resumes at epoch 2
    with the history cut back to epoch 1 (the masses and per-class hits
    with it)."""
    argv = TRIPLETS_CLI + extra + ["--out_root", str(tmp_path)]
    net, history = triplets_sobel.main(argv, device="cpu")
    _finite(history)
    assert type(net).__name__ == "TripletsNet"
    assert len(history["masses"]) == len(history["per_class_acc"]) == 2
    assert sum(history["masses"][-1]) == 56  # 16 train + 40 test images
    with open(tmp_path / "0" / "config.pickle", "rb") as f:
        meta = pickle.load(f)
    assert meta["last_epoch"] == 1
    assert meta["config"]["arch"] == "TripletsNet5g"
    _, resumed = triplets_sobel.main(argv + ["--restart"], device="cpu")
    assert len(resumed["epoch_acc"]) == 3 and len(resumed["masses"]) == 3
    assert resumed["epoch_loss"][0] == history["epoch_loss"][0]
    assert resumed["epoch_acc"][:2] == history["epoch_acc"]


def test_triplets_greyscale_cli(tmp_path):
    net, history = triplets_greyscale.main(
        GREY_CLI + ["--out_root", str(tmp_path)], device="cpu")
    _finite(history)
    assert type(net.trunk).__name__ == "ClusterNet6cTrunk"
    assert net.head.out_features == 10  # output_k defaults to gt_k


@pytest.mark.parametrize("cli,extra", [
    (doersch, []), (doersch, ["--per_sample_patches", "--verbose"]),
    (isola, []), (isola, ["--per_sample_patches",
                          "--max_num_kmeans_samples", "500"])])
def test_seg_baseline_cli(tmp_path, capsys, cli, extra):
    net, history = cli.main(SEG_CLI + extra + ["--out_root", str(tmp_path)],
                            device="cpu")
    _finite(history)
    out = capsys.readouterr().out
    assert ("computing Doersch rgb stats" in out) == (cli is doersch)
    assert ("kmeans eval: sampling features, batch 0" in out) == (
        "--verbose" in extra)
    if "--max_num_kmeans_samples" in extra:
        assert "sampled 500 of the requested" not in out
    assert net.head.joint2.out_features == (9 if cli is doersch else 1)


def test_doersch_restart_and_save_multiple(tmp_path):
    """A --test_code run, then --restart without it for epochs 2 and 3
    under --save_multiple: it resumes at epoch 2 and leaves e_3.pytorch."""
    argv = SEG_CLI + ["--out_root", str(tmp_path), "--save_freq", "1",
                      "--doersch_stats", str(tmp_path / "stats")]
    _, first = doersch.main(argv, device="cpu")
    assert (tmp_path / "stats" / "SyntheticSeg3x40x8_stats.pickle").exists()
    rest = [a for a in argv if a != "--test_code"]
    rest[rest.index("--num_epochs") + 1] = "4"
    _, resumed = doersch.main(rest + ["--restart", "--save_multiple"],
                              device="cpu")
    assert len(resumed["epoch_acc"]) == 4
    assert resumed["epoch_acc"][:2] == first["epoch_acc"]
    assert len(resumed["epoch_loss"]) == 3
    assert (tmp_path / "0" / "e_3.pytorch").exists()
    assert not (tmp_path / "0" / "e_2.pytorch").exists()
    with open(tmp_path / "0" / "config.pickle", "rb") as f:
        assert pickle.load(f)["last_epoch"] == 3
    shutil.rmtree(tmp_path / "0")  # four checkpoints: about 1 GB


@pytest.mark.parametrize("cli,base,flag", [
    (triplets_sobel, TRIPLETS_CLI, ["--resident_data"]),
    (triplets_sobel, TRIPLETS_CLI, ["--epoch_scan"]),
    (triplets_sobel, TRIPLETS_CLI, ["--profile_dir", "p"]),
    (triplets_sobel, TRIPLETS_CLI, ["--save_progression"]),
    (triplets_sobel, TRIPLETS_CLI, ["--n_devices", "2"]),
    (triplets_greyscale, GREY_CLI, ["--bn_sync"]),
    (doersch, SEG_CLI, ["--resident_data"]),
    (doersch, SEG_CLI, ["--fused_pair_forward"]),
    (isola, SEG_CLI, ["--use_orbax"]),
    (isola, SEG_CLI, ["--n_devices", "2"]),
    (doersch, SEG_CLI, ["--profile_dir", "p"]),
    (isola, SEG_CLI, ["--profile_dir", "p"])])
def test_flags_the_port_lacks_are_refused(tmp_path, cli, base, flag):
    with pytest.raises(NotImplementedError, match=flag[0][2:]):
        cli.main(base + flag + ["--out_root", str(tmp_path)], device="cpu")


def test_iic_trainers_still_refuse_the_baselines_flags(tmp_path):
    """As in the JAX package, only the baseline trainers read them."""
    from iic_tpu_torch.cli import cluster_sobel_twohead, segmentation
    from test_torch_cluster_train import CLI as CLUSTER_CLI
    with pytest.raises(NotImplementedError, match="kmeans_on_features"):
        cluster_sobel_twohead.main(CLUSTER_CLI + ["--kmeans_on_features",
                                                  "--out_root",
                                                  str(tmp_path)],
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="per_sample_patches"):
        segmentation.main(SEG_CLI + ["--per_sample_patches", "--out_root",
                                     str(tmp_path)], device="cpu")


def test_baseline_clis_need_a_gpu_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for cli, base in ((triplets_sobel, TRIPLETS_CLI), (isola, SEG_CLI)):
        with pytest.raises(RuntimeError, match="no GPU"):
            cli.main(base + ["--out_root", str(tmp_path)])
