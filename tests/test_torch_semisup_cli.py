"""The port's semi-supervised finetune CLI (``IID_semisup_STL10``) end to
end on the CPU: tests/test_semisup.py's two runs with their bands, the old
runs made by the port's single-head CLIs; ``--restart`` against an
uninterrupted run (bit-equal histories and weights on the CPU) and
``--restart_new_model_ind``; table 3's flags; bf16; the refusals."""

import pickle
import shutil

import numpy as np
import pytest
import torch

from iic_tpu_torch.cli import IID_semisup_STL10, cluster_greyscale, \
    cluster_sobel
from iic_tpu_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Removes each test's run directories after it: a SupHead5 head with
    its Adam moments makes a checkpoint file of ~110 MB at these sizes, and
    pytest keeps the temporary directories of its last runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _old_sobel(out_root, model_ind, dataset, extra=()):
    """tests/test_semisup.py's IID+ pretrain (net6c, rgb + grey, sobel) by
    the port's cluster_sobel, on the CPU."""
    cluster_sobel.main([
        "--model_ind", str(model_ind), "--arch", "ClusterNet6c",
        "--dataset", dataset, "--gt_k", "10", "--output_k", "20",
        "--lr", "1e-3", "--num_epochs", "2", "--batch_sz", "32",
        "--num_dataloaders", "2", "--num_sub_heads", "1",
        "--out_root", str(out_root), "--crop_orig", "--rand_crop_sz", "28",
        "--input_sz", "24", "--include_rgb", "--batchnorm_track",
        "--test_code", "--save_freq", "1", *extra], device="cpu")


def _finetune(out_root, model_ind, old, *flags):
    return IID_semisup_STL10.main([
        "--model_ind", str(model_ind), "--old_model_ind", str(old),
        "--out_root", str(out_root), *flags], device="cpu")


def test_semisup_end_to_end(tmp_path):
    """tests/test_semisup.py's test_semisup_end_to_end: a tiny IID+ run,
    then 8 epochs of SupHead5 at head lr 1e-2 / trunk lr 1e-3: the CE
    collapses (last epoch's below 1.0) and the 10-crop accuracy clearly
    beats 10% chance (best above 0.25)."""
    _old_sobel(tmp_path, 11, "Synthetic10x32x3x128")
    model, history = _finetune(tmp_path, 12, 11, "--head_lr", "1e-2",
                               "--trunk_lr", "1e-3", "--num_epochs", "8",
                               "--new_batch_sz", "32")
    assert len(history["epoch_acc"]) == 9  # the pre-train eval first
    assert np.isfinite(history["epoch_loss"][-1])
    assert history["epoch_loss"][-1] < 1.0
    assert max(history["epoch_acc"]) > 0.25
    assert len(history["eval_seconds"]) == 9
    assert model.head.linear1.in_features == 512 * 3 * 3


def test_semisup_greyscale_fewer_labels(tmp_path, capsys):
    """tests/test_semisup.py's test_semisup_greyscale_fewer_labels: a
    greyscale old run finetunes through the greyscale tf2 (no sobel) on
    half its labels (64 of 128, JAX's numpy choice): the CE falls below 1.0
    and every eval is finite."""
    cluster_greyscale.main([
        "--model_ind", "13", "--arch", "ClusterNet6c",
        "--dataset", "Synthetic10x32x1x128", "--gt_k", "10",
        "--output_k", "20", "--lr", "1e-3", "--num_epochs", "2",
        "--batch_sz", "32", "--num_dataloaders", "2", "--num_sub_heads", "1",
        "--out_root", str(tmp_path), "--crop_orig", "--tf1_crop", "centre",
        "--tf1_crop_sz", "28", "--tf2_crop", "random", "--tf2_crop_szs",
        "28", "--input_sz", "24", "--rot_val", "25", "--no_flip",
        "--batchnorm_track", "--test_code", "--save_freq", "1"],
        device="cpu")
    _, history = _finetune(tmp_path, 14, 13, "--head_lr", "1e-2",
                           "--trunk_lr", "1e-3", "--num_epochs", "6",
                           "--new_batch_sz", "16", "--train_label_pc", "0.5")
    assert "train_label_pc 0.5: 64 labelled samples" in capsys.readouterr().out
    assert np.isfinite(history["epoch_loss"][-1])
    assert min(history["epoch_loss"]) < 1.0
    assert np.isfinite(history["epoch_acc"]).all()


# ---------------------------------------------------------------- restart

SMALL = "Synthetic10x32x3x32"  # one batch of 32 an epoch, 40 test images


class _Stop(Exception):
    pass


def _state(path):
    return torch.load(path, weights_only=True)


def test_restart_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    """A 3-epoch finetune against one stopped after epoch 1 (its latest
    weights from epoch 0, its config.pickle from epoch 1) and resumed with
    --restart: the history past epoch 0 is dropped, epochs 1 and 2 run
    again, and the histories and the last weights and optimiser state
    equal the uninterrupted run's bit for bit. Then --restart
    --restart_new_model_ind continues as model 22 for one more epoch."""
    # at 16^2 (argparse takes the last of a repeated flag): a 2048-wide
    # head keeps the checkpoints small
    _old_sobel(tmp_path, 1, SMALL, ("--rand_crop_sz", "20", "--input_sz",
                                    "16"))
    flags = ("--num_epochs", "3", "--lr_schedule", "2", "--lr_mult", "0.5")
    _, ref = _finetune(tmp_path, 20, 1, *flags)

    save_meta = ckpt.save_meta

    def stop_after_epoch_1(config, history, last_epoch, name="meta"):
        save_meta(config, history, last_epoch, name)
        if len(history["epoch_loss"]) == 2:
            raise _Stop

    monkeypatch.setattr(ckpt, "save_meta", stop_after_epoch_1)
    with pytest.raises(_Stop):
        _finetune(tmp_path, 21, 1, *flags)
    monkeypatch.setattr(ckpt, "save_meta", save_meta)
    meta = ckpt.read_meta(tmp_path, 21)
    assert meta["last_epoch"] == 0 and len(meta["history"]["epoch_acc"]) == 3

    _, got = _finetune(tmp_path, 21, 1, "--restart", *flags)
    assert got["epoch_acc"] == ref["epoch_acc"]
    assert got["epoch_loss"] == ref["epoch_loss"]
    a, b = (_state(tmp_path / m / "latest.pytorch") for m in ("20", "21"))
    for key in a["net"]:
        assert torch.equal(a["net"][key], b["net"][key]), key
    assert a["optimiser"]["param_groups"] == b["optimiser"]["param_groups"]
    assert [g["lr"] for g in a["optimiser"]["param_groups"]] == [5e-5, 5e-4]

    _, more = _finetune(tmp_path, 21, 1, "--restart",
                        "--restart_new_model_ind", "--new_model_ind", "22",
                        "--num_epochs", "4")
    assert more["epoch_acc"][:4] == ref["epoch_acc"]
    assert len(more["epoch_acc"]) == 5 and len(more["epoch_loss"]) == 4
    with open(tmp_path / "22" / "config.pickle", "rb") as f:
        meta = pickle.load(f)
    assert meta["config"]["model_ind"] == 22 and meta["last_epoch"] == 3
    assert (tmp_path / "22" / "latest.pytorch").exists()


# ------------------------------------------------- flags, bf16, refusals

TABLE3 = ["--model_ind", "698", "--old_model_ind", "650", "--head_lr",
          "0.001", "--trunk_lr", "0.0001", "--arch", "SupHead5",
          "--penultimate_features", "--random_affine", "--affine_p", "0.5",
          "--cutout", "--cutout_p", "0.5", "--cutout_max_box", "0.7",
          "--num_epochs", "8000"]


def test_table3_flags_parse():
    cfg = IID_semisup_STL10.config(TABLE3 + ["--lr_schedule", "100", "200"])
    assert (cfg.model_ind, cfg.old_model_ind, cfg.arch) == (698, 650,
                                                            "SupHead5")
    assert cfg.penultimate_features and cfg.random_affine and cfg.cutout
    assert (cfg.affine_p, cfg.cutout_p, cfg.cutout_max_box) == (0.5, 0.5,
                                                                0.7)
    assert cfg.new_batch_sz == -1 and cfg.lr_schedule == (100, 200)


def test_bf16_old_run_finetunes_with_an_f32_head(tmp_path):
    """A bfloat16 old run (ResNet-34, table 3's --penultimate_features,
    --random_affine and --cutout, --test_code): the trunk computes in bf16,
    the head and the loss in f32; the batch is the old run's."""
    cluster_sobel.main([
        "--model_ind", "2", "--arch", "ClusterNet5g", "--dataset", SMALL,
        "--gt_k", "10", "--output_k", "20", "--batch_sz", "8",
        "--num_dataloaders", "2", "--num_sub_heads", "1",
        "--out_root", str(tmp_path), "--crop_orig", "--rand_crop_sz", "24",
        "--input_sz", "16", "--batchnorm_track", "--test_code",
        "--save_freq", "1", "--model_dtype", "bfloat16"], device="cpu")
    model, history = _finetune(tmp_path, 3, 2, *TABLE3[4:-2],
                               "--test_code")
    assert np.isfinite(history["epoch_loss"]).all()
    assert len(history["step_seconds"]) == 2  # 32 images, batches of 8
    x = torch.zeros((2, 2, 16, 16))
    model.eval()
    with torch.no_grad():
        assert model.features(x).dtype == torch.bfloat16
        assert model(x).dtype == torch.float32
    assert model.head.linear1.in_features == 256 * 3 * 3


def test_cli_needs_a_gpu_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        IID_semisup_STL10.main(["--out_root", str(tmp_path)])
