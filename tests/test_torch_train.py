"""The port's training slice against the JAX package: a four-step lockstep
(heads A, B, A, B) of the segmentation train step from bridged weights on
fixed pre-augmented batches, the two-head CLI on the CPU, the flags the
port refuses, and the rule that importing the port loads no JAX."""

import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel import make_seg_train_step as jax_seg_step
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.cli import segmentation_twohead
from iic_tpu_torch.compat.flax_bridge import load_seg_net
from iic_tpu_torch.parallel.train_step import (
    make_optimizer, make_seg_train_step, set_lr_mult)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SZ, HALF_T = 24, 2


def _batches(n_steps, b=3, seed=0):
    """Fixed pre-augmented batches (img1, img2 [r,g,b,grey], affine2_to_1,
    mask) as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        img1 = rng.random((b, 4, SZ, SZ)).astype(np.float32)
        img2 = np.clip(img1 + 0.1 * rng.standard_normal(img1.shape), 0,
                       1).astype(np.float32)
        a = np.radians(rng.uniform(-15, 15, b))
        aff = np.zeros((b, 2, 3), np.float32)
        aff[:, 0, 0], aff[:, 0, 1] = np.cos(a), -np.sin(a)
        aff[:, 1, 0], aff[:, 1, 1] = np.sin(a), np.cos(a)
        aff[0, 0] *= -1.0
        mask = (rng.random((b, SZ, SZ)) > 0.1).astype(np.float32)
        out.append((img1, img2, aff, mask))
    return out


@pytest.mark.parametrize("uncollapsed", [True, False])
def test_four_step_lockstep_with_jax(uncollapsed):
    """Heads A, B, A, B from the same weights on the same batches: the JAX
    step (exact gather warp, conv joint, optax adam) and the port's step
    (its kernels' plain versions on the CPU, torch Adam). The loss differs
    by at most 1e-4 at every step."""
    cfg = SimpleNamespace(in_channels=5, output_k_A=5, output_k_B=3,
                          num_sub_heads=2, input_sz=SZ, batchnorm_track=True,
                          opt="Adam", lr=1e-3)
    jnet = jmodels.build("SegmentationNet10aTwoHead", cfg)
    variables = jmodels.init_variables(
        jnet, jax.random.PRNGKey(0), jnp.zeros((2, 5, SZ, SZ)))
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=cfg.lr)
    state = create_train_state(variables, tx)
    tnet = load_seg_net(jax.device_get(variables),
                        tmodels.build("SegmentationNet10aTwoHead", cfg))
    opt = make_optimizer(tnet, cfg)

    common = dict(half_T_side_dense=HALF_T, half_T_side_sparse_min=0,
                  half_T_side_sparse_max=0, sobel=True, include_rgb=True,
                  use_uncollapsed_loss=uncollapsed)
    lambs = {"A": 1.0, "B": 1.5}
    jsteps = {h: jax_seg_step(jnet, tx, lamb=lambs[h], head=h,
                              warp_impl="gather", joint_impl="conv",
                              **common) for h in "AB"}
    tsteps = {h: make_seg_train_step(tnet, opt, lamb=lambs[h], head=h,
                                     **common) for h in "AB"}
    key = jax.random.PRNGKey(0)
    for head, batch in zip("ABAB", _batches(4)):
        state, jloss, jloss_nl = jsteps[head](
            state, tuple(jnp.asarray(x) for x in batch), key)
        tloss, tloss_nl = tsteps[head](
            tuple(torch.from_numpy(x) for x in batch))
        assert abs(float(tloss) - float(jloss)) <= 1e-4, (head, tloss, jloss)
        assert abs(float(tloss_nl) - float(jloss_nl)) <= 1e-4


def test_lr_mult_scales_every_group():
    net = torch.nn.Linear(2, 2)
    opt = make_optimizer(net, SimpleNamespace(opt="Adam", lr=1e-3))
    set_lr_mult(opt, 0.1)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-4)


CLI = ["--mode", "IID", "--dataset", "SyntheticSeg3x48x16",
       "--dataset_root", "", "--arch", "SegmentationNet10aTwoHead",
       "--lamb_A", "1.0", "--lamb_B", "1.5", "--num_sub_heads", "1",
       "--batch_sz", "4", "--num_dataloaders", "1", "--output_k_A", "5",
       "--output_k_B", "3", "--gt_k", "3", "--input_sz", "32",
       "--half_T_side_sparse_min", "0", "--half_T_side_sparse_max", "0",
       "--half_T_side_dense", "2", "--include_rgb", "--use_uncollapsed_loss",
       "--batchnorm_track", "--test_code", "--num_epochs", "2"]


def test_cli_slice_on_cpu(tmp_path):
    """The CLI slice with --test_code: finite losses for both heads, a
    pre-train and an epoch eval, and the reference's run-dir files."""
    net, history = segmentation_twohead.main(
        CLI + ["--out_root", str(tmp_path)], device="cpu")
    for head in "AB":
        losses = history[f"epoch_loss_head_{head}"]
        assert len(losses) == 1 and np.isfinite(losses[0])
        assert len(history[f"step_seconds_head_{head}"]) == 2
    acc = history["eval"].epoch_acc
    assert len(acc) == 2 and all(0.0 <= a <= 1.0 for a in acc)
    run = tmp_path / "0"
    saved = torch.load(run / "latest.pytorch", weights_only=True)
    assert set(saved) == {"net", "optimiser"}
    assert "trunk.features.0.weight" in saved["net"]
    with open(run / "config.pickle", "rb") as f:
        meta = pickle.load(f)
    assert meta["last_epoch"] == 1
    assert meta["config"]["dataset"] == "SyntheticSeg3x48x16"


@pytest.mark.parametrize("extra", [
    ["--num_dataloaders", "2", "--mode", "IID+", "--use_random_affine"],
    ["--head_B_first", "--lr_schedule", "1", "--no_pre_eval",
     "--num_sub_heads", "2", "--joint_impl", "conv"],
    ["--no_sobel", "--dataset", "SyntheticSegPotsdam3x48x16",
     "--half_T_side_sparse_max", "1"]])
def test_cli_variants_on_cpu(tmp_path, extra):
    """Other trainer paths: r > 1 repeats, IID+ partitions, random affine;
    head B first, an lr step, sub-heads, the conv joint; no sobel with an
    IR channel and the sparse translation (the last flag wins in argparse).
    Losses stay finite and every epoch is evaluated."""
    argv = [a for a in CLI if a != "--use_uncollapsed_loss"] + extra
    _, history = segmentation_twohead.main(
        argv + ["--out_root", str(tmp_path)], device="cpu")
    for head in "AB":
        assert np.isfinite(history[f"epoch_loss_head_{head}"]).all()
    assert len(history["eval"].epoch_acc) == 2


def test_cli_needs_a_gpu_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        segmentation_twohead.main(CLI + ["--out_root", str(tmp_path)])


@pytest.mark.parametrize("flag", [
    ["--epoch_scan"], ["--resident_data"], ["--fused_pair_forward"],
    ["--use_orbax"], ["--joint_impl", "fft"]])
def test_flags_outside_the_slice_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match=flag[0][2:]):
        segmentation_twohead.main(CLI + ["--out_root", str(tmp_path)] + flag,
                                  device="cpu")


def test_import_loads_no_jax():
    """Importing every module of the port leaves jax, flax, optax and
    iic_tpu out of sys.modules, and sklearn, which the card's machine does
    not have (the baselines' k-means is the port's own), and PIL and cv2,
    which only the functions that read or write an image import."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import iic_tpu_torch\n"
        "for m in pkgutil.walk_packages(iic_tpu_torch.__path__, "
        "'iic_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'iic_tpu', 'sklearn', "
        "'PIL', 'cv2') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
