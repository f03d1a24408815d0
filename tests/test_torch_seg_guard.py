"""The segmentation learning guard (tests/test_seg_regression.py's run:
SyntheticSegStripes3x64x256, net10a two-head, T=11) against the initial
weights, in the JAX package and in the port, on the CPU. Slow (about 40
minutes on 4 workers); -rP prints each run's accuracies:

    python -m pytest tests/test_torch_seg_guard.py -m slow -n 4 -rP

A run of the guard either learns the texture classes (eval acc ~0.92) or
settles on another partition of the image (~0.6-0.68), and which one
hangs on the run's random draws, in the JAX package as in the port. The
tests show the port's part in it is the JAX package's: its train steps
track the JAX steps for two epochs from the same weights on the same
batches; and started from the JAX package's own initial weights (bridged
with ``load_seg_net``) its run has the JAX run's pre-eval and learns
beyond the majority prior as the JAX run does, whether or not either
reaches the guard's band (each run's accuracies are printed: over seeds
0-5 each package lands in the band in some seeds and settles in others)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.cli import segmentation_twohead as jax_cli
from iic_tpu.cli._args import parse_seg_args as jax_parse
from iic_tpu.data.seg_pipeline import SegTrainPipeline as JaxPipe
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel import make_seg_train_step as jax_seg_step
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.cli import segmentation_twohead
from iic_tpu_torch.compat.flax_bridge import load_seg_net
from iic_tpu_torch.parallel.train_step import (
    make_optimizer, make_seg_train_step)

pytestmark = pytest.mark.slow

# tests/test_seg_regression.py:34-50 (its --num_epochs is set per test)
GUARD = ["--model_ind", "901", "--arch", "SegmentationNet10aTwoHead",
         "--mode", "IID", "--dataset", "SyntheticSegStripes3x64x256",
         "--dataset_root", "", "--lr", "0.0001", "--lamb_A", "1.0",
         "--lamb_B", "1.5", "--num_sub_heads", "1", "--batch_sz", "32",
         "--num_dataloaders", "1", "--output_k_A", "15", "--output_k_B", "3",
         "--gt_k", "3", "--input_sz", "64", "--half_T_side_sparse_min", "0",
         "--half_T_side_sparse_max", "0", "--half_T_side_dense", "5",
         "--use_uncollapsed_loss", "--batchnorm_track"]
BAND = 0.80


def _jax_init(cfg, seed):
    """The JAX trainer's initial variables for ``seed``
    (iic_tpu/train/seg_trainer.py build_seg_net_and_state)."""
    jnet = jmodels.build(cfg.arch, cfg)
    dummy = jnp.zeros((2, cfg.in_channels, cfg.input_sz, cfg.input_sz),
                      jnp.float32)
    return jnet, jmodels.init_variables(jnet, jax.random.PRNGKey(seed),
                                        dummy)


def test_guard_steps_follow_jax():
    """Two epochs of the guard's steps (heads A, B; 8 batches each) from
    the same weights on the JAX pipeline's augmented batches: the JAX step
    (exact gather warp, conv joint) and the port's agree in the loss at
    every one of the 32 steps within 2e-3 (f32 on both sides, summed in
    different orders, so the trajectories part slowly)."""
    cfg = jax_parse(GUARD + ["--out_root", "unused"])
    cfg.finalize(twohead=True)
    jnet, variables = _jax_init(cfg, 0)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=cfg.lr)
    state = create_train_state(variables, tx)
    tnet = load_seg_net(jax.device_get(variables),
                        tmodels.build(cfg.arch, cfg))
    opt = make_optimizer(tnet, cfg)
    common = dict(half_T_side_dense=5, half_T_side_sparse_min=0,
                  half_T_side_sparse_max=0, sobel=True, include_rgb=False,
                  use_uncollapsed_loss=True)
    lambs = {"A": 1.0, "B": 1.5}
    jsteps = {h: jax_seg_step(jnet, tx, lamb=lambs[h], head=h,
                              warp_impl="gather", joint_impl="conv",
                              **common) for h in "AB"}
    tsteps = {h: make_seg_train_step(tnet, opt, lamb=lambs[h], head=h,
                                     **common) for h in "AB"}
    pipe = JaxPipe(cfg, ["train"], seed=0, use_native=False)
    key = jax.random.PRNGKey(0)
    diffs = []
    for e_i in (1, 2):
        for head in "AB":
            for batch in pipe.epoch(e_i, augmented=True):
                state, jloss, _ = jsteps[head](state, batch, key)
                tloss, _ = tsteps[head](
                    tuple(torch.from_numpy(np.array(x)) for x in batch))
                diffs.append(abs(float(tloss) - float(jloss)))
    print(f"32 steps: max |loss difference| {max(diffs):.3e}, last loss "
          f"{float(jloss):.5f}")
    assert len(diffs) == 32 and max(diffs) <= 2e-3


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_guard_runs_from_the_same_initial_weights(seed, tmp_path,
                                                  monkeypatch):
    """Two training epochs of the guard in the JAX CLI at ``seed`` and in
    the port's CLI started from that run's initial weights: equal
    pre-evals (the same net, the same eval), finite losses, and each run
    gains at least 0.15 over its pre-eval (the majority prior, 0.36-0.42):
    the displacement-invariance machinery learns in both, whether the run
    then reaches the band (best eval acc >= 0.80) or settles."""
    argv = GUARD + ["--num_epochs", "3", "--seed", str(seed)]
    _, jhist = jax_cli.main(argv + ["--out_root", str(tmp_path / "jax")])
    cfg = jax_parse(argv + ["--out_root", "unused"])
    cfg.finalize(twohead=True)
    _, variables = _jax_init(cfg, seed)
    build = tmodels.build

    def from_jax(name, config):
        return load_seg_net(jax.device_get(variables), build(name, config))

    monkeypatch.setattr(tmodels, "build", from_jax)
    _, thist = segmentation_twohead.main(
        argv + ["--out_root", str(tmp_path / "port")], device="cpu")
    jacc = np.array(jhist["eval"].epoch_acc, float)
    tacc = np.array(thist["eval"].epoch_acc, float)
    print(f"seed {seed}: JAX eval acc {np.round(jacc, 4).tolist()} loss B "
          f"{np.round(jhist['epoch_loss_head_B'], 4).tolist()} (band: "
          f"{jacc.max() >= BAND}); port {np.round(tacc, 4).tolist()} loss B "
          f"{np.round(thist['epoch_loss_head_B'], 4).tolist()} (band: "
          f"{tacc.max() >= BAND})")
    assert len(jacc) == len(tacc) == 3
    assert abs(jacc[0] - tacc[0]) <= 1e-3
    for hist, acc in ((jhist, jacc), (thist, tacc)):
        assert np.isfinite(hist["epoch_loss_head_B"]).all()
        assert acc.max() - acc[0] >= 0.15
