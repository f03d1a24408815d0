"""The port's clustering training slice against the JAX package: a
four-step lockstep (heads A, B, A, B) of the clustering train step from
bridged weights on fixed pre-augmented batches, for the plain loss and the
fused one; double eval's BN statistics; ``cluster_eval`` and
``get_subhead_using_loss`` on fixed outputs; the two-head sobel CLI on the
CPU; and the flags the port refuses."""

import pickle
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from iic_tpu import models as jmodels
from iic_tpu.evals import cluster_eval as jax_cluster_eval
from iic_tpu.evals import get_subhead_using_loss as jax_subhead
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel import make_apply_fn as jax_apply_fn
from iic_tpu.parallel import make_cluster_train_step as jax_cluster_step
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.cli import cluster_sobel_twohead
from iic_tpu_torch.compat.flax_bridge import load_cluster_net
from iic_tpu_torch.evals.cluster_eval import (
    EvalHistory, cluster_eval, get_subhead_using_loss)
from iic_tpu_torch.parallel.train_step import (
    make_apply_fn, make_cluster_train_step, make_optimizer)
from iic_tpu_torch.train.cluster_trainer import head_order
from test_torch_cluster_models import cluster_cfg, random_flax_variables

SZ = 32


def _batches(n_steps, b=6, seed=0):
    """Fixed pre-augmented grey pairs (imgs, imgs_tf) (b, 1, SZ, SZ)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        imgs = rng.random((b, 1, SZ, SZ)).astype(np.float32)
        tf = np.clip(imgs + 0.1 * rng.standard_normal(imgs.shape), 0, 1)
        out.append((imgs, tf.astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def bridged():
    """The JAX net and numpy-made variables (heads confident enough that
    the loss is O(0.1), not ~0) and a config for both packages."""
    cfg = cluster_cfg(True)
    jnet = jmodels.build(cfg.arch, cfg)
    variables = random_flax_variables(jnet, cfg.in_channels, seed=5,
                                      head_std=0.1)
    return cfg, jnet, variables


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_four_step_lockstep_with_jax(bridged, impl):
    """Heads A, B, A, B from the same weights on the same batches of 6
    pairs (2 base images x 3): the JAX step (optax adam; the fused kernel in
    interpret mode) and the port's (torch Adam; K3's plain version and its
    analytic backward on the CPU). The loss differs by at most 1e-4 at
    every step.

    lr is 1e-5. Adam's first steps move every weight by about lr whatever
    the size of its gradient, so f32 gradient noise grows with lr: on this
    ResNet-34 the JAX step's trunk gradients are ~1e-2 relative off a
    float64 run of the port (the port's f32 ones ~1e-4), and at model 640's
    lr of 1e-4 the JAX losses leave the float64 trajectory by 1.8e-4 at
    step 3 and 5.5e-4 at step 4 (the port's f32 by 6e-6 and 1.5e-4). At
    1e-5 the check keeps its teeth: a port step that climbs the loss
    instead of descending it is 6.7e-4 off at step 2."""
    cfg, jnet, variables = bridged
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-5)
    state = create_train_state(variables, tx)
    tnet = load_cluster_net(variables, tmodels.build(cfg.arch, cfg))
    opt = make_optimizer(tnet, SimpleNamespace(opt="Adam", lr=1e-5))
    lambs = {"A": 1.0, "B": 1.3}
    jsteps = {h: jax_cluster_step(
        jnet, tx, lambda batch, key: batch, lamb=lambs[h], head=h,
        sobel=True, loss_impl="pallas" if impl == "fused" else "xla")
        for h in "AB"}
    tsteps = {h: make_cluster_train_step(
        tnet, opt, None, lamb=lambs[h], head=h, sobel=True, loss_impl=impl)
        for h in "AB"}
    key = jax.random.PRNGKey(0)
    losses = []
    for head, batch in zip("ABAB", _batches(4)):
        with pltpu.force_tpu_interpret_mode():
            state, jloss, jloss_nl = jsteps[head](
                state, tuple(jnp.asarray(x) for x in batch), key)
        tloss, tloss_nl = tsteps[head](tuple(torch.from_numpy(x)
                                             for x in batch))
        assert abs(float(tloss) - float(jloss)) <= 1e-4, (head, tloss, jloss)
        assert abs(float(tloss_nl) - float(jloss_nl)) <= 1e-4
        losses.append(float(jloss))
    assert max(abs(v) for v in losses) > 1e-2  # the check has teeth


def test_double_eval_keeps_bn_statistics(bridged):
    """``make_apply_fn(train_mode=True)``: batch-statistics outputs equal to
    the JAX package's train-mode apply (atol 1e-5), and every running
    statistic and batch count as it was; the eval-mode apply matches too."""
    cfg, jnet, variables = bridged
    tnet = load_cluster_net(variables, tmodels.build(cfg.arch, cfg))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    x = np.random.default_rng(7).random((5, 1, SZ, SZ)).astype(np.float32)
    for train_mode in (True, False):
        ref = jax_apply_fn(jnet, head="B", sobel=True,
                           train_mode=train_mode)(variables, jnp.asarray(x))
        got = make_apply_fn(tnet, head="B", sobel=True,
                            train_mode=train_mode)(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, before[k]), k


class _Loader:
    """A mapping loader over fixed batches: yields (batch index, labels)."""

    def __init__(self, labels):
        self.labels = labels

    def __iter__(self):
        return iter(enumerate(self.labels))


def test_cluster_eval_and_subhead_selection_match_jax():
    """On fixed softmax outputs: the same stats (per-sub-head accuracies,
    the best sub-head and its match), double-eval lists and is_best; the
    same sub-head picked by loss."""
    rng = np.random.default_rng(3)
    s, k, n = 3, 4, 3
    labels = [rng.integers(0, k, 20).astype(np.int32) for _ in range(n)]
    outs = [rng.dirichlet(np.ones(k), (s, 20)).astype(np.float32)
            for _ in range(n)]
    outs2 = [rng.dirichlet(np.ones(k), (s, 20)).astype(np.float32)
             for _ in range(n)]
    cfg = SimpleNamespace(num_sub_heads=s, output_k=k, gt_k=k,
                          eval_mode="hung", mode="IID")
    loader = _Loader(labels)

    def run(evaluate, history, wrap):
        return [evaluate(cfg, lambda i: wrap(outs[i]), loader, loader,
                         history=history,
                         double_eval_apply_fn=lambda i: wrap(outs2[i]))
                for _ in range(2)]

    got_hist, ref_hist = EvalHistory(), jax_cluster_eval.__globals__[
        "EvalHistory"]()
    got = run(cluster_eval, got_hist, torch.from_numpy)
    ref = run(jax_cluster_eval, ref_hist, jnp.asarray)
    for (g_best, g_stats), (r_best, r_stats) in zip(got, ref):
        assert g_best == r_best
        assert g_stats == r_stats
    assert got_hist.epoch_acc == ref_hist.epoch_acc
    assert got_hist.double_eval_acc == ref_hist.double_eval_acc
    assert len(got_hist.double_eval_stats) == 2

    pairs = list(zip(outs, outs2))
    got_sub = get_subhead_using_loss(
        cfg, [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in pairs])
    ref_sub = jax_subhead(cfg, [(jnp.asarray(a), jnp.asarray(b))
                                for a, b in pairs])
    assert got_sub == ref_sub


CLI = ["--arch", "ClusterNet5gTwoHead", "--mode", "IID",
       "--dataset", "Synthetic10x32x3x16", "--gt_k", "10",
       "--output_k_A", "15", "--output_k_B", "10", "--lamb", "1.0",
       "--lr", "0.0001", "--num_epochs", "2", "--batch_sz", "12",
       "--num_dataloaders", "3", "--num_sub_heads", "2", "--crop_orig",
       "--rand_crop_sz", "20", "--input_sz", "32", "--test_code"]


@pytest.mark.parametrize("extra,steps_a,steps_b,double", [
    (["--head_A_first", "--head_B_epochs", "2", "--double_eval",
      "--batchnorm_track", "--fused_loss"], 2, 4, True),
    (["--select_sub_head_on_loss", "--lr_schedule", "1", "--include_rgb",
      "--head_A_epochs", "2"], 4, 2, False)])
def test_cli_on_cpu(tmp_path, capsys, extra, steps_a, steps_b, double):
    """The two-head sobel CLI with --test_code (model 640's flags at a small
    batch, and a second set of paths): finite losses, two steps per head
    pass, a pre-train and an epoch eval (double eval included), the run
    directory's files, and the head order."""
    net, history = cluster_sobel_twohead.main(
        CLI + extra + ["--out_root", str(tmp_path)], device="cpu")
    for head, steps in (("A", steps_a), ("B", steps_b)):
        assert np.isfinite(history[f"epoch_loss_head_{head}"]).all()
        assert len(history[f"step_seconds_head_{head}"]) == steps
    ev = history["eval"]
    assert len(ev.epoch_acc) == 2 and all(0 <= a <= 1 for a in ev.epoch_acc)
    assert len(ev.double_eval_acc) == (2 if double else 0)
    first = "head A batch 0" if "--head_A_first" in extra else "head B batch 0"
    out = capsys.readouterr().out
    assert out.index(first) < min(out.index("head A batch 0"),
                                  out.index("head B batch 0")) + 1
    saved = torch.load(tmp_path / "0" / "latest.pytorch", weights_only=True)
    assert "trunk.layer4.2.conv2.weight" in saved["net"]
    with open(tmp_path / "0" / "config.pickle", "rb") as f:
        assert pickle.load(f)["last_epoch"] == 1


def test_head_order_is_b_first_unless_head_a_first():
    assert head_order(SimpleNamespace(head_A_first=False)) == ["B", "A"]
    assert head_order(SimpleNamespace(head_A_first=True)) == ["A", "B"]


def test_cli_needs_a_gpu_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        cluster_sobel_twohead.main(CLI + ["--out_root", str(tmp_path)])


@pytest.mark.parametrize("flag", [
    ["--n_devices", "2"], ["--bn_sync"], ["--joint_mode", "parity"],
    ["--epoch_scan"], ["--resident_data"], ["--fused_pair_forward"],
    ["--use_orbax"], ["--profile_dir", "p"], ["--save_progression"], ["--fluid_warp"],
    ["--cutout"], ["--rot_val", "25"]])
def test_flags_outside_the_slice_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match=flag[0][2:]):
        cluster_sobel_twohead.main(CLI + ["--out_root", str(tmp_path)]
                                   + flag, device="cpu")
