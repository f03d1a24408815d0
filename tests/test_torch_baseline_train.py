"""The baselines' train steps against the JAX package's, in lockstep from
the same carried-over weights on the same pre-augmented batches.

- Triplets: 8 steps of TripletsNet6c (three forwards a step, BN's running
  statistics moving after each) at lr 1e-5.
- Doersch and Isola: 4 steps each of the patch nets (p = 3 at 32^2) on the
  same images, patch geometry and relevancy masks. Dropout: the JAX step
  draws its keep mask from its key; the test reads that mask (the JAX
  head's Dropout output: zero where a unit was dropped) and gives it to
  the port's head in place of its ``nn.Dropout``, so both drop the same
  units. ``test_dropout_scale`` holds the port's own dropout (rate 0.5,
  kept units scaled by 2) on its own.

Each step holds the port's loss and every parameter beside JAX's step and
beside the port's own step run in float64 from the same weights (its
convs computing in float64), the exact trajectory:

- the loss within 1e-4 of JAX's and 1e-5 of the float64 run's. JAX's f32
  BatchNorm (var = E[x^2] - E[x]^2; ROADMAP queue 3) puts its triplets
  losses up to 5.8e-5 off the float64 run, where the port's f32 stays
  within 9.3e-7 (the patch nets: JAX 3.1e-6, the port 2.2e-6);
- each parameter tensor's distance to the reference, |port - ref|, within
  10% (JAX) and 2% (float64) of how far the reference moved from the
  initial weights, |ref - init| (L2 norms). Adam's first steps move every
  weight by about lr whatever its gradient, so a gradient within f32 noise
  of zero flips its step: measured 5.0% (JAX, triplets, step 1; 0.7% for
  the patch nets) and 0.7% (float64). A step that climbs the loss instead
  of descending it is ~200% off.

lr is 1e-5, as in tests/test_torch_cluster_train.py."""

import copy
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.ops.baselines import doersch_loss as jax_doersch_loss
from iic_tpu.ops.baselines import isola_loss as jax_isola_loss
from iic_tpu.ops.baselines import triplets_loss as jax_triplets_loss
from iic_tpu.ops.sobel import sobel_process as jax_sobel
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel.train_step import TrainState
from iic_tpu.train.seg_baseline_trainers import doersch_set_patches
from iic_tpu.train.seg_baseline_trainers import isola_set_patches
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import (
    load_seg_baseline_net, load_triplets_net)
from iic_tpu_torch.parallel.train_step import make_optimizer
from iic_tpu_torch.train.seg_baseline_trainers import (
    make_seg_baseline_train_step)
from iic_tpu_torch.train.triplets_trainer import make_triplets_train_step
from test_torch_baseline_models import PATCH, SEG_SZ, seg_baseline_pair
from test_torch_cluster_models import random_flax_variables

LR = 1e-5
JAX_LOSS_ATOL = 1e-4
F64_LOSS_ATOL = 1e-5
JAX_UPDATE_REL, F64_UPDATE_REL = 0.1, 0.02


def _float64_twin(net):
    """A float64 copy of a port net (its convs computing in float64): the
    exact trajectory the f32 port is held to beside JAX's."""
    twin = copy.deepcopy(net).double()
    for m in twin.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return twin


def _update_err(tnet, before, ref_sd):
    """The largest, over the parameter tensors, of |port - reference| /
    |reference - initial| (L2 norms): the gap against how far the weights
    have moved since the first step."""
    worst = 0.0
    for name, p in tnet.named_parameters():
        ref_move = (ref_sd[name].double() - before[name].double()).norm()
        err = (p.detach().double() - ref_sd[name].double()).norm()
        assert ref_move > 0, name
        worst = max(worst, float(err / ref_move))
    return worst


def _check_step(losses, tnet, twin, before, jvars, bridge, cfg):
    """The loss beside JAX's and the float64 twin's, then every parameter's
    update beside theirs."""
    tloss, jloss, loss64 = losses
    assert abs(tloss - jloss) <= JAX_LOSS_ATOL, losses
    assert abs(tloss - loss64) <= F64_LOSS_ATOL, losses
    jax_sd = bridge(jvars, tmodels.build(cfg.arch, cfg)).state_dict()
    assert _update_err(tnet, before, jax_sd) <= JAX_UPDATE_REL
    assert _update_err(tnet, before, twin.state_dict()) <= F64_UPDATE_REL


def _triplets_jax_step(jnet, tx):
    @jax.jit
    def step(state, orig, pos, neg):
        def loss_fn(params):
            def fwd(bs, im):
                out, upd = jnet.apply({"params": params, "batch_stats": bs},
                                      im, train=True,
                                      mutable=["batch_stats"])
                return out, upd["batch_stats"]

            out_o, bs = fwd(state.batch_stats, orig)
            out_p, bs = fwd(bs, pos)
            out_n, bs = fwd(bs, neg)
            return jax_triplets_loss(out_o, out_p, out_n), bs

        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(params=optax.apply_updates(state.params, updates),
                          batch_stats=bs, opt_state=opt_state,
                          step=state.step + 1), loss

    return step


def test_triplets_lockstep_with_jax():
    """8 steps of TripletsNet6c (greyscale, 24^2, batch 6) on fixed anchor,
    positive (anchor + noise) and negative (other images) batches."""
    cfg = SimpleNamespace(arch="TripletsNet6c", in_channels=1, output_k=5,
                          input_sz=24, batchnorm_track=True)
    jnet = jmodels.build(cfg.arch, cfg)
    variables = random_flax_variables(jnet, 1, heads=None, seed=6,
                                      head_std=0.1, sz=24)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    state = create_train_state(variables, tx)
    jstep = _triplets_jax_step(jnet, tx)
    tnet = load_triplets_net(variables, tmodels.build(cfg.arch, cfg))
    twin = _float64_twin(tnet)
    tstep, step64 = (make_triplets_train_step(
        n, make_optimizer(n, SimpleNamespace(opt="Adam", lr=LR)))
        for n in (tnet, twin))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(8):
        orig = rng.random((6, 1, 24, 24)).astype(np.float32)
        pos = np.clip(orig + 0.1 * rng.standard_normal(orig.shape), 0,
                      1).astype(np.float32)
        neg = rng.random((6, 1, 24, 24)).astype(np.float32)
        state, jloss = jstep(state, *(jnp.asarray(a) for a in
                                      (orig, pos, neg)))
        batch = tuple(torch.from_numpy(a) for a in (orig, pos, neg))
        step_losses = (float(tstep(batch)), float(jloss),
                       float(step64(tuple(t.double() for t in batch))))
        _check_step(step_losses, tnet, twin, before, jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}),
            load_triplets_net, cfg)
        losses.append(step_losses[1])
    assert max(abs(v) for v in losses) > 1e-2  # the check has teeth


class _FixedDropout(torch.nn.Module):
    """Dropout with a given keep mask, already scaled (0 or 2)."""

    def __init__(self, scaled_mask):
        super().__init__()
        self.scaled_mask = scaled_mask

    def forward(self, x):
        return x * self.scaled_mask


def _seg_jax_step(jnet, tx, loss_impl):
    gather = jax.vmap(lambda m, c: m[c[0], c[1]])

    @jax.jit
    def step(state, img1, mask, c, o, label, k_drop):
        img1 = jax_sobel(img1, True)
        bn = img1.shape[0]
        centre = jnp.broadcast_to(c, (bn, 2))
        other = jnp.broadcast_to(o, (bn, 2))
        relevant = ((gather(mask, centre) + gather(mask, other))
                    > 0).astype(jnp.float32)

        def apply(params, **kw):
            return jnet.apply({"params": params,
                               "batch_stats": state.batch_stats}, img1,
                              centre=centre, other=other, train=True,
                              rngs={"dropout": k_drop}, **kw)

        def loss_fn(params):
            logits, upd = apply(params, mutable=["batch_stats"])
            return loss_impl(logits, label, relevant), upd["batch_stats"]

        _, inter = apply(state.params, capture_intermediates=True,
                         mutable=["batch_stats", "intermediates"])
        dropped = inter["intermediates"]["_SiameseJointHead_0"][
            "Dropout_0"]["__call__"][0]
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(params=optax.apply_updates(state.params, updates),
                          batch_stats=bs, opt_state=opt_state,
                          step=state.step + 1), loss, dropped

    return step


@pytest.mark.parametrize("kind", ["doersch", "isola"])
def test_seg_baseline_lockstep_with_jax(kind):
    """4 steps at batch 4 on [r, g, b, grey] images (sobel + rgb inside the
    step), a (centre, other, label) pair a step from the reference
    geometry, masks with ~40% of the pixels irrelevant."""
    arch = ("SegmentationNet10aDoersch" if kind == "doersch"
            else "SegmentationNet10aIsola")
    cfg, jnet, variables, tnet = seg_baseline_pair(arch, seed=7)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    state = create_train_state(variables, tx)
    jstep = _seg_jax_step(jnet, tx, jax_doersch_loss if kind == "doersch"
                          else jax_isola_loss)
    twin = _float64_twin(tnet)
    tstep, step64 = (make_seg_baseline_train_step(
        n, make_optimizer(n, SimpleNamespace(opt="Adam", lr=LR)), kind,
        SEG_SZ, PATCH, sobel=True, include_rgb=True) for n in (tnet, twin))
    set_fn = doersch_set_patches if kind == "doersch" else isola_set_patches
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    rng = np.random.default_rng(1)
    losses = []
    for s in range(4):
        img1 = rng.random((4, 4, SEG_SZ, SEG_SZ)).astype(np.float32)
        mask = (rng.random((4, SEG_SZ, SEG_SZ)) > 0.4).astype(np.float32)
        pair = set_fn(np.random.default_rng(s), SEG_SZ, PATCH)
        state, jloss, dropped = jstep(
            state, jnp.asarray(img1), jnp.asarray(mask),
            jnp.asarray(pair[0]), jnp.asarray(pair[1]),
            jnp.asarray(pair[2], jnp.int32), jax.random.PRNGKey(s))
        keep = torch.from_numpy(np.asarray(dropped) != 0).double() * 2.0
        tnet.head.dropout = _FixedDropout(keep.float())
        twin.head.dropout = _FixedDropout(keep)
        img1, mask = torch.from_numpy(img1), torch.from_numpy(mask)
        step_losses = (float(tstep((img1, mask), pair=pair)), float(jloss),
                       float(step64((img1.double(), mask.double()),
                                    pair=pair)))
        _check_step(step_losses, tnet, twin, before, jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}),
            load_seg_baseline_net, cfg)
        losses.append(step_losses[1])
    assert min(losses) > 0.1


def test_dropout_scale():
    """The port's head in train mode drops about half of the joint units
    and doubles the rest; in eval mode it is the identity."""
    head = torch.nn.Dropout(0.5)
    from iic_tpu_torch.models.seg_baselines import SiameseJointHead
    assert isinstance(SiameseJointHead(8, 1, 9).dropout, torch.nn.Dropout)
    x = torch.rand(64, 1024) + 0.5
    torch.manual_seed(0)
    y = head.train()(x)
    kept = y != 0
    assert 0.45 < float(kept.float().mean()) < 0.55
    torch.testing.assert_close(y[kept], 2.0 * x[kept])
    torch.testing.assert_close(head.eval()(x), x)
