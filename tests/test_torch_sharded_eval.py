"""The port's sharded eval forward (``parallel.mesh.make_sharded_eval``) and
the clustering trainer's sub-head pick under a mesh, against the JAX
package on the CPU.

Port side: 2 gloo ranks spawned once from this file
(``tests/test_torch_sharded_eval_worker.py``, which imports no JAX) run
every case. JAX side: ``make_eval_apply`` / ``make_seg_eval_apply`` with
``mesh=make_mesh(2)`` on 2 of the suite's virtual CPU devices, on the same
weights (``compat/flax_bridge.py``) and the same numpy batch. Cases:
``ClusterNet6cTwoHead`` and ``SegmentationNet10aTwoHead`` at small widths,
a batch of 16 and a ragged 11, ``batchnorm_track`` on and off, and the
clustering double eval's train-mode forward.

At the ragged batch both packages pad to 12 with copies of the last image
and shard the padded batch, so BatchNorm on batch statistics counts the
copies: JAX's sharded path, which the port follows. Against one port rank
the sharded eval is held to that rank's forward of the same padded batch,
the padding cut off.

The pick (``_select_sub_head_on_loss``) with ``batchnorm_track`` off, on
fixed image pairs: each rank's per-sub-head losses against JAX's
``_select_sub_head_on_loss(..., mesh=make_mesh(2))``, whose single process
forwards the whole batch, and the same argmin; the pick with each rank's
BatchNorm statistics over its own shard must fail that check."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel.mesh import make_mesh as jax_make_mesh
from iic_tpu.train.cluster_trainer import (
    _select_sub_head_on_loss as jax_select_sub_head)
from iic_tpu.train.cluster_trainer import make_eval_apply
from iic_tpu.train.seg_trainer import make_seg_eval_apply
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import load_cluster_net, load_seg_net
from iic_tpu_torch.parallel import mesh as mesh_lib
import test_torch_sharded_eval_worker as worker
from test_torch_cluster_models import random_flax_variables

WORLD = 2
SZ_C, SZ_S = 16, 24
BATCHES = (16, 11)
# the gathered outputs (softmax probabilities) against JAX's sharded eval,
# rtol and atol: with running statistics the bound of
# tests/test_multihost.py's sharded eval check (measured at most 1.1e-6
# absolute, as one port rank on the whole batch is); with batch statistics
# (E[x^2] - E[x]^2 over the ranks, in f32 in both packages) measured at
# most 8.4e-5, one port rank on the whole batch 8.3e-5, and each rank's
# statistics over its own shard 0.19-0.49 off
RUNNING_TOL = 1e-6
BATCH_STATS_TOL = 2e-4
# against one port rank on the same (padded) batch, whose nn.BatchNorm2d
# takes the variance in another order (measured at most 1.5e-7 with running
# statistics, 9.2e-6 with batch statistics)
SELF_TOL = {False: 1e-6, True: 3e-5}
# the pick's per-sub-head losses against JAX's, relative to their largest
# (measured 2.6e-7 with the statistics over the ranks, 2.4e-2 over each
# rank's shard)
PICK_REL = 1e-5
SPAWN_TIMEOUT = 600


def _cluster_cfg(track):
    return dict(arch="ClusterNet6cTwoHead", in_channels=1, output_k=4,
                output_k_A=7, output_k_B=4, num_sub_heads=3, input_sz=SZ_C,
                include_rgb=False, batchnorm_track=track)


def _seg_cfg(track):
    return dict(arch="SegmentationNet10aTwoHead", in_channels=3,
                output_k_A=5, output_k_B=3, num_sub_heads=2, input_sz=SZ_S,
                include_rgb=True, batchnorm_track=track)


def _variables(kind, track, seed):
    cfg = _cluster_cfg(track) if kind == "cluster" else _seg_cfg(track)
    jnet = jmodels.build(cfg["arch"], SimpleNamespace(**cfg))
    variables = random_flax_variables(
        jnet, cfg["in_channels"], seed=seed, head_std=0.1,
        sz=SZ_C if kind == "cluster" else SZ_S)
    load = load_cluster_net if kind == "cluster" else load_seg_net
    tnet = load(variables, tmodels.build(cfg["arch"], SimpleNamespace(**cfg)))
    return cfg, jnet, variables, tnet.state_dict()


def _eval_case(kind, track, b, train_mode=False, seed=0, per_shard=False):
    cfg, jnet, variables, state = _variables(kind, track, seed)
    sz = SZ_C if kind == "cluster" else SZ_S
    imgs = np.random.default_rng(seed + b).random(
        (b, cfg["in_channels"], sz, sz)).astype(np.float32)
    name = (f"{kind}-{'track' if track else 'batch'}-b{b}"
            + ("-double" if train_mode else "")
            + ("-per-shard" if per_shard else ""))
    return dict(name=name, kind=kind, arch=cfg["arch"], cfg=cfg, state=state,
                imgs=imgs, train_mode=train_mode, per_shard=per_shard,
                _jax=(jnet, variables))


def _eval_cases():
    cases = []
    for b in BATCHES:
        for track in (True, False):
            cases.append(_eval_case("cluster", track, b, seed=1))
            cases.append(_eval_case("seg", track, b, seed=2))
        cases.append(_eval_case("cluster", True, b, train_mode=True, seed=3))
    return cases


def _per_shard_cases():
    """The batch-statistics cases at b = 16 with each rank's statistics its
    shard's."""
    return [_eval_case("cluster", False, 16, seed=1, per_shard=True),
            _eval_case("seg", False, 16, seed=2, per_shard=True),
            _eval_case("cluster", True, 16, train_mode=True, seed=3,
                       per_shard=True)]


def _pick_case(per_shard):
    cfg, jnet, variables, state = _variables("cluster", False, seed=4)
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(3):
        imgs = rng.random((12, 1, SZ_C, SZ_C)).astype(np.float32)
        tf = np.clip(imgs + 0.1 * rng.standard_normal(imgs.shape), 0, 1)
        pairs.append((imgs, tf.astype(np.float32)))
    return dict(name="pick-per-shard" if per_shard else "pick",
                arch=cfg["arch"], cfg=cfg, state=state, pairs=pairs,
                per_shard=per_shard, _jax=(jnet, variables))


EVAL_NAMES = [c["name"] for c in _eval_cases()]
PER_SHARD_NAMES = [c["name"] for c in _per_shard_cases()]


@pytest.fixture(scope="module")
def runs():
    """Every case through 2 spawned gloo ranks in one spawn (the cases
    without their JAX halves)."""
    cases = (_eval_cases() + _per_shard_cases()
             + [_pick_case(False), _pick_case(True)])
    shipped = [{k: v for k, v in c.items() if k != "_jax"} for c in cases]
    ranks = mesh_lib.spawn(worker.run_cases, WORLD, args=(shipped,),
                           device_type="cpu", timeout=SPAWN_TIMEOUT)
    return {c["name"]: (c, [r[i] for r in ranks])
            for i, c in enumerate(cases)}


def _jax_eval(case):
    jnet, variables = case["_jax"]
    state = create_train_state(variables, optax.sgd(0.1))
    cfg = SimpleNamespace(sobel=False, include_rgb=case["cfg"]["include_rgb"],
                          using_IR=False)
    mesh = jax_make_mesh(WORLD)
    if case["kind"] == "cluster":
        apply = make_eval_apply(jnet, state, cfg, head="B",
                                train_mode=case["train_mode"], mesh=mesh)
    else:
        apply = make_seg_eval_apply(jnet, state, cfg, head="B", mesh=mesh)
    return np.asarray(apply(jnp.asarray(case["imgs"])))


def _batch_stats(case):
    return case["train_mode"] or not case["cfg"]["batchnorm_track"]


@pytest.mark.parametrize("name", EVAL_NAMES)
def test_sharded_eval_equals_jax_sharded_eval(runs, name):
    case, ranks = runs[name]
    want = _jax_eval(case)
    tol = BATCH_STATS_TOL if _batch_stats(case) else RUNNING_TOL
    for r in ranks:
        got = r["out"].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", PER_SHARD_NAMES)
def test_per_shard_statistics_fail_the_eval_check(runs, name):
    """The sharded eval with each rank's BatchNorm statistics over its own
    shard is off JAX's sharded eval by more than BATCH_STATS_TOL."""
    case, ranks = runs[name]
    want = _jax_eval(case)
    for r in ranks:
        assert not np.allclose(r["out"].numpy(), want, rtol=BATCH_STATS_TOL,
                               atol=BATCH_STATS_TOL)


@pytest.mark.parametrize("name", EVAL_NAMES)
def test_sharded_eval_equals_one_rank(runs, name):
    """Every rank gets the whole output, equal to one port rank's forward
    of the batch padded as the sharded eval pads it, the padding cut off;
    the ranks' outputs are bit-equal to each other."""
    case, ranks = runs[name]
    net = worker.build_net(case)
    imgs = torch.from_numpy(case["imgs"])
    b = len(imgs)
    pad = (-b) % WORLD
    padded = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
    want = worker.eval_apply(case, net)(padded)[:, :b]
    tol = SELF_TOL[_batch_stats(case)]
    for r in ranks:
        torch.testing.assert_close(r["out"], want, rtol=tol, atol=tol)
        assert torch.equal(r["out"], ranks[0]["out"])


@pytest.mark.parametrize("name", EVAL_NAMES)
def test_each_rank_forwards_its_share(runs, name):
    """Each rank's net ran one forward of ceil(b / 2) rows (never the whole
    batch), and left its buffers (BatchNorm's running statistics) as they
    were."""
    case, ranks = runs[name]
    b = len(case["imgs"])
    for r in ranks:
        assert r["rows"] == [-(-b // WORLD)]
        assert r["buffers_kept"]


def _jax_pick(case, monkeypatch):
    """JAX's pick on the whole batches, and each sub-head's summed loss."""
    from iic_tpu.ops import iid_loss as jax_iid_loss

    jnet, variables = case["_jax"]
    state = create_train_state(variables, optax.sgd(0.1))
    losses = []
    real = jax_iid_loss.iid_loss_multihead

    def recorded(*a, **kw):
        out = real(*a, **kw)
        losses.append(np.asarray(out[2], np.float64))
        return out

    monkeypatch.setattr(jax_iid_loss, "iid_loss_multihead", recorded)

    class Pairs:
        def epoch(self, epoch_idx, augmented=False):
            assert augmented
            for imgs, tf in case["pairs"]:
                yield jnp.asarray(imgs), jnp.asarray(tf)

    config = SimpleNamespace(**case["cfg"], sobel=False, lamb_B=1.3)
    pick = jax_select_sub_head(config, jnet, state, Pairs(), 1.3,
                               mesh=jax_make_mesh(WORLD))
    return pick, np.sum(losses, axis=0)


def _pick_error(ranks, want):
    return max(float(np.abs(r["losses"] - want).max()) for r in ranks) \
        / float(np.abs(want).max())


def test_pick_equals_jax_whole_batch_pick(runs, monkeypatch):
    case, ranks = runs["pick"]
    pick, want = _jax_pick(case, monkeypatch)
    assert len(want) == case["cfg"]["num_sub_heads"]
    assert _pick_error(ranks, want) <= PICK_REL
    assert [r["pick"] for r in ranks] == [pick] * WORLD


def test_per_shard_statistics_fail_the_pick_check(runs, monkeypatch):
    """The pick with each rank's BatchNorm statistics over its own shard
    (the port before its BatchNorm moments were all-reduced) is off JAX's
    losses by more than PICK_REL."""
    case, ranks = runs["pick-per-shard"]
    _, want = _jax_pick(case, monkeypatch)
    assert _pick_error(ranks, want) > PICK_REL
