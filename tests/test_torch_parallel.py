"""The port's data parallelism (``iic_tpu_torch/parallel/mesh.py``) against
the JAX package's mesh, and against itself on one process.

JAX side: the JAX steps on a 2-device sub-mesh of the suite's 8 virtual
CPU devices (``tests/conftest.py``). Port side: 2 gloo ranks spawned from
the test (``tests/test_torch_parallel_worker.py``, which imports no JAX),
fed the same numpy inputs (made from a seed) and the same weights through
``compat/flax_bridge.py``. One spawn runs every step case; the tests read
its results. Each case compares the loss, the parameters' update and the
BatchNorm running statistics after one SGD step (SGD shows the gradient;
Adam would hide its scale).

The JAX package's global-mode gradient is the world size times the
gradient of its global loss: its psum of the joint transposes to a psum of
a cotangent every shard already holds. The port's is the global loss's
own (``parallel/mesh.py``), so a global-mode update is held to JAX's
divided by the world size; parity mode and semisup (pmean'd) carry no
factor. The port's own ranks are also held to one rank on the whole batch
(its step at ``mesh=None``), and a gradient averaged where it must be
summed fails that check."""

import pickle
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.models.semisup import SupHead5Head as JaxSupHead5Head
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel import make_cluster_train_step as jax_cluster_step
from iic_tpu.parallel import make_seg_train_step as jax_seg_step
from iic_tpu.parallel.mesh import make_mesh as jax_make_mesh
from iic_tpu.parallel.train_step import TrainState
from iic_tpu.parallel.train_step import (
    make_semisup_train_step as jax_semisup_step)
from iic_tpu.train import ClusterConfig as JaxClusterConfig
from iic_tpu.train.cluster_trainer import (
    adjust_batch_for_mesh as jax_adjust_batch)
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.cli import cluster_greyscale_twohead, segmentation_twohead
from iic_tpu_torch.compat.flax_bridge import (
    load_cluster_net, load_seg_net, load_sup_head)
from iic_tpu_torch.models.layers import SyncBatchNorm2d, sync_batch_norm
from iic_tpu_torch.models.semisup import SemisupNet, SupHead5Head
from iic_tpu_torch.parallel import mesh as mesh_lib
from iic_tpu_torch.train.config import ClusterConfig, SegConfig
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.cluster_trainer import adjust_batch_for_mesh
import test_torch_parallel_worker as worker
from test_torch_cluster_models import random_flax_variables
from test_torch_semisup import _head_variables

WORLD = 2
LR = 0.05
SZ_C, SZ_S, HALF_T = 16, 24, 2
# the loss against JAX's (f32 forwards in different op orders; measured
# at most 4.8e-7)
LOSS_TOL = 2e-6
# an update against JAX's, as a share of JAX's largest update entry
# (measured at most 3.4e-5; a global-mode update without the world-size
# factor is 0.5 off)
UPDATE_TOL = 2e-4
# BatchNorm's running statistics against JAX's
STAT_RTOL, STAT_ATOL = 1e-4, 1e-5
# 2 port ranks against 1 port rank: losses, gradients and parameters, as a
# share of the largest entry of each tensor kind (measured at most 2e-5;
# gradients averaged in global mode are 0.5 off)
SELF_TOL = 1e-4
# a spawn of gloo ranks that outlives this fails its test
SPAWN_TIMEOUT = 600


def _cluster_cfg(bn_sync=False, arch="ClusterNet6cTwoHead"):
    return dict(arch=arch, in_channels=1, output_k=3, output_k_A=7,
                output_k_B=3, num_sub_heads=2, input_sz=SZ_C,
                batchnorm_track=True,
                bn_axis_name="data" if bn_sync else None)


def _seg_cfg(bn_sync=False):
    return dict(in_channels=5, output_k_A=5, output_k_B=3, num_sub_heads=2,
                input_sz=SZ_S, batchnorm_track=True,
                bn_axis_name="data" if bn_sync else None)


def _cluster_batch(seed, b=8, pad=0):
    """Pre-augmented grey pairs; the last ``pad`` rows repeat the last
    valid one and weigh 0, as the sharded pipelines pad."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((b, 1, SZ_C, SZ_C)).astype(np.float32)
    tf = np.clip(imgs + 0.1 * rng.standard_normal(imgs.shape), 0, 1)
    batch = {"imgs": imgs, "imgs_tf": tf.astype(np.float32)}
    if pad:
        for k in batch:
            batch[k][b - pad:] = batch[k][b - pad - 1]
        batch["weights"] = (np.arange(b) < b - pad).astype(np.float32)
    return batch


def _seg_batch(seed, b=4, pad=0):
    """Pre-augmented seg batches (img1, img2 rgb + grey, affine2_to_1,
    mask); the last ``pad`` rows repeat the last valid one with zeroed
    masks, as the sharded pipeline pads."""
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, 4, SZ_S, SZ_S)).astype(np.float32)
    img2 = np.clip(img1 + 0.1 * rng.standard_normal(img1.shape), 0,
                   1).astype(np.float32)
    a = np.radians(rng.uniform(-15, 15, b))
    aff = np.zeros((b, 2, 3), np.float32)
    aff[:, 0, 0], aff[:, 0, 1] = np.cos(a), -np.sin(a)
    aff[:, 1, 0], aff[:, 1, 1] = np.sin(a), np.cos(a)
    aff[0, 0] *= -1.0
    mask = (rng.random((b, SZ_S, SZ_S)) > 0.1).astype(np.float32)
    batch = {"img1": img1, "img2": img2, "affine": aff, "mask": mask}
    if pad:
        for k in batch:
            batch[k][b - pad:] = batch[k][b - pad - 1]
        batch["mask"][b - pad:] = 0.0
    return batch


# ------------------------------------------------------------ the cases

def _cluster_case(name, joint_mode="global", pad=0, bn_sync=False, seed=0,
                  head="B", opt="sgd"):
    cfg = _cluster_cfg(bn_sync)
    jnet = jmodels.build(cfg["arch"], SimpleNamespace(**cfg))
    # the variables' tree from the unsynced net (a synced net's init runs
    # its pmean outside a mesh)
    variables = random_flax_variables(
        jmodels.build(cfg["arch"], SimpleNamespace(**_cluster_cfg())), 1,
        seed=seed, head_std=0.1, sz=SZ_C)
    tnet = load_cluster_net(variables, tmodels.build(
        cfg["arch"], SimpleNamespace(**cfg)))
    return dict(name=name, kind="cluster", arch=cfg["arch"], cfg=cfg,
                state=tnet.state_dict(), batch=_cluster_batch(seed, pad=pad),
                joint_mode=joint_mode, bn_sync=bn_sync, lamb=1.3, head=head,
                opt=opt, lr=LR if opt == "sgd" else 1e-3,
                _jax=(jnet, variables))


def _seg_case(name, uncollapsed, pad=0, bn_sync=False, seed=1,
              joint_mode="global", head="A", opt="sgd"):
    cfg = _seg_cfg(bn_sync)
    arch = "SegmentationNet10aTwoHead"
    jnet = jmodels.build(arch, SimpleNamespace(**cfg))
    variables = random_flax_variables(
        jmodels.build(arch, SimpleNamespace(**_seg_cfg())), 5, seed=seed,
        head_std=0.1, sz=SZ_S)
    tnet = load_seg_net(variables, tmodels.build(arch,
                                                 SimpleNamespace(**cfg)))
    return dict(name=name, kind="seg", arch=arch, cfg=cfg,
                state=tnet.state_dict(), batch=_seg_batch(seed, pad=pad),
                uncollapsed=uncollapsed, joint_mode=joint_mode,
                bn_sync=bn_sync, lamb=1.5, head=head, half_t=HALF_T, opt=opt,
                lr=LR if opt == "sgd" else 1e-3, _jax=(jnet, variables))


def _semisup_models(seed):
    cfg = _cluster_cfg(arch="ClusterNet6c")
    cfg["output_k"] = 7
    jnet = jmodels.build("ClusterNet6c", SimpleNamespace(**cfg))
    tvars = random_flax_variables(jnet, 1, heads=None, seed=seed,
                                  head_std=0.1, sz=SZ_C)
    dlen = 512 * (SZ_C // 8) ** 2
    hvars = _head_variables(dlen, 10, seed=seed, k2=0.05)
    return cfg, jnet, tvars, hvars, dlen


def _semisup_model(cfg, tvars, hvars, dlen):
    return SemisupNet(load_cluster_net(tvars, tmodels.build(
        "ClusterNet6c", SimpleNamespace(**cfg))),
        load_sup_head(hvars, SupHead5Head(dlen, 10)))


def _semisup_case(name, seed=2, pad=0):
    cfg, jnet, tvars, hvars, dlen = _semisup_models(seed)
    rng = np.random.default_rng(seed)
    imgs = rng.random((8, 1, SZ_C, SZ_C)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int64)
    if pad:
        imgs[8 - pad:] = imgs[7 - pad]
        labels[8 - pad:] = -100  # data.semisup.PAD_LABEL
    return dict(name=name, kind="semisup", arch="ClusterNet6c", cfg=cfg,
                gt_k=10, state=_semisup_model(cfg, tvars, hvars,
                                              dlen).state_dict(),
                batch={"imgs": imgs, "labels": labels}, opt="sgd", lr=LR,
                _jax=(jnet, tvars, hvars, dlen))


def _cases():
    return [
        _cluster_case("cluster-global"),
        _cluster_case("cluster-weighted-ragged", pad=3, seed=3),
        _cluster_case("cluster-parity", joint_mode="parity", seed=4),
        _cluster_case("cluster-bn-sync", bn_sync=True, seed=5, head="A"),
        _seg_case("seg-uncollapsed-padded", True, pad=1),
        _seg_case("seg-collapsed", False, seed=6, head="B"),
        _seg_case("seg-uncollapsed-bn-sync", True, bn_sync=True, seed=7),
        _semisup_case("semisup"),
        # the port against itself
        _cluster_case("self-cluster-bn-sync", bn_sync=True, seed=8),
        _seg_case("self-seg-bn-sync", True, bn_sync=True, seed=9),
        _semisup_case("self-semisup-padded", seed=10, pad=3),
    ]


def _mutant(case):
    """``case`` with its global-mode gradients averaged over ranks."""
    return dict(case, name=case["name"] + "-mean-grads",
                grad_reduction={"global": "mean"})


@pytest.fixture(scope="module")
def runs():
    """Every case through 2 spawned gloo ranks in one spawn (the cases
    without their JAX halves), and the mutant of the first self case."""
    cases = _cases()
    cases.append(_mutant(cases[-3]))
    shipped = [{k: v for k, v in c.items() if k != "_jax"} for c in cases]
    ranks = mesh_lib.spawn(worker.run_cases, WORLD, args=(shipped,),
                           device_type="cpu", timeout=SPAWN_TIMEOUT)
    return {c["name"]: (c, [r[i] for r in ranks])
            for i, c in enumerate(cases)}


# ----------------------------------------------------------- JAX halves

JMESH = None


def _jmesh():
    global JMESH
    if JMESH is None:
        JMESH = jax_make_mesh(WORLD)
    return JMESH


def _jax_cluster(case):
    jnet, variables = case["_jax"]
    batch = case["batch"]
    tx = optax.sgd(case["lr"])
    weighted = "weights" in batch
    step = jax_cluster_step(jnet, tx, lambda x, key: (x[:, 0], x[:, 1]),
                            lamb=case["lamb"], head=case["head"],
                            mesh=_jmesh(), joint_mode=case["joint_mode"],
                            weighted=weighted)
    stacked = jnp.asarray(np.stack([batch["imgs"], batch["imgs_tf"]], 1))
    b = (stacked, jnp.asarray(batch["weights"])) if weighted else stacked
    new, loss, loss_nl = step(create_train_state(variables, tx), b,
                              jax.random.PRNGKey(0))
    after = jax.device_get({"params": new.params,
                            "batch_stats": new.batch_stats})
    tnet = load_cluster_net(after, tmodels.build(
        case["arch"], SimpleNamespace(**case["cfg"])))
    return float(loss), float(loss_nl), tnet.state_dict()


def _jax_seg(case):
    jnet, variables = case["_jax"]
    tx = optax.sgd(case["lr"])
    step = jax_seg_step(jnet, tx, lamb=case["lamb"], head=case["head"],
                        half_T_side_dense=HALF_T, half_T_side_sparse_min=0,
                        half_T_side_sparse_max=0, sobel=True,
                        include_rgb=True,
                        use_uncollapsed_loss=case["uncollapsed"],
                        warp_impl="gather", joint_impl="conv",
                        mesh=_jmesh(), joint_mode=case["joint_mode"])
    b = tuple(jnp.asarray(case["batch"][k])
              for k in ("img1", "img2", "affine", "mask"))
    new, loss, loss_nl = step(create_train_state(variables, tx), b,
                              jax.random.PRNGKey(0))
    after = jax.device_get({"params": new.params,
                            "batch_stats": new.batch_stats})
    tnet = load_seg_net(after, tmodels.build(case["arch"],
                                             SimpleNamespace(**case["cfg"])))
    return float(loss), float(loss_nl), tnet.state_dict()


def _jax_semisup(case):
    """The JAX trainer's forward (trunk features, then the head) through
    ``make_semisup_train_step`` on the mesh, SGD on both parts."""
    jnet, tvars, hvars, dlen = case["_jax"]
    jhead = JaxSupHead5Head(gt_k=10)

    def forward(params, batch_stats, imgs, train):
        feats, upd_t = jnet.apply(
            {"params": params["trunk"], "batch_stats": batch_stats["trunk"]},
            imgs, train=train, trunk_features=True, mutable=["batch_stats"])
        logits, upd_h = jhead.apply(
            {"params": params["head"], "batch_stats": batch_stats["head"]},
            feats, train=train, mutable=["batch_stats"])
        return logits, {"trunk": upd_t["batch_stats"],
                        "head": upd_h["batch_stats"]}

    tx = optax.sgd(case["lr"])
    params = {"trunk": tvars["params"], "head": hvars["params"]}
    state = TrainState(params=params, opt_state=tx.init(params),
                       batch_stats={"trunk": tvars["batch_stats"],
                                    "head": hvars["batch_stats"]},
                       step=jnp.zeros((), jnp.int32))
    step = jax_semisup_step(forward, lambda imgs, key: imgs, tx,
                            mesh=_jmesh())
    new, loss = step(state, (jnp.asarray(case["batch"]["imgs"]),
                             jnp.asarray(case["batch"]["labels"])),
                     jax.random.PRNGKey(0))
    new = jax.device_get(new)
    model = _semisup_model(
        case["cfg"],
        {"params": new.params["trunk"],
         "batch_stats": new.batch_stats["trunk"]},
        {"params": new.params["head"], "batch_stats": new.batch_stats["head"]},
        dlen)
    return float(loss), None, model.state_dict()


JAX_HALF = {"cluster": _jax_cluster, "seg": _jax_seg,
            "semisup": _jax_semisup}


def _params(case):
    net = worker._net(case, None)
    return [k for k, _ in net.named_parameters()]


def _assert_close_to_jax(case, ranks):
    """Every rank's loss, parameter update (times the world size in
    global mode: JAX's gradient is the world size times the port's) and
    running statistics against JAX's 2-device step."""
    loss, loss_nl, jstate = JAX_HALF[case["kind"]](case)
    init = case["state"]
    names = _params(case)
    scale = (WORLD if case["kind"] != "semisup"
             and case["joint_mode"] == "global" else 1)
    jmax = max(float((jstate[k] - init[k]).abs().max()) for k in names)
    assert jmax > 0
    for got in ranks:
        assert abs(got["loss"] - loss) <= LOSS_TOL, (got["loss"], loss)
        if loss_nl is not None:
            assert abs(got["loss_nl"] - loss_nl) <= LOSS_TOL
        for k in names:
            d_port = (got["state"][k] - init[k]) * scale
            d_jax = jstate[k] - init[k]
            err = float((d_port - d_jax).abs().max())
            assert err <= UPDATE_TOL * jmax, (k, err, jmax)
        for k, v in jstate.items():
            if "running" in k:
                np.testing.assert_allclose(got["state"][k].numpy(),
                                           v.numpy(), rtol=STAT_RTOL,
                                           atol=STAT_ATOL, err_msg=k)
    # the ranks hold one replicated state
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


@pytest.mark.parametrize("name", [
    "cluster-global", "cluster-weighted-ragged", "cluster-parity",
    "cluster-bn-sync", "seg-uncollapsed-padded", "seg-collapsed",
    "seg-uncollapsed-bn-sync", "semisup"])
def test_two_ranks_match_jax_two_device_step(runs, name):
    """Tolerances: loss within LOSS_TOL, each parameter's update within
    UPDATE_TOL of JAX's largest update entry, the running statistics within
    rtol 1e-4 / atol 1e-5. Covers global mode (the weighted ragged batch
    held to JAX's ``weighted=True`` step; the padded seg batch with zeroed
    masks), parity mode (JAX's per-shard mean), ``--bn_sync`` against the
    JAX nets built with ``bn_axis_name``, both seg losses and the semisup
    step."""
    case, ranks = runs[name]
    _assert_close_to_jax(case, ranks)


def _self_errors(case, ranks):
    """The largest difference of a rank's step from one process's step on
    the whole batch, as a share of the largest entry: loss, gradients,
    parameters, running statistics."""
    ref = worker.run_case(case, None)
    errs = {"loss": abs(ranks[0]["loss"] - ref["loss"])
            / max(abs(ref["loss"]), 1e-6)}
    for kind, key, pick in (("grads", "grads", lambda k: True),
                            ("params", "state",
                             lambda k: "running" not in k
                             and "num_batches" not in k),
                            ("stats", "state", lambda k: "running" in k)):
        pairs = [(r[key][k], v) for r in ranks for k, v in ref[key].items()
                 if pick(k)]
        big = max(float(v.abs().max()) for _, v in pairs)
        errs[kind] = max(float((g - v).abs().max()) for g, v in pairs) / big
    return errs


@pytest.mark.parametrize("name", ["self-cluster-bn-sync",
                                  "self-seg-bn-sync"])
def test_two_ranks_equal_one_rank_on_the_whole_batch(runs, name):
    """Global mode with --bn_sync on a full batch, one SGD step: 2 ranks
    equal 1 rank on the whole batch within SELF_TOL of each kind's largest
    entry (loss, reduced gradients, parameters, running statistics)."""
    case, ranks = runs[name]
    errs = _self_errors(case, ranks)
    assert max(errs.values()) <= SELF_TOL, errs


def _semisup_restated(case):
    """The 2-rank semisup step restated in one process: each shard's
    forward on its own (BatchNorm on its own rows, the semisup nets are not
    synced), the cross-entropy summed over the valid rows of both and
    divided by their count, one backward. Returns (loss, gradients)."""
    model = worker._net(case, None)
    model.train()
    imgs = torch.from_numpy(case["batch"]["imgs"])
    labels = torch.from_numpy(case["batch"]["labels"])
    count = (labels != -100).sum()
    half = len(imgs) // WORLD
    loss = sum(torch.nn.functional.cross_entropy(
        model(imgs[r * half:(r + 1) * half]), labels[r * half:(r + 1) * half],
        reduction="sum") for r in range(WORLD)) / count
    loss.backward()
    return loss.item(), {k: p.grad.detach()
                         for k, p in model.named_parameters()
                         if p.grad is not None}


def test_semisup_padding_rows_weigh_nothing(runs):
    """The semisup step on a batch whose last 3 rows are padding
    (labelled -100): each rank's loss is the global batch's mean
    cross-entropy over the 5 valid rows and its reduced gradient the sum of
    both shards' (the step restated in one process, within SELF_TOL of
    the largest entry)."""
    case, ranks = runs["self-semisup-padded"]
    loss, grads = _semisup_restated(case)
    big = max(float(g.abs().max()) for g in grads.values())
    for got in ranks:
        assert abs(got["loss"] - loss) <= SELF_TOL * abs(loss)
        assert set(got["grads"]) == set(grads)
        for k, g in grads.items():
            assert float((got["grads"][k] - g).abs().max()) <= SELF_TOL * big


def test_averaged_gradients_fail_the_one_rank_check(runs):
    """The check has teeth: the same 2-rank step with its global-mode
    gradients averaged (as plain DDP would) leaves the 1-rank gradients by
    half of them, far outside SELF_TOL; its loss is unchanged."""
    case, ranks = runs["self-cluster-bn-sync-mean-grads"]
    errs = _self_errors(case, ranks)
    assert errs["loss"] <= SELF_TOL
    assert errs["grads"] > 100 * SELF_TOL, errs


# ------------------------------------------------ sync BN and the helpers

def test_sync_batch_norm_without_a_mesh_is_the_jax_batch_norm():
    """``SyncBatchNorm2d`` without a mesh (its formula on one rank's rows,
    var = E[x^2] - E[x]^2) against the JAX ``BatchNorm`` of a bridged net:
    a train-mode forward within rtol 1e-4 / atol 1e-5 and its running
    statistics; eval forwards are ``nn.BatchNorm2d``'s; the state_dict keys
    are unchanged."""
    cfg = _cluster_cfg()
    jnet = jmodels.build(cfg["arch"], SimpleNamespace(**cfg))
    variables = random_flax_variables(jnet, 1, seed=11, head_std=0.1,
                                      sz=SZ_C)
    plain = load_cluster_net(variables, tmodels.build(
        cfg["arch"], SimpleNamespace(**cfg)))
    keys = list(plain.state_dict())
    net = sync_batch_norm(load_cluster_net(variables, tmodels.build(
        cfg["arch"], SimpleNamespace(**cfg))), None)
    assert list(net.state_dict()) == keys
    assert any(isinstance(m, SyncBatchNorm2d) for m in net.modules())
    x = _cluster_batch(11)["imgs"]
    ref, upd = jnet.apply(variables, jnp.asarray(x), head="B", train=True,
                          mutable=["batch_stats"])
    net.train()
    got = net(torch.from_numpy(x), head="B")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    bridged = load_cluster_net(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]},
        tmodels.build(cfg["arch"], SimpleNamespace(**cfg))).state_dict()
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), bridged[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    net.eval()
    plain.load_state_dict(net.state_dict())
    plain.eval()
    with torch.no_grad():
        assert torch.equal(net(torch.from_numpy(x)), plain(
            torch.from_numpy(x)))


@pytest.mark.parametrize("batch_sz,num_dataloaders,n,want,sharded", [
    (660, 3, 8, 648, True), (640, 2, 8, 640, True), (660, 3, None, 660,
                                                     False),
    (36, 2, 8, 32, True), (12, 3, 8, 24, True), (700, 5, 1, 700, False)])
def test_adjust_batch_for_mesh_matches_jax(batch_sz, num_dataloaders, n,
                                           want, sharded):
    """tests/test_mesh_batch_adjust.py's cases (and a base batch below the
    mesh, raised to one row a rank): the port's rounding equals JAX's."""
    got = ClusterConfig(batch_sz=batch_sz, num_dataloaders=num_dataloaders,
                        n_devices=n)
    got.finalize()
    ref = JaxClusterConfig(batch_sz=batch_sz,
                           num_dataloaders=num_dataloaders, n_devices=n)
    ref.finalize()
    assert adjust_batch_for_mesh(got) == jax_adjust_batch(ref) == sharded
    assert (got.batch_sz, got.dataloader_batch_sz) == (
        ref.batch_sz, ref.dataloader_batch_sz)
    assert got.batch_sz == want


def _pipe_cfg():
    cfg = ClusterConfig(dataset="Synthetic6x24x1x52", dataset_root="",
                        mode="IID", batch_sz=16, num_dataloaders=2,
                        input_sz=20, gt_k=6, output_k_A=12, output_k_B=6,
                        num_sub_heads=1, crop_orig=True, crop_other=True,
                        tf1_crop="centre", tf1_crop_sz=20, tf2_crop="random",
                        tf2_crop_szs=(20,), no_flip=True, no_jitter=True)
    cfg.finalize(twohead=True, sobel=False)
    return cfg


@pytest.mark.parametrize("drop_last", [False, True])
def test_cluster_pipeline_shards_tile_the_global_batch(drop_last):
    """tests/test_multihost.py's check for the port: two ranks' shards
    concatenate to the one-process batch (52 images at 8 a batch: a ragged
    last batch of 4), with weights 1; the ragged batch is padded with its
    last image weighted 0, or dropped under ``drop_last``; each rank draws
    its own generator."""
    from iic_tpu_torch.data.pipeline import ClusterTrainPipeline
    cfg = _pipe_cfg()
    full = ClusterTrainPipeline(cfg, [True])
    shards = [ClusterTrainPipeline(cfg, [True], process_shard=(r, 2),
                                   drop_last=drop_last) for r in range(2)]
    want = list(full.epoch(0))
    got = [list(p.epoch(0)) for p in shards]
    assert len(want) == 7 and len(got[0]) == (6 if drop_last else 7)
    for b_i, ((b0, w0), g0), ((b1, w1), g1) in zip(range(7), *got):
        base, _ = want[b_i]
        n = len(base)
        glued = torch.cat([b0, b1])
        assert torch.equal(glued[:n], base)
        assert torch.equal(torch.cat([w0, w1]),
                           (torch.arange(8) < n).float())
        if n < 8:
            assert torch.equal(glued[n:], base[-1:].expand(8 - n, -1, -1,
                                                           -1))
        assert not torch.equal(torch.rand(4, generator=g0),
                               torch.rand(4, generator=g1))


def test_seg_pipeline_shards_tile_the_global_batch():
    """tests/test_multihost.py's seg check: the global order is the same
    on both ranks, each preps its contiguous sub-block (images equal to the
    one-process batch where the host geometry is deterministic); a ragged
    batch is padded to the full batch with zeroed masks; ``r`` repeats are
    sharded after repeating."""
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
    cfg = SimpleNamespace(
        dataset="SyntheticSeg3x48x10", dataset_root="", mode="IID",
        batch_sz=8, num_dataloaders=2, dataloader_batch_sz=4, input_sz=48,
        gt_k=3, output_k_A=6, output_k_B=3, num_sub_heads=1,
        use_coarse_labels=False, pre_scale_all=False, pre_scale_factor=0.5,
        use_random_scale=False, scale_min=0.8, scale_max=1.2,
        jitter_brightness=0.4, jitter_contrast=0.4, jitter_saturation=0.4,
        jitter_hue=0.125, flip_p=0.5, use_random_affine=False, sobel=True,
        no_sobel=False, include_rgb=True, using_IR=False,
        batchnorm_track=True, half_T_side_dense=1,
        half_T_side_sparse_min=0, half_T_side_sparse_max=0)
    full = SegTrainPipeline(cfg, ["train"], use_native=False)
    shards = [SegTrainPipeline(cfg, ["train"], use_native=False,
                               process_shard=(r, 2)) for r in range(2)]
    want = list(full.epoch(0))
    got = [list(p.epoch(0)) for p in shards]
    assert len(want) == len(got[0]) == 3  # 10 images at 4: ragged 2
    for (fi, fm, _), (i0, m0, _), (i1, m1, _) in zip(want, *got):
        assert i0.shape[0] == i1.shape[0] == 4
        imgs, masks = torch.cat([i0, i1]), torch.cat([m0, m1])
        n = len(fi) // 2  # valid rows a repeat
        for rep in range(2):
            rows = slice(rep * 4, rep * 4 + n)
            assert torch.equal(imgs[rows], fi[rep * n:(rep + 1) * n])
            assert torch.equal(masks[rows], fm[rep * n:(rep + 1) * n])
            assert not masks[rep * 4 + n:(rep + 1) * 4].any()


def test_semisup_loader_shards_pad_with_ignored_labels():
    """The semisup loader's shards tile its one-process batches; a ragged
    last batch is padded with its last image labelled -100 (cross-entropy's
    ignore_index)."""
    from iic_tpu_torch.data.semisup import PAD_LABEL, SemisupTrainLoader
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (11, 8, 8, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 11)
    full = SemisupTrainLoader(imgs, labels, 4, seed=3)
    shards = [SemisupTrainLoader(imgs, labels, 4, seed=3,
                                 process_shard=(r, 2)) for r in range(2)]
    for (fi, fl, _), (i0, l0, _), (i1, l1, _) in zip(
            full.epoch(1), *(s.epoch(1) for s in shards)):
        n = len(fi)
        assert torch.equal(torch.cat([i0, i1])[:n], fi)
        assert torch.equal(torch.cat([l0, l1])[:n], fl)
        assert (torch.cat([l0, l1])[n:] == PAD_LABEL).all()
    assert PAD_LABEL == -100


def test_save_epoch_writes_nothing_off_rank_0(tmp_path):
    """Ranks other than 0 write no checkpoint, plots.png or config.pickle,
    and report the same epoch of the latest weights as rank 0."""
    cfg = SegConfig(out_root=str(tmp_path), model_ind=3, save_freq=2,
                    num_epochs=10)
    net = torch.nn.Linear(2, 2)
    opt = torch.optim.Adam(net.parameters())
    hist = {"eval": SimpleNamespace(epoch_acc=[], epoch_avg_subhead_acc=[]),
            **{f"{a}{h}": [] for a in ("epoch_loss_head_",
                                       "epoch_loss_no_lamb_head_")
               for h in "AB"}}
    assert ckpt.save_epoch(cfg, net, opt, hist, 4, True, 2, write=False) == 4
    assert not (tmp_path / "3").exists() or not any(
        (tmp_path / "3").iterdir())
    assert ckpt.save_epoch(cfg, net, opt, hist, 5, True, 4, write=True) == 4
    assert {p.name for p in (tmp_path / "3").iterdir()} >= {
        "best.pytorch", "config.pickle"}


GREY_CLI = ["--arch", "ClusterNet6cTwoHead", "--mode", "IID",
            "--dataset", "Synthetic3x28x1x4", "--gt_k", "3",
            "--output_k_A", "6", "--output_k_B", "3", "--lamb_A", "1.0",
            "--lamb_B", "1.0", "--lr", "0.0001", "--num_epochs", "3",
            "--batch_sz", "18", "--num_dataloaders", "3",
            "--num_sub_heads", "2", "--crop_orig", "--crop_other",
            "--tf1_crop", "centre_half", "--tf2_crop", "random",
            "--tf1_crop_sz", "20", "--tf2_crop_szs", "16", "20", "24",
            "--input_sz", "24", "--rot_val", "25", "--no_flip",
            "--batchnorm_track", "--save_freq", "1", "--n_devices", "2"]


def test_two_rank_cli_trains_saves_on_rank_0_and_restarts(tmp_path):
    """``--n_devices 2`` on the CPU (gloo): the greyscale two-head CLI
    spawns 2 ranks and trains two epochs (a base batch of 6, 16 images: a
    ragged last batch of 4 padded and weighted 0), rank 0's
    history comes back, the run directory holds its files; ``--restart``
    resumes at epoch 3 in 2 ranks again and writes epoch 3's."""
    argv = GREY_CLI + ["--out_root", str(tmp_path),
                       "--select_sub_head_on_loss", "--bn_sync"]
    net, history = cluster_greyscale_twohead.main(argv, device="cpu")
    assert len(history["eval"].epoch_acc) == 3  # pre-train, epochs 1, 2
    for head in "AB":
        assert np.isfinite(history[f"epoch_loss_head_{head}"]).all()
        assert len(history[f"epoch_loss_head_{head}"]) == 2
    assert next(net.parameters()).device.type == "cpu"
    run = tmp_path / "0"
    assert {"latest.pytorch", "config.pickle", "config.txt"} <= {
        p.name for p in run.iterdir()}
    with open(run / "config.pickle", "rb") as f:
        meta = pickle.load(f)
    assert meta["last_epoch"] == 2 and meta["config"]["n_devices"] == 2
    saved = torch.load(run / "latest.pytorch", weights_only=True)["net"]
    for k, v in net.state_dict().items():
        assert torch.equal(v, saved[k]), k

    _, again = cluster_greyscale_twohead.main(
        GREY_CLI[:-4] + ["--num_epochs", "4", "--save_freq", "1",
                         "--n_devices", "2", "--out_root", str(tmp_path),
                         "--restart", "--bn_sync"], device="cpu")
    assert len(again["eval"].epoch_acc) == 4
    assert again["epoch_loss_head_A"][:2] == history["epoch_loss_head_A"]
    with open(run / "config.pickle", "rb") as f:
        assert pickle.load(f)["last_epoch"] == 3


SEG_CLI = ["--mode", "IID", "--dataset", "SyntheticSeg3x48x10",
           "--dataset_root", "", "--arch", "SegmentationNet10aTwoHead",
           "--lamb_A", "1.0", "--lamb_B", "1.5", "--num_sub_heads", "1",
           "--batch_sz", "4", "--num_dataloaders", "1", "--output_k_A", "5",
           "--output_k_B", "3", "--gt_k", "3", "--input_sz", "32",
           "--half_T_side_sparse_min", "0", "--half_T_side_sparse_max", "0",
           "--half_T_side_dense", "2", "--include_rgb",
           "--use_uncollapsed_loss", "--batchnorm_track", "--num_epochs", "2",
           "--joint_mode", "parity", "--n_devices", "2"]


def test_only_rank_0_writes_the_run(tmp_path):
    """2 ranks of the seg CLI in parity mode (10 images at 4: the ragged
    batch dropped, 2 steps a head pass), each counting its writes: rank 0
    writes the checkpoints, plots and config.pickle, rank 1 nothing; both
    log the same losses."""
    results = mesh_lib.spawn(
        worker.count_writes, 2,
        args=(segmentation_twohead.main,
              SEG_CLI + ["--out_root", str(tmp_path)]), device_type="cpu",
        timeout=SPAWN_TIMEOUT)
    (r0, n0, h0), (r1, n1, h1) = results
    assert (r0, r1) == (0, 1)
    assert n0 >= 3 and n1 == 0
    assert len(h0["step_seconds_head_A"]) == 2
    assert h0["epoch_loss_head_A"] == h1["epoch_loss_head_A"]
    assert (tmp_path / "0" / "latest.pytorch").exists()


def test_n_devices_past_the_visible_cards_raises():
    """``--n_devices`` CUDA ranks beyond the visible cards raise before
    any process starts, as the JAX ``make_mesh`` raises."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="visible"):
        mesh_lib.check_visible(n)
    with pytest.raises(ValueError, match="process group"):
        mesh_lib.make_mesh(2)


def test_a_rank_that_raises_or_hangs_fails_the_spawn():
    """A rank that raises fails ``spawn`` with its error; ranks still
    running at the deadline are stopped and ``spawn`` raises."""
    with pytest.raises(Exception, match="rank 0 fails"):
        mesh_lib.spawn(worker.fail, 1, device_type="cpu",
                       timeout=SPAWN_TIMEOUT)
    with pytest.raises(TimeoutError, match="still running"):
        mesh_lib.spawn(worker.hang, 1, device_type="cpu", timeout=3)
