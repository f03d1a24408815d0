"""The port in ``model_dtype="bfloat16"`` against the JAX package's bf16
nets and steps: SegmentationNet10aTwoHead and ClusterNet5gTwoHead forwards
(train- and eval-mode BN) and parameter gradients, a four-step (A, B, A,
B) segmentation lockstep and a two-step clustering lockstep. Weights are
carried across by ``iic_tpu_torch/compat/flax_bridge.py``; inputs come
from numpy seeds.

The JAX reference runs jitted with XLA's ``xla_allow_excess_precision``
off: with it on (the default), XLA's CPU backend may keep a fused bf16
value in f32, so some of the bf16 roundings the nets ask for are skipped.
Off, every bf16 value is rounded, as the port's are.

bf16 results of two implementations agree only to bf16's precision: a
rounding that falls the other way in one layer moves the next layer's
values by an ulp, and by the last layer most values differ by one. So each
bound here sits between the port's bf16 error and its f32 error against
the same JAX bf16 run, and every bound has a case showing that the f32
port fails it: the bound tells bf16 from f32. Errors measured on the CPU
are written beside each bound (bf16 port / f32 port)."""

import copy
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.models.residual import BasicBlock
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel import make_cluster_train_step as jax_cluster_step
from iic_tpu.parallel import make_seg_train_step as jax_seg_step
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import load_cluster_net, load_seg_net
from iic_tpu_torch.parallel.train_step import (
    make_cluster_train_step, make_optimizer, make_seg_train_step)
from test_torch_cluster_models import cluster_cfg, random_flax_variables
from test_torch_cluster_train import _batches as cluster_batches
from test_torch_train import HALF_T, _batches as seg_batches

SEG_SZ = 24
DTYPES = ("bfloat16", "float32")

# (mean |d|, max |d|) of the softmax outputs against the JAX bf16 net
SEG_FWD = {True: (5.5e-4, 8e-3),    # train BN: 3.8e-4, 5.4e-3 / 7.7e-4, 1.2e-2
           False: (2.5e-4, 4.5e-3)}  # eval BN: 1.2e-4, 2.7e-3 / 4.7e-4, 7.6e-3
# mean |d| / mean |ref| of a ResNet block's output: 5e-8 to 4e-5 / 3.6e-3
# to 4.1e-3
CLUSTER_BLOCK = 2e-4
# |g - ref| / |ref| over every parameter gradient: 0.051 / 0.147
SEG_GRAD = 0.09
CLUSTER_BLOCK_GRAD = 0.015  # 0.0046 / 0.045
# |loss - JAX loss| at every step: 4.2e-4 / 8.5e-4
SEG_STEP = 6e-4
# the clustering lockstep's: 5.1e-3 at step 2 (the f32 port 4.2e-3); see
# test_cluster_lockstep_with_jax_bf16
CLUSTER_STEP = 1e-2


def _nominal(fn, *args):
    """``fn`` jitted, without XLA's excess precision, called on ``args``."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _seg_cfg(dtype, track=True):
    return SimpleNamespace(arch="SegmentationNet10aTwoHead", in_channels=5,
                           output_k_A=6, output_k_B=3, num_sub_heads=2,
                           input_sz=SEG_SZ, batchnorm_track=track,
                           model_dtype=dtype, opt="Adam", lr=1e-3)


@pytest.fixture(scope="module")
def seg():
    """The JAX bf16 net, its variables and the port's net in each dtype."""
    cfg = _seg_cfg("bfloat16")
    jnet = jmodels.build(cfg.arch, cfg)
    variables = jax.device_get(jmodels.init_variables(
        jnet, jax.random.PRNGKey(0), jnp.zeros((2, 5, SEG_SZ, SEG_SZ))))
    tnets = {dt: load_seg_net(variables,
                              tmodels.build(cfg.arch, _seg_cfg(dt)))
             for dt in DTYPES}
    return jnet, variables, tnets


@pytest.fixture(scope="module")
def cluster():
    cfg = cluster_cfg(True)
    cfg.model_dtype = "bfloat16"
    jnet = jmodels.build(cfg.arch, cfg)
    variables = random_flax_variables(jnet, cfg.in_channels, seed=1,
                                      head_std=0.1)
    tnets = {}
    for dt in DTYPES:
        tcfg = copy.copy(cfg)
        tcfg.model_dtype = dt
        tnets[dt] = load_cluster_net(variables,
                                     tmodels.build(cfg.arch, tcfg))
    return jnet, variables, tnets


def _jax_forward(jnet, variables, x, head, train):
    def fwd(v, x):
        if train:
            return jnet.apply(v, x, head=head, train=True,
                              mutable=["batch_stats"])[0]
        return jnet.apply(v, x, head=head, train=False)
    return np.asarray(_nominal(fwd, variables, jnp.asarray(x)))


def _torch_forward(tnet, x, head, train):
    tnet = copy.deepcopy(tnet)  # a train-mode forward updates its stats
    tnet.train(train)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x), head=head)
    assert out.dtype == torch.float32
    return out.numpy()


def _within(errs, bounds):
    return all(e <= b for e, b in zip(errs, bounds))


def _mean_max(got, ref):
    d = np.abs(got - ref)
    return float(d.mean()), float(d.max())


def _seg_x(seed=1, b=3):
    return np.random.default_rng(seed).standard_normal(
        (b, 5, SEG_SZ, SEG_SZ)).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("train", [True, False])
def test_seg_forward_matches_jax_bf16(seg, train, dtype):
    """Head A's softmax maps against the JAX bf16 net: the bf16 port
    within ``SEG_FWD`` (mean and max |d|), the f32 port outside it."""
    jnet, variables, tnets = seg
    x = _seg_x()
    ref = _jax_forward(jnet, variables, x, "A", train)
    got = _torch_forward(tnets[dtype], x, "A", train)
    errs = _mean_max(got, ref)
    print(f"seg forward train={train} {dtype}: {errs}")
    assert _within(errs, SEG_FWD[train]) == (dtype == "bfloat16"), errs


def _rel(got, ref):
    """|got - ref| / |ref| over matched lists of arrays."""
    num = sum(float(np.sum((np.float64(g) - r) ** 2))
              for g, r in zip(got, ref))
    den = sum(float(np.sum(np.float64(r) ** 2)) for r in ref)
    return float(np.sqrt(num / den))


def _grads(jnet, variables, tnet, load, x, head, names=None):
    """Parameter gradients of sum(out * R), R from a numpy seed, with
    train-mode BN: the JAX bf16 net's (carried into a torch net by the
    bridge) and ``tnet``'s, as lists of arrays in ``named_parameters``
    order, restricted to the names that start with one of ``names`` (by
    default the trunk's and ``head``'s: the other head gets none)."""
    names = names or ("trunk", f"head_{head}")
    def out(params, x):
        return jnet.apply({**variables, "params": params}, x, head=head,
                          train=True, mutable=["batch_stats"])[0]

    xj = jnp.asarray(x)
    shape = jax.eval_shape(out, variables["params"], xj).shape
    r = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    jg = jax.device_get(_nominal(
        jax.grad(lambda p, x: jnp.sum(out(p, x) * r)),
        variables["params"], xj))
    ref_net = load({**variables, "params": jg}, copy.deepcopy(tnet))
    tnet = copy.deepcopy(tnet)
    tnet.train()
    (tnet(torch.from_numpy(x), head=head) * torch.from_numpy(r)).sum() \
        .backward()
    got, ref = [], []
    for (name, p), q in zip(tnet.named_parameters(), ref_net.parameters()):
        if not name.startswith(names):
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        got.append(p.grad.numpy())
        ref.append(q.detach().numpy())
    return got, ref


@pytest.mark.parametrize("dtype", DTYPES)
def test_seg_gradients_match_jax_bf16(seg, dtype):
    """Every parameter's gradient (f32 in both dtypes) against the JAX bf16
    net's: the bf16 port within ``SEG_GRAD`` relative (0.087 measured), the
    f32 port outside it (0.14)."""
    jnet, variables, tnets = seg
    got, ref = _grads(jnet, variables, tnets[dtype], load_seg_net,
                      _seg_x(2), "A")
    err = _rel(got, ref)
    print(f"seg grads {dtype}: {err}")
    assert (err <= SEG_GRAD) == (dtype == "bfloat16"), err


# The first BasicBlock of each ResNet-34 layer: (layer, in channels,
# planes, stride, spatial size at model 640's 32x32 input)
BLOCKS = ((1, 64, 64, 1, 17), (2, 64, 128, 2, 17), (3, 128, 256, 2, 9),
          (4, 256, 512, 2, 5))


def _block_pair(cluster, layer, planes, stride, dtype):
    """The JAX bf16 BasicBlock with its variables, and the port's block
    in ``dtype`` (bridged with the whole net)."""
    jnet, variables, tnets = cluster
    sub = {col: variables[col]["ClusterNet5gTrunk_0"][
        f"ResNetLayer_{layer - 1}"]["BasicBlock_0"]
        for col in ("params", "batch_stats")}
    jblock = BasicBlock(planes=planes, stride=stride, dtype=jnp.bfloat16)
    return jblock, sub, getattr(tnets[dtype].trunk, f"layer{layer}")[0]


def _block_x(layer, cin, hw, b=8):
    """bf16 values (as f32 numpy, NCHW) from a numpy seed."""
    x = np.random.default_rng(layer).standard_normal((b, cin, hw, hw))
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _jax_block(jblock, sub, x, train, **kw):
    def fwd(s, x):
        x = jnp.transpose(x, (0, 2, 3, 1)).astype(jnp.bfloat16)
        if train:
            out = jblock.apply(s, x, train=True, mutable=["batch_stats"])[0]
        else:
            out = jblock.apply(s, x, train=False)
        return jnp.transpose(out.astype(jnp.float32), (0, 3, 1, 2))
    return fwd


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layer,cin,planes,stride,hw", BLOCKS)
def test_cluster_block_forward_matches_jax_bf16(cluster, layer, cin, planes,
                                                stride, hw, train, dtype):
    """ClusterNet5gTwoHead's bf16 trunk block by block: the first
    BasicBlock of each layer (convs, BN, the downsample, the residual add
    in bf16) on the same bf16 input as the JAX bf16 block. Mean |d| over
    mean |ref| within ``CLUSTER_BLOCK`` for the bf16 port, outside it for
    the f32 one.

    Block by block, because the whole ResNet-34 in bf16 is a chaotic
    function of its roundings: the JAX net jitted and the JAX net run op
    by op differ by 5e-2 in the softmax outputs, as much as either port
    differs from them, so no bound on the whole net's bf16 output tells
    bf16 from f32 (the segmentation net's six convs do not get there)."""
    jblock, sub, tblock = _block_pair(cluster, layer, planes, stride, dtype)
    x = _block_x(layer, cin, hw)
    ref = np.asarray(_nominal(_jax_block(jblock, sub, x, train), sub,
                              jnp.asarray(x)))
    tblock = copy.deepcopy(tblock)
    tblock.train(train)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    err = float(np.abs(got.float().numpy() - ref).mean()
                / np.abs(ref).mean())
    print(f"cluster block {layer} train={train} {dtype}: {err}")
    assert (err <= CLUSTER_BLOCK) == (dtype == "bfloat16"), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_block_gradients_match_jax_bf16(cluster, dtype):
    """Parameter gradients (f32) of sum(out * R) through layer 2's first
    block (its downsample included), train-mode BN, against the JAX bf16
    block's: the bf16 port within ``CLUSTER_BLOCK_GRAD`` relative, the
    f32 port outside it."""
    layer, cin, planes, stride, hw = BLOCKS[1]
    jblock, sub, tblock = _block_pair(cluster, layer, planes, stride, dtype)
    x = _block_x(layer, cin, hw)
    fwd = _jax_block(jblock, sub, x, True)
    shape = jax.eval_shape(fwd, sub, jnp.asarray(x)).shape
    r = np.random.default_rng(9).standard_normal(shape).astype(np.float32)

    def loss(params, x):
        return jnp.sum(fwd({**sub, "params": params}, x) * r)

    jg = jax.device_get(_nominal(jax.grad(loss), sub["params"],
                                 jnp.asarray(x)))
    tblock = copy.deepcopy(tblock)
    tblock.train()
    out = tblock(torch.from_numpy(x).to(getattr(torch, dtype)))
    (out.float() * torch.from_numpy(r)).sum().backward()
    # flax names: Conv_0/1 (conv1, conv2), Conv_2 (downsample),
    # BatchNorm_0/1/2 in the same order
    pairs = [(tblock.conv1.weight, jg["Conv_0"]["kernel"]),
             (tblock.conv2.weight, jg["Conv_1"]["kernel"]),
             (tblock.downsample[0].weight, jg["Conv_2"]["kernel"])]
    got = [p.grad.permute(2, 3, 1, 0).numpy() for p, _ in pairs]
    ref = [np.asarray(k) for _, k in pairs]
    for bn, name in ((tblock.bn1, "BatchNorm_0"), (tblock.bn2, "BatchNorm_1"),
                     (tblock.downsample[1], "BatchNorm_2")):
        got += [bn.weight.grad.numpy(), bn.bias.grad.numpy()]
        ref += [np.asarray(jg[name]["scale"]), np.asarray(jg[name]["bias"])]
    assert all(g.dtype == np.float32 for g in got)
    err = _rel(got, ref)
    print(f"cluster block grads {dtype}: {err}")
    assert (err <= CLUSTER_BLOCK_GRAD) == (dtype == "bfloat16"), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_seg_four_step_lockstep_with_jax_bf16(dtype):
    """Heads A, B, A, B (uncollapsed loss, conv joint) from the same weights
    on the same batches, in the form of test_torch_train's lockstep: the
    JAX bf16 step against the port's step, bf16 within ``SEG_STEP`` of
    its loss at every step, f32 outside it at some step."""
    cfg = _seg_cfg("bfloat16")
    jnet = jmodels.build(cfg.arch, cfg)
    variables = jmodels.init_variables(
        jnet, jax.random.PRNGKey(0), jnp.zeros((2, 5, SEG_SZ, SEG_SZ)))
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=cfg.lr)
    state = create_train_state(variables, tx)
    tnet = load_seg_net(jax.device_get(variables),
                        tmodels.build(cfg.arch, _seg_cfg(dtype)))
    opt = make_optimizer(tnet, cfg)
    common = dict(half_T_side_dense=HALF_T, half_T_side_sparse_min=0,
                  half_T_side_sparse_max=0, sobel=True, include_rgb=True,
                  use_uncollapsed_loss=True)
    lambs = {"A": 1.0, "B": 1.5}
    jsteps = {h: jax_seg_step(jnet, tx, lamb=lambs[h], head=h,
                              warp_impl="gather", joint_impl="conv",
                              **common) for h in "AB"}
    tsteps = {h: make_seg_train_step(tnet, opt, lamb=lambs[h], head=h,
                                     **common) for h in "AB"}
    key = jax.random.PRNGKey(0)
    diffs = []
    for head, batch in zip("ABAB", seg_batches(4)):
        jbatch = tuple(jnp.asarray(x) for x in batch)
        state, jloss, _ = _nominal(jsteps[head], state, jbatch, key)
        tloss, _ = tsteps[head](tuple(torch.from_numpy(x) for x in batch))
        diffs.append(abs(float(tloss) - float(jloss)))
    print(f"seg lockstep {dtype}: {diffs}")
    assert (max(diffs) <= SEG_STEP) == (dtype == "bfloat16"), diffs


def test_cluster_lockstep_with_jax_bf16(cluster):
    """Heads A, B with the plain loss from the same weights on the same
    pre-augmented batches (lr 1e-5, as in test_torch_cluster_train): the
    JAX bf16 step against the port's bf16 step, within ``CLUSTER_STEP``
    at every step.

    The one bound here that the f32 port meets too (4.2e-3): the whole
    ResNet-34's bf16 losses move with every rounding (see
    test_cluster_block_forward_matches_jax_bf16), so two bf16
    implementations differ by as much as bf16 and f32 do. The block tests
    are the ones that tell bf16 from f32 on this net; this one holds the
    whole step, heads and loss included, to the JAX step's size."""
    jnet, variables, _ = cluster
    cfg = cluster_cfg(True)
    cfg.model_dtype = "bfloat16"
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-5)
    state = create_train_state(variables, tx)
    tnet = load_cluster_net(variables, tmodels.build(cfg.arch, cfg))
    opt = make_optimizer(tnet, SimpleNamespace(opt="Adam", lr=1e-5))
    lambs = {"A": 1.0, "B": 1.3}
    jsteps = {h: jax_cluster_step(jnet, tx, lambda batch, key: batch,
                                  lamb=lambs[h], head=h, sobel=True)
              for h in "AB"}
    tsteps = {h: make_cluster_train_step(tnet, opt, None, lamb=lambs[h],
                                         head=h, sobel=True)
              for h in "AB"}
    key = jax.random.PRNGKey(0)
    diffs = []
    for head, batch in zip("AB", cluster_batches(2)):
        jbatch = tuple(jnp.asarray(x) for x in batch)
        state, jloss, _ = _nominal(jsteps[head], state, jbatch, key)
        tloss, _ = tsteps[head](tuple(torch.from_numpy(x) for x in batch))
        assert np.isfinite(float(tloss))
        diffs.append(abs(float(tloss) - float(jloss)))
    print(f"cluster lockstep: {diffs}")
    assert max(diffs) <= CLUSTER_STEP, diffs
