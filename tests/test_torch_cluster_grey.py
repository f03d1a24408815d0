"""The greyscale two-head clustering path and the readers of this slice,
the port against the JAX package:

- the greyscale transforms (rotation, the choice crop in its three modes,
  the centre-half crop, tf1, tf2, tf3) given the draws the JAX functions
  make from their keys, against those functions (atol ``ATOL``, as in
  test_torch_cluster_data.py); the port's draws' distributions beside
  JAX's; tf3 bit-stable;
- ``ClusterNet6c`` / ``ClusterNet6cTwoHead`` forwards and running
  statistics against the bridged JAX nets (f32 at rtol 1e-4 / atol 1e-5;
  bf16 as test_torch_bf16.py holds its nets);
- the MNIST, STL10 and Digits readers bit-equal to the JAX readers on
  written fixture trees, and the port's digits copy to scikit-learn's;
- the ``--mix_train`` order, the partition tables and the pipelines'
  uint8 batches against JAX's;
- a four-step lockstep of the greyscale two-head step with JAX for both
  loss implementations, and the greyscale two-head CLI on the CPU.

Images and weights are made from numpy seeds; the nets run at 24^2."""

import copy
import gzip
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy import stats

from iic_tpu import models as jmodels
from iic_tpu.data import pipeline as jpipe
from iic_tpu.data import readers as jreaders
from iic_tpu.data import transforms as jt
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel import make_cluster_train_step as jax_cluster_step
from iic_tpu.train.config import ClusterConfig as JaxClusterConfig
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.cli import cluster_greyscale_twohead
from iic_tpu_torch.compat.flax_bridge import _numbered, load_cluster_net
from iic_tpu_torch.data import pipeline as tpipe
from iic_tpu_torch.data import readers as treaders
from iic_tpu_torch.data import transforms as tt
from iic_tpu_torch.ops import iid_loss as tiid
from iic_tpu_torch.parallel.train_step import (
    make_cluster_train_step, make_optimizer)
from iic_tpu_torch.train.config import ClusterConfig
from test_torch_bf16 import _mean_max, _nominal, _within
from test_torch_cluster_data import _write_cifar
from test_torch_cluster_models import random_flax_variables
from test_torch_import import _ref_cluster_root
import torch_twins as tw

ATOL = 1e-5
RTOL = 1e-4
SZ = 24
# model 685's transform flags (examples/commands.md:46-52) on a small set
GREY = dict(dataset="Synthetic10x28x1x64", batch_sz=30, num_dataloaders=3,
            crop_orig=True, crop_other=True, tf1_crop="centre_half",
            tf2_crop="random", tf1_crop_sz=20, tf2_crop_szs=(16, 20, 24),
            input_sz=SZ, rot_val=25.0, no_flip=True, gt_k=10,
            output_k_A=15, output_k_B=10)


def _cfgs(**kw):
    """The same flags for both packages, finalised for the greyscale
    two-head script."""
    flags = {**GREY, **kw}
    return (ClusterConfig(**flags).finalize(twohead=True, sobel=False),
            JaxClusterConfig(**flags).finalize(twohead=True, sobel=False))


def _imgs(seed, b, h=28, w=28):
    return np.random.default_rng(seed).random((b, h, w, 1)).astype(
        np.float32)


def _keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


# ------------------------------------------------- JAX's draws, from its keys

def _jax_crop_draw(key, h, w, sz, mode):
    """The corner JAX's ``mode`` crop of ``sz`` takes with ``key``
    (``random_crop``, ``center_crop`` or ``crop_half_or_centre``)."""
    centre = ((h - sz + 1) // 2, (w - sz + 1) // 2)
    if mode == "centre":
        return centre
    if mode == "centre_half":
        k1, key = jax.random.split(key)
        if not bool(jax.random.bernoulli(k1)):
            return centre
    kt, kl = jax.random.split(key)
    return (int(jax.random.randint(kt, (), 0, h - sz + 1)),
            int(jax.random.randint(kl, (), 0, w - sz + 1)))


def _jax_rotation_draw(key, max_deg, always=False):
    k_apply, k_angle = jax.random.split(key)
    angle = float(jax.random.uniform(k_angle, (), minval=-max_deg,
                                     maxval=max_deg))
    return angle, bool(always or jax.random.bernoulli(k_apply, 0.5))


def _jax_choice_draw(key, h, w, szs, mode):
    k_choice, k_crop = jax.random.split(key)
    choice = int(jax.random.randint(k_choice, (), 0, len(szs)))
    return (choice, *_jax_crop_draw(k_crop, h, w, szs[choice], mode))


def _jax_jitter_draw(key):
    ks = jax.random.split(key, 5)
    f = [float(jax.random.uniform(ks[i], (), minval=lo, maxval=hi))
         for i, (lo, hi) in enumerate(((0.6, 1.4), (0.6, 1.4), (0.6, 1.4),
                                       (-0.125, 0.125)))]
    return f, [int(v) for v in jax.random.permutation(ks[4], 4)]


def _stack(rows, names):
    """Per-sample draws -> the port's draws dict of (B,) / (B, 4) tensors."""
    cols = list(zip(*rows))
    return {n: torch.tensor(np.array(c)) for n, c in zip(names, cols)}


def _jax_tf1_draws(cfg, keys, h, w):
    if not cfg.crop_orig:
        return {}
    return _stack([_jax_crop_draw(k, h, w, cfg.tf1_crop_sz, cfg.tf1_crop)
                   for k in keys], ("top", "left"))


def _jax_tf2_draws(cfg, keys, h, w):
    """The draws JAX's greyscale tf2 makes from each key, in its order:
    ``split(key, 4)`` -> rotation, choice crop, flip, jitter."""
    draws = {}
    ks = [jax.random.split(k, 4) for k in keys]
    if cfg.rot_val > 0:
        draws.update(_stack([_jax_rotation_draw(k[0], cfg.rot_val,
                                                cfg.always_rot) for k in ks],
                            ("angle", "rotate")))
        draws["angle"] = draws["angle"].float()
    if cfg.crop_other:
        draws.update(_stack([_jax_choice_draw(k[1], h, w, cfg.tf2_crop_szs,
                                              cfg.tf2_crop) for k in ks],
                            ("choice", "top", "left")))
    if not cfg.no_flip:
        draws["flip"] = torch.tensor([bool(jax.random.bernoulli(k[2]))
                                      for k in ks])
    if not cfg.no_jitter:
        f, o = zip(*[_jax_jitter_draw(k[3]) for k in ks])
        draws["jitter_factors"] = torch.tensor(np.array(f, np.float32))
        draws["jitter_order"] = torch.tensor(np.array(o))
    return draws


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("always", [False, True])
def test_rotation_given_jax_draws_matches_jax(always):
    """``rotate_where`` on the angle and coin JAX's ``random_rotation``
    draws: the same bilinear, zero-filled rotation."""
    img = _imgs(0, 6)
    keys = _keys(1, 6)
    draws = _stack([_jax_rotation_draw(k, 25.0, always) for k in keys],
                   ("angle", "rotate"))
    ref = jax.vmap(lambda x, k: jt.random_rotation(x, k, 25.0,
                                                   always=always))(
        jnp.asarray(img), keys)
    got = tt.rotate_where(torch.from_numpy(img), draws["angle"].float(),
                          draws["rotate"])
    n_rotated = int(draws["rotate"].sum())
    assert n_rotated == 6 if always else 0 < n_rotated < 6
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("mode", ["random", "centre", "centre_half"])
def test_choice_crop_resize_given_jax_draws_matches_jax(mode):
    """``choice_crop_resize_at`` (grouped by size) on JAX's choices and
    corners against ``random_choice_crop_resize``; every size chosen."""
    img = _imgs(2, 24)
    keys = _keys(3, 24)
    szs = (16, 20, 24)
    draws = _stack([_jax_choice_draw(k, 28, 28, szs, mode) for k in keys],
                   ("choice", "top", "left"))
    assert set(draws["choice"].tolist()) == {0, 1, 2}
    ref = jax.vmap(lambda x, k: jt.random_choice_crop_resize(
        x, k, szs, SZ, crop_mode=mode))(jnp.asarray(img), keys)
    got = tt.choice_crop_resize_at(torch.from_numpy(img), szs,
                                   draws["choice"], draws["top"],
                                   draws["left"], SZ)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_crop_half_or_centre_given_jax_draws_matches_jax():
    img = _imgs(4, 8)
    keys = _keys(5, 8)
    top, left = (torch.tensor(v) for v in zip(
        *[_jax_crop_draw(k, 28, 28, 20, "centre_half") for k in keys]))
    ref = jax.vmap(lambda x, k: jt.crop_half_or_centre(x, k, 20))(
        jnp.asarray(img), keys)
    got = tt.crop_at(torch.from_numpy(img), top, left, 20)
    assert np.array_equal(got.numpy(), np.asarray(ref))


TF_CASES = [
    {},  # model 685's
    dict(always_rot=True, tf2_crop="centre_half", no_flip=False),
    dict(tf1_crop="random", tf2_crop="centre", no_jitter=True),
    dict(tf1_crop="centre", crop_other=False, rot_val=0.0, no_flip=False),
    dict(crop_orig=False, demean=True, data_mean=(0.5,), data_std=(0.25,),
         per_img_demean=True),
    dict(tf3_crop_diff=True, tf3_crop_sz=16),
]


@pytest.mark.parametrize("flags", TF_CASES)
def test_greyscale_tfs_given_jax_draws_match_jax(flags):
    """tf1 and tf2 applied to the draws the JAX tf1 / tf2 make from their
    keys, and tf3, against the JAX package's composed transforms, over the
    flag combinations of the greyscale path."""
    tcfg, jcfg = _cfgs(**flags)
    jtf1, jtf2, jtf3 = jt.make_greyscale_pair_transforms(jcfg)
    tf1, tf2, tf3 = tt.make_greyscale_pair_transforms(tcfg)
    img = _imgs(6, 10)
    keys = _keys(7, 10)
    x, xj = torch.from_numpy(img), jnp.asarray(img)
    for port, ref, draws in (
            (tf1, jtf1, _jax_tf1_draws(jcfg, keys, 28, 28)),
            (tf2, jtf2, _jax_tf2_draws(jcfg, keys, 28, 28))):
        got = port.apply(x, draws)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax.vmap(ref)(xj, keys)),
                                   atol=ATOL)
        assert got.shape == (10, SZ, SZ, 1)
    got3 = tf3(x)
    np.testing.assert_allclose(got3.numpy(), np.asarray(jax.vmap(jtf3)(xj)),
                               atol=ATOL)
    assert torch.equal(got3, tf3(x.clone()))  # bit-stable


def test_tf_draws_are_what_apply_reads():
    """``tf.draw`` makes every draw ``tf.apply`` reads, and ``tf(img, g)``
    is ``apply(img, draw(g))`` on the same generator state."""
    tcfg, _ = _cfgs(no_flip=False)
    for tf in tt.make_greyscale_pair_transforms(tcfg)[:2]:
        x = torch.from_numpy(_imgs(8, 5))
        draws = tf.draw(5, 28, 28, torch.Generator().manual_seed(3), "cpu")
        assert torch.equal(tf(x, torch.Generator().manual_seed(3)),
                           tf.apply(x, draws))


def _assert_uniform_ints(values, n, name):
    counts = np.bincount(np.asarray(values), minlength=n)
    assert len(counts) == n and counts.min() > 0, f"{name}: {counts}"
    assert stats.chisquare(counts)[1] > 1e-4, f"{name}: {counts}"


def _rate_ok(rate, p, n):
    return abs(rate - p) < 4 * (p * (1 - p) / n) ** 0.5


def test_draw_distributions_match_jax():
    """Over 3000 draws of each package, read back from the outputs of the
    port's ``random_rotation``, ``random_choice_crop_resize`` and
    ``crop_half_or_centre`` and of JAX's: rotation at rate 1/2, angles
    uniform in +-rot_val (KS test, and the two packages' angles alike),
    every sample rotated under always_rot, the choice uniform over
    tf2_crop_szs, the centre-half crop at the centre half the time plus
    the random crop's 1/81 chance of landing there, its random corners
    uniform."""
    n, rot = 3000, 25.0
    keys = _keys(11, n)
    gen = torch.Generator().manual_seed(0)
    img = _imgs(12, 1)
    x = torch.from_numpy(img).expand(n, -1, -1, -1)

    def changed(out):
        return (np.abs(out - img).reshape(len(out), -1).max(axis=1) > 1e-6)

    rotated = changed(tt.random_rotation(x, gen, rot).numpy())
    jrotated = changed(np.asarray(jax.vmap(
        lambda k: jt.random_rotation(jnp.asarray(img[0]), k, rot))(keys)))
    for rate in (rotated.mean(), jrotated.mean()):
        assert _rate_ok(float(rate), 0.5, n)
    assert changed(tt.random_rotation(x, gen, rot, always=True).numpy()).all()
    angle, _ = tt.draw_rotation(n, rot, gen, "cpu")
    jangle = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k)[1], (), minval=-rot, maxval=rot))(keys))
    for a in (angle.numpy(), jangle):
        assert np.abs(a).max() <= rot
        assert stats.kstest(a, stats.uniform(-rot, 2 * rot).cdf).pvalue > 1e-4
    assert stats.ks_2samp(angle.numpy(), jangle).pvalue > 1e-4

    # the choice, read from the span of a ramp's centre crop, resized
    szs = (16, 20, 24)
    ramp = np.broadcast_to(np.arange(28, dtype=np.float32)[None, :, None],
                           (28, 28, 1))
    spans = [float(np.ptp(tt.choice_crop_resize_at(
        torch.from_numpy(ramp.copy())[None], szs, torch.tensor([i]),
        torch.tensor([(28 - sz + 1) // 2]), torch.tensor([(28 - sz + 1) // 2]),
        SZ).numpy())) for i, sz in enumerate(szs)]

    def chosen(out):
        span = np.ptp(out.reshape(len(out), -1), axis=1)
        return np.abs(span[:, None] - np.array(spans)[None]).argmin(axis=1)

    xr = torch.from_numpy(ramp.copy())[None].expand(n, -1, -1, -1)
    _assert_uniform_ints(chosen(tt.random_choice_crop_resize(
        xr, szs, SZ, gen, crop_mode="centre").numpy()), 3, "torch choice")
    _assert_uniform_ints(chosen(np.asarray(jax.vmap(
        lambda k: jt.random_choice_crop_resize(
            jnp.asarray(ramp), k, szs, SZ, crop_mode="centre"))(keys))), 3,
        "jax choice")

    # centre-half at size 20 of 28: the corner is the centre's 1/2 + 1/162
    grid = np.arange(28 * 28, dtype=np.float32).reshape(1, 28, 28, 1)
    corner = tt.crop_half_or_centre(
        torch.from_numpy(grid).expand(n, -1, -1, -1), 20, gen)[:, 0, 0, 0]
    jcorner = jax.vmap(lambda k: jt.crop_half_or_centre(
        jnp.asarray(grid[0]), k, 20)[0, 0, 0])(keys)
    p = 0.5 + 0.5 / 81
    for c in (corner.numpy().astype(np.int64),
              np.asarray(jcorner).astype(np.int64)):
        at_centre = c == 4 * 28 + 4
        assert _rate_ok(float(at_centre.mean()), p, n)
        _assert_uniform_ints(c[~at_centre] // 28, 9, "random top")


def test_augment_pair_tiles_block_wise_like_jax():
    """Two constant images (0.1, 0.7), r = 3, no rotation: tf1 rows are
    image j % 2 exactly, tiled block-wise as JAX's ``jnp.tile``; each tf2
    row is image j % 2 under its own brightness draw (disjoint ranges), in
    both packages."""
    tcfg, jcfg = _cfgs(rot_val=0.0)
    base = np.stack([np.full((28, 28, 1), v, np.uint8) for v in (26, 178)])
    pipe = tpipe.ClusterTrainPipeline(tcfg, [True], preloaded=(base, None))
    imgs, imgs_tf = pipe.augment_pair(torch.from_numpy(base),
                                      torch.Generator().manual_seed(0))
    jp = jpipe.ClusterTrainPipeline(jcfg, [True],
                                    preloaded=(base, np.zeros(2)))
    jimgs, jimgs_tf = jp.augment_pair(jnp.asarray(base),
                                      jax.random.PRNGKey(0))
    assert imgs.shape == imgs_tf.shape == tuple(jimgs.shape) == (6, 1, SZ,
                                                                 SZ)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), atol=ATOL)
    for tf in (imgs_tf.numpy(), np.asarray(jimgs_tf)):
        means = tf.reshape(6, -1).mean(axis=1)
        assert np.all(means[0::2] < 0.2) and np.all(means[1::2] > 0.35)


# ----------------------------------------------------------------- models

def _net_cfg(arch="ClusterNet6cTwoHead", track=True, dtype="float32"):
    return SimpleNamespace(arch=arch, in_channels=1, output_k=7,
                           output_k_A=7, output_k_B=3, num_sub_heads=2,
                           input_sz=SZ, batchnorm_track=track,
                           model_dtype=dtype)


@pytest.fixture(scope="module")
def nets():
    """(jnet, variables, torch net) per (arch, batchnorm_track)."""
    out = {}
    for arch, heads in (("ClusterNet6cTwoHead", ("A", "B")),
                        ("ClusterNet6c", None)):
        for track in (True, False):
            cfg = _net_cfg(arch, track)
            jnet = jmodels.build(arch, cfg)
            variables = random_flax_variables(jnet, 1, heads=heads, seed=1,
                                              head_std=0.1, sz=SZ)
            out[arch, track] = (jnet, variables, load_cluster_net(
                variables, tmodels.build(arch, cfg)))
    return out


def _x(seed=0, b=4):
    return np.random.default_rng(seed).random((b, 1, SZ, SZ)).astype(
        np.float32)


def _apply(jnet, variables, x, head, train):
    kw = {} if head is None else {"head": head}
    if train:
        return jnet.apply(variables, x, train=True, mutable=["batch_stats"],
                          **kw)
    return jnet.apply(variables, x, train=False, **kw), {}


@pytest.mark.parametrize("arch,head", [("ClusterNet6cTwoHead", "A"),
                                       ("ClusterNet6cTwoHead", "B"),
                                       ("ClusterNet6c", None)])
@pytest.mark.parametrize("track,train", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_net6c_forward_matches_jax(nets, arch, head, track, train):
    """Both heads and the single-head net, train- and eval-mode BN, with
    and without running statistics."""
    jnet, variables, tnet = nets[arch, track]
    tnet = copy.deepcopy(tnet)  # a train-mode forward updates its stats
    x = _x()
    ref, _ = jax.jit(_apply, static_argnums=(0, 3, 4))(
        jnet, variables, jnp.asarray(x), head, train)
    tnet.train(train)
    with torch.no_grad():
        got = (tnet(torch.from_numpy(x)) if head is None
               else tnet(torch.from_numpy(x), head=head)).numpy()
    assert got.shape == (2, 4, 3 if head == "B" else 7)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_net6c_running_stats_match_jax(nets):
    jnet, variables, tnet = nets["ClusterNet6cTwoHead", True]
    tnet = copy.deepcopy(tnet)
    x = _x(seed=3)
    _, upd = jax.jit(_apply, static_argnums=(0, 3, 4))(
        jnet, variables, jnp.asarray(x), "A", True)
    tnet.train()
    with torch.no_grad():
        tnet(torch.from_numpy(x), head="A")
    ref = _numbered(jax.device_get(upd["batch_stats"]), "BatchNorm")
    got = [(m.running_mean.numpy(), m.running_var.numpy())
           for m in tnet.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(got) == len(ref) == 4
    for (mean, var), (path, node) in zip(got, ref):
        np.testing.assert_allclose(mean, node["mean"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(var, node["var"], rtol=RTOL, atol=ATOL)


def test_net6c_uses_reference_names_and_widths():
    """``trunk.features.<i>`` and ``head_X.heads.<s>.0``; the heads read
    512 * (input_sz // 8)^2 features (28 -> 3^2 as 24 does); the semisup
    head B is one Linear of those features to output_k_B."""
    net = tmodels.build("ClusterNet6cTwoHead", _net_cfg())
    keys = set(net.state_dict())
    for key in ("trunk.features.0.weight", "trunk.features.1.running_var",
                "trunk.features.12.weight", "head_A.heads.1.0.weight",
                "head_B.heads.0.0.bias"):
        assert key in keys, key
    assert net.head_A.heads[0][0].in_features == 512 * 9
    cfg28 = _net_cfg("ClusterNet6c")
    cfg28.input_sz = 28
    assert tmodels.build("ClusterNet6c", cfg28).head.heads[0][0] \
        .in_features == 512 * 9
    semi = _net_cfg()
    semi.semisup = True
    head_b = tmodels.build("ClusterNet6cTwoHead", semi).head_B
    assert isinstance(head_b, torch.nn.Linear)
    assert (head_b.in_features, head_b.out_features) == (512 * 9, 3)


@pytest.mark.parametrize("arch", ["ClusterNet6cTwoHead", "ClusterNet6c"])
def test_reference_state_dicts_load(arch):
    """A state_dict in the reference's layout (the twin of
    tests/torch_twins.py under the reference's ``trunk.features`` /
    ``head*.heads.<s>.0`` names) loads strictly, and the port's eval
    forward equals the twin's."""
    twohead = arch.endswith("TwoHead")
    twin = (tw.TorchNet6cTwoHead(1, SZ, 7, 3, 2) if twohead
            else tw.TorchNet6c(1, SZ, 7, 2))
    net = tmodels.build(arch, _net_cfg(arch))
    net.load_state_dict(_ref_cluster_root(twin, twohead).state_dict())
    x = torch.from_numpy(_x(seed=6))
    twin.eval(), net.eval()
    with torch.no_grad():
        for head in (("A", "B") if twohead else (None,)):
            kw = {} if head is None else {"head": head}
            torch.testing.assert_close(net(x, **kw),
                                       torch.stack(twin(x, **kw)))


# (mean |d|, max |d|) of the bf16 port's softmax outputs against the JAX
# bf16 net; the f32 port must fail the bound (errors: bf16 / f32 port)
NET6C_BF16 = {True: (1e-3, 9e-3),      # train BN: 6.5e-4, 7.7e-3 / 1.4e-3, 1.0e-2
              False: (2e-4, 1.5e-3)}  # eval BN: 5.8e-5, 8.3e-4 / 4.0e-4, 2.1e-3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("train", [True, False])
def test_net6c_bf16_forward_matches_jax_bf16(nets, dtype, train):
    """Head A of the two-head net in bf16 against the JAX bf16 net (XLA's
    excess precision off): the bf16 port within ``NET6C_BF16``, the f32
    port outside it."""
    jnet_f32, variables, _ = nets["ClusterNet6cTwoHead", True]
    jnet = jmodels.build("ClusterNet6cTwoHead", _net_cfg(dtype="bfloat16"))
    tnet = load_cluster_net(variables, tmodels.build(
        "ClusterNet6cTwoHead", _net_cfg(dtype=dtype)))
    x = np.random.default_rng(2).standard_normal((6, 1, SZ, SZ)).astype(
        np.float32)
    ref = np.asarray(_nominal(
        lambda v, a: _apply(jnet, v, a, "A", train)[0], variables,
        jnp.asarray(x)))
    tnet.train(train)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), head="A")
    assert got.dtype == torch.float32
    errs = _mean_max(got.numpy(), ref)
    print(f"net6c bf16 forward train={train} {dtype}: {errs}")
    assert _within(errs, NET6C_BF16[train]) == (dtype == "bfloat16"), errs


# ---------------------------------------------------------------- readers

def _idx_bytes(arr):
    dims = arr.shape
    head = (0x0800 | len(dims)).to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in dims)
    return head + arr.astype(np.uint8).tobytes()


def _write_mnist(root, sub, gz, n=(7, 5), seed=0):
    rng = np.random.default_rng(seed)
    base = os.path.join(root, sub)
    os.makedirs(base, exist_ok=True)
    for prefix, count in zip(("train", "t10k"), n):
        for kind, arr in (("images-idx3", rng.integers(0, 256, (count, 28,
                                                                28))),
                          ("labels-idx1", rng.integers(0, 10, count))):
            path = os.path.join(base, f"{prefix}-{kind}-ubyte")
            data = _idx_bytes(arr)
            if gz:
                with gzip.open(path + ".gz", "wb") as f:
                    f.write(data)
            else:
                with open(path, "wb") as f:
                    f.write(data)


@pytest.mark.parametrize("sub", ["", "raw", "MNIST/raw"])
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_mnist_reader_bit_equal(tmp_path, sub, gz, train):
    _write_mnist(str(tmp_path), sub, gz)
    got = treaders.load_dataset("MNIST", str(tmp_path), train)
    ref = jreaders.load_dataset("MNIST", str(tmp_path), train)
    assert got["images"].shape == (7 if train else 5, 28, 28, 1)
    assert got["images"].dtype == np.uint8 and got["labels"].dtype == np.int32
    assert np.array_equal(got["images"], ref["images"])
    assert np.array_equal(got["labels"], ref["labels"])


def write_stl10(root, n_train=4, n_test=3, per=2, seed=0):
    """An STL10 binary tree under root/stl10_binary: train and test with
    labels 1-10, ``per`` unlabelled images per labelled one."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "stl10_binary")
    os.makedirs(base, exist_ok=True)
    for part, n, labelled in (("train", n_train, True),
                              ("test", n_test, True),
                              ("unlabeled", n_train * per, False)):
        rng.integers(0, 256, n * 3 * 96 * 96, dtype=np.uint8).tofile(
            os.path.join(base, f"{part}_X.bin"))
        if labelled:
            rng.integers(1, 11, n, dtype=np.uint8).tofile(
                os.path.join(base, f"{part}_y.bin"))


@pytest.mark.parametrize("split", ["train", "test", "unlabeled",
                                   "train+unlabeled"])
def test_stl10_reader_bit_equal(tmp_path, split):
    write_stl10(str(tmp_path))
    got = treaders.load_dataset("STL10", str(tmp_path), split)
    ref = jreaders.load_dataset("STL10", str(tmp_path), split)
    assert got["images"].shape[1:] == (96, 96, 3)
    assert np.array_equal(got["images"], ref["images"])
    assert np.array_equal(got["labels"], ref["labels"])
    if split == "unlabeled":
        assert np.all(got["labels"] == -1)


@pytest.mark.parametrize("train", [True, False])
def test_digits_reader_bit_equal(train):
    got = treaders.load_dataset("Digits", "", train)
    ref = jreaders.load_dataset("Digits", "", train)
    assert got["images"].shape == (1500 if train else 297, 24, 24, 1)
    assert np.array_equal(got["images"], ref["images"])
    assert np.array_equal(got["labels"], ref["labels"])


def test_digits_copy_equals_scikit_learn():
    """The port's ``digits.npz`` holds scikit-learn's UCI optical digits
    bit for bit (values 0-16 as uint8, exact in float64)."""
    from sklearn.datasets import load_digits
    d = load_digits()
    with np.load(treaders.DIGITS_NPZ) as z:
        assert np.array_equal(z["images"].astype(np.float64), d.images)
        assert np.array_equal(z["target"], d.target)


@pytest.mark.parametrize("name", ["ImageFolder"])
def test_unported_readers_raise_naming_themselves(name, tmp_path):
    """The two-head scripts' partition table takes no image folder (that
    is ``create_basic_clustering_dataloaders``'), as in the JAX package."""
    tcfg, _ = _cfgs(dataset=name, dataset_root=str(tmp_path))
    with pytest.raises(NotImplementedError, match=name):
        tpipe._twohead_partitions(tcfg)


# ---------------------------------------- partitions, --mix_train, pipelines

@pytest.mark.parametrize("n_train,per", [(5, 2), (3, 20), (4, 0)])
def test_mix_train_order_equals_jax(n_train, per):
    assert np.array_equal(
        treaders.reorder_train_deterministic_ids(n_train, per),
        jreaders.reorder_train_deterministic_ids(n_train, per))


@pytest.mark.parametrize("dataset,flags", [
    ("MNIST", {}), ("Digits", {}), ("CIFAR20", {}), ("Synthetic3x28x1x8", {}),
    ("STL10", dict(mix_train=True)),
    ("STL10", dict(mix_train=True, stl_leave_out_unlabelled=True))])
def test_partition_tables_equal_jax(tmp_path, dataset, flags):
    """The two-head table and the single-head IID+ one, on fixture trees:
    the same partitions and the same decoded training images."""
    root = str(tmp_path)
    if dataset == "MNIST":
        _write_mnist(root, "", gz=False)
    elif dataset == "STL10":
        write_stl10(root)
    elif dataset == "CIFAR20":
        _write_cifar(tmp_path)
    if dataset in ("CIFAR20", "STL10"):  # colour: the sobel path's flags
        flags = dict(flags, rot_val=0.0)
    tcfg, jcfg = _cfgs(dataset=dataset, dataset_root=root, **flags)
    assert tpipe._twohead_partitions(tcfg) == jpipe._twohead_partitions(jcfg)
    for cfg in (tcfg, jcfg):
        cfg.mode = "IID+"
    got = tpipe.cluster_create_dataloaders(tcfg)
    ref = jpipe.cluster_create_dataloaders(jcfg)
    for key in ("train_partitions", "mapping_assignment_partitions",
                "mapping_test_partitions"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    for g, r in zip(got, ref):
        assert np.array_equal(g.images, np.asarray(r.images))
        assert np.array_equal(g.labels, r.labels)


def test_stl10_without_mix_train_raises():
    tcfg, _ = _cfgs(dataset="STL10")
    with pytest.raises(ValueError, match="mix_train"):
        tpipe._twohead_partitions(tcfg)


@pytest.mark.parametrize("leave_out", [False, True])
def test_stl10_twohead_pipelines_equal_jax(tmp_path, leave_out):
    """On an STL10 tree (4 labelled + 8 unlabelled, 3 test): head A's
    batches over the --mix_train interleave (or train + test with
    --stl_leave_out_unlabelled) and head B's, the mapping loaders', equal
    to JAX's; head B and the loaders share their decoded images, head A
    has its own unless the partitions coincide."""
    write_stl10(str(tmp_path))
    flags = dict(dataset="STL10", dataset_root=str(tmp_path), mix_train=True,
                 stl_leave_out_unlabelled=leave_out, batch_sz=9,
                 num_dataloaders=3, rand_crop_sz=64, input_sz=64,
                 crop_orig=True)
    tcfg = ClusterConfig(**flags).finalize(twohead=True, sobel=True)
    jcfg = JaxClusterConfig(**flags).finalize(twohead=True, sobel=True)
    got = tpipe.cluster_twohead_create_dataloaders(tcfg, seed=1)
    ref = jpipe.cluster_twohead_create_dataloaders(jcfg, seed=1)
    for g, r in zip(got[:2], ref[:2]):
        assert np.array_equal(g.images, np.asarray(r.images))
        assert np.array_equal(g.labels, r.labels)
        gb = [b.numpy() for b, _ in g.epoch(1)]
        rb = [np.asarray(b) for b, _ in r.epoch(1, augmented=False)]
        assert len(gb) == len(rb) == (5 if g is got[0] and not leave_out
                                      else 3)
        assert all(np.array_equal(a, b) for a, b in zip(gb, rb))
    assert got[2].images is got[1].images and got[3].images is got[1].images
    assert (got[0].images is got[1].images) == leave_out
    np.testing.assert_array_equal(got[0].labels[:3], ref[0].labels[:3])
    for g, r in zip(got[2:], ref[2:]):
        for (gi, gl), (ri, rl) in zip(g, r):
            np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=ATOL)
            assert np.array_equal(gl, np.asarray(rl))


def test_greyscale_pipelines_yield_the_jax_batches(tmp_path):
    """On an MNIST tree (7 train + 5 test): sequential batches over train
    and test, ragged last batch kept, equal to JAX's; the tf3 eval batches
    within ATOL."""
    _write_mnist(str(tmp_path), "raw", gz=True)
    tcfg, jcfg = _cfgs(dataset="MNIST", dataset_root=str(tmp_path),
                       batch_sz=15)
    pa, pb, ma, mt = tpipe.cluster_twohead_create_dataloaders(tcfg, seed=3)
    ja, _, jma, _ = jpipe.cluster_twohead_create_dataloaders(jcfg, seed=3)
    got = [b.numpy() for b, _ in pa.epoch(1)]
    ref = [np.asarray(b) for b, _ in ja.epoch(1, augmented=False)]
    assert [len(b) for b in got] == [len(b) for b in ref] == [5, 5, 2]
    assert all(np.array_equal(g, r) for g, r in zip(got, ref))
    assert pb.images is pa.images and ma.images is pa.images
    for (gi, gl), (ri, rl) in zip(ma, jma):
        assert gi.shape == (len(rl), 1, SZ, SZ)
        np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=ATOL)
        assert np.array_equal(gl, np.asarray(rl))
    imgs, imgs_tf = next(pa.epoch(1, augmented=True))
    assert imgs.shape == imgs_tf.shape == (15, 1, SZ, SZ)


# ------------------------------------------------------- steps and the CLI

def _batches(n_steps, b=6, seed=0):
    """Fixed pre-augmented greyscale pairs (imgs, imgs_tf) (b, 1, SZ, SZ)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        imgs = rng.random((b, 1, SZ, SZ)).astype(np.float32)
        tf = np.clip(imgs + 0.1 * rng.standard_normal(imgs.shape), 0, 1)
        out.append((imgs, tf.astype(np.float32)))
    return out


# lr and loss bound of the lockstep tests, test_torch_cluster_train.py's:
# measured, at most 3.5e-6 here and 3.2e-5 in the single-head lockstep
# (test_torch_cluster_single.py, step 4); a port step that climbs the loss
# instead (Adam's maximize) is 0.11 off at step 2
LOCKSTEP_LR, LOCKSTEP_TOL = 1e-5, 1e-4


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_greyscale_twohead_lockstep_with_jax(nets, impl):
    """Heads A, B, A, B of the greyscale step (no sobel) from the same
    weights on the same batches: the JAX step (optax Adam; the fused kernel
    in interpret mode) and the port's (torch Adam; K3's plain version on
    the CPU). The loss and the loss without lambda differ by at most
    ``LOCKSTEP_TOL`` at every step.

    lr is 1e-5, as in test_torch_cluster_train.py's lockstep: Adam moves
    every weight by about lr whatever its gradient's size, so the JAX
    BatchNorm's f32 noise (var = E[x^2] - E[x]^2) grows with lr; at model
    685's 1e-4 the two packages' head-B loss is 3.3e-4 apart at step 2."""
    jnet, variables, _ = nets["ClusterNet6cTwoHead", True]
    tnet = load_cluster_net(variables, tmodels.build(
        "ClusterNet6cTwoHead", _net_cfg()))
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LOCKSTEP_LR)
    state = create_train_state(variables, tx)
    opt = make_optimizer(tnet, SimpleNamespace(opt="Adam", lr=LOCKSTEP_LR))
    lambs = {"A": 1.0, "B": 1.3}
    jsteps = {h: jax_cluster_step(
        jnet, tx, lambda batch, key: batch, lamb=lambs[h], head=h,
        loss_impl="pallas" if impl == "fused" else "xla") for h in "AB"}
    tsteps = {h: make_cluster_train_step(tnet, opt, None, lamb=lambs[h],
                                         head=h, loss_impl=impl)
              for h in "AB"}
    losses = []
    for head, batch in zip("ABAB", _batches(4)):
        with pltpu.force_tpu_interpret_mode():
            state, jloss, jloss_nl = jsteps[head](
                state, tuple(jnp.asarray(x) for x in batch),
                jax.random.PRNGKey(0))
        tloss, tloss_nl = tsteps[head](tuple(torch.from_numpy(x)
                                             for x in batch))
        assert abs(float(tloss) - float(jloss)) <= LOCKSTEP_TOL, (
            head, tloss, jloss)
        assert abs(float(tloss_nl) - float(jloss_nl)) <= LOCKSTEP_TOL
        losses.append(float(jloss))
    assert max(abs(v) for v in losses) > 1e-2  # the check has teeth


GREY_CLI = ["--arch", "ClusterNet6cTwoHead", "--mode", "IID",
            "--dataset", "Synthetic10x28x1x48", "--gt_k", "10",
            "--output_k_A", "15", "--output_k_B", "10", "--lamb_A", "1.0",
            "--lamb_B", "1.0", "--lr", "0.0001", "--num_epochs", "2",
            "--batch_sz", "30", "--num_dataloaders", "3",
            "--num_sub_heads", "2", "--crop_orig", "--crop_other",
            "--tf1_crop", "centre_half", "--tf2_crop", "random",
            "--tf1_crop_sz", "20", "--tf2_crop_szs", "16", "20", "24",
            "--input_sz", "24", "--rot_val", "25", "--no_flip",
            "--head_B_epochs", "2", "--test_code"]


def _counting_fused(monkeypatch):
    """Count the port's calls of K3's wrapper from the IID loss."""
    calls = []
    fused = tiid.iid_loss_fused

    def counted(*args, **kw):
        calls.append(1)
        return fused(*args, **kw)

    monkeypatch.setattr(tiid, "iid_loss_fused", counted)
    return calls


@pytest.mark.parametrize("extra", [
    ["--fused_loss", "--double_eval", "--batchnorm_track"],
    ["--model_dtype", "bfloat16", "--select_sub_head_on_loss"]])
def test_greyscale_twohead_cli_on_cpu(tmp_path, monkeypatch, extra):
    """Model 685's flags at a small batch with --test_code: finite losses,
    two steps per head pass (head B twice), a pre-train and an epoch eval,
    K3's wrapper once a step under --fused_loss, a run directory with
    net6c's weights."""
    calls = _counting_fused(monkeypatch)
    net, history = cluster_greyscale_twohead.main(
        GREY_CLI + extra + ["--out_root", str(tmp_path)], device="cpu")
    for head, steps in (("A", 2), ("B", 4)):
        assert np.isfinite(history[f"epoch_loss_head_{head}"]).all()
        assert len(history[f"step_seconds_head_{head}"]) == steps
    ev = history["eval"]
    assert len(ev.epoch_acc) == 2 and all(0 <= a <= 1 for a in ev.epoch_acc)
    assert len(ev.double_eval_acc) == (2 if "--double_eval" in extra else 0)
    assert len(calls) == (6 if "--fused_loss" in extra else 0)
    saved = torch.load(tmp_path / "0" / "latest.pytorch", weights_only=True)
    assert "trunk.features.12.weight" in saved["net"]


def test_greyscale_twohead_cli_needs_a_gpu_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        cluster_greyscale_twohead.main(GREY_CLI + ["--out_root",
                                                   str(tmp_path)])


@pytest.mark.parametrize("flag,dataset", [
    (["--kmeans_on_features"], None)])
def test_greyscale_cli_refusals(tmp_path, flag, dataset):
    """What stays refused: the triplets baseline's flag on the greyscale
    CLI (``--save_progression`` runs: tests/test_torch_analysis.py;
    ``--lazy_images``: tests/test_torch_data_paths.py)."""
    argv = list(GREY_CLI)
    if dataset:
        argv[argv.index("Synthetic10x28x1x48")] = dataset
    with pytest.raises(NotImplementedError, match=flag[-1][2:]):
        cluster_greyscale_twohead.main(
            argv + flag + ["--out_root", str(tmp_path)], device="cpu")
