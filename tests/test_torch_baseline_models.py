"""The baselines' nets against the JAX package, with the flax weights carried
across by ``load_triplets_net`` and ``load_seg_baseline_net``
(iic_tpu_torch/compat/flax_bridge.py): TripletsNet5g and TripletsNet6c
forwards and their k-means features, train-mode BN (running statistics
included) and eval-mode; the Doersch and Isola forwards at train=False
(dropout off), the upsampled penultimate features, edge rows and columns
included; the siamese branch's BN moving its running statistics once a
patch set; and ``get_patches`` at clamped starts. Weights and inputs are
made from numpy seeds.

Tolerances: the seg nets' logits and every running statistic within atol
1e-5 plus rtol 1e-4, as the existing cluster and seg net parity tests hold
theirs (f32 convolutions summed in two orders); the seg nets' upsampled
trunk features, unnormalised, within 1e-5 of their max (5 of 2M values
pass 1e-5 absolute, at 4e-6 of max).
The triplets nets' outputs are raw logits and features, not softmax
probabilities: they are held within 1e-4 of their max |value| (the
semisup tests hold the ResNet trunk's features at 3e-5 of max; the JAX
BatchNorm's f32 variance, E[x^2] - E[x]^2, puts the ResNet-34's at up to
5e-5 of max at batch 4, net6c's at 4e-6)."""

import math
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.models.seg_baselines import get_patches as jax_get_patches
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import (
    load_seg_baseline_net, load_triplets_net)
from iic_tpu_torch.models.seg_baselines import get_patches
from test_torch_cluster_models import random_flax_variables

ATOL, RTOL = 1e-5, 1e-4
SEG_SZ, PATCH = 32, 3


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _close_of_max(got, ref, rel=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def _triplets(arch, track):
    sz = 32 if arch == "TripletsNet5g" else 24
    in_ch = 2 if arch == "TripletsNet5g" else 1
    cfg = SimpleNamespace(arch=arch, in_channels=in_ch, output_k=7,
                          input_sz=sz, batchnorm_track=track)
    jnet = jmodels.build(arch, cfg)
    variables = random_flax_variables(jnet, in_ch, heads=None, seed=2,
                                      head_std=0.1, sz=sz)
    tnet = load_triplets_net(variables, tmodels.build(arch, cfg))
    x = np.random.default_rng(3).random((4, in_ch, sz, sz)).astype(
        np.float32)
    return jnet, variables, tnet, x


@pytest.mark.parametrize("arch", ["TripletsNet5g", "TripletsNet6c"])
@pytest.mark.parametrize("track", [True, False])
def test_triplets_net_matches_jax(arch, track):
    """Logits and k-means features in train mode (batch statistics; the
    running statistics after it) and in eval mode."""
    jnet, variables, tnet, x = _triplets(arch, track)
    xt = torch.from_numpy(x)
    kw = {"mutable": ["batch_stats"]} if track else {}
    for features in (False, True):
        ref = jnet.apply(variables, jnp.asarray(x), train=True,
                         kmeans_use_features=features, **kw)
        ref_out = ref[0] if track else ref
        net = tmodels.build(arch, SimpleNamespace(
            in_channels=x.shape[1], output_k=7, input_sz=x.shape[-1],
            batchnorm_track=track))
        net.load_state_dict(tnet.state_dict())
        net.train()
        with torch.no_grad():
            got = net(xt, kmeans_use_features=features)
        _close_of_max(got, ref_out)
        if track:  # every running statistic, through the bridge
            moved = load_triplets_net(
                {"params": variables["params"],
                 "batch_stats": ref[1]["batch_stats"]},
                tmodels.build(arch, SimpleNamespace(
                    in_channels=x.shape[1], output_k=7,
                    input_sz=x.shape[-1], batchnorm_track=track)))
            want = moved.state_dict()
            for k, v in net.state_dict().items():
                if k.endswith(("running_mean", "running_var")):
                    _close(v, want[k])
    tnet.eval()
    with torch.no_grad():
        for features in (False, True):
            ref = jnet.apply(variables, jnp.asarray(x), train=False,
                             kmeans_use_features=features)
            _close_of_max(tnet(xt, kmeans_use_features=features), ref)


def _fill_seg(shapes, seed):
    """A flax variable tree of ``shapes`` from a numpy seed: convs Kaiming
    fan-in, the joint kernels N(0, 1 / fan-in), BN and biases
    randomised."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        collection, name, shape = path[0].key, path[-1].key, leaf.shape
        if collection == "batch_stats":
            v = (0.1 * rng.standard_normal(shape) if name == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif name == "kernel":  # HWIO conv
            v = rng.standard_normal(shape) * math.sqrt(
                2.0 / (shape[0] * shape[1] * shape[2]))
        elif name.startswith("joint_kernel"):
            v = rng.standard_normal(shape) / math.sqrt(shape[0])
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def seg_baseline_pair(arch, track=True, seed=0, in_ch=5):
    """(config, JAX net, numpy-made flax variables, bridged port net) at
    32^2 and patch side 3."""
    cfg = SimpleNamespace(arch=arch, in_channels=in_ch, input_sz=SEG_SZ,
                          batchnorm_track=track, doersch_patch_side=PATCH,
                          isola_patch_side=PATCH)
    jnet = jmodels.build(arch, cfg)
    c = jnp.full((2, 2), SEG_SZ // 2, jnp.int32)
    shapes = jax.eval_shape(lambda: jnet.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, in_ch, SEG_SZ, SEG_SZ)), centre=c, other=c,
        train=True))
    variables = _fill_seg(shapes, seed)
    tnet = load_seg_baseline_net(variables, tmodels.build(arch, cfg))
    return cfg, jnet, variables, tnet


def _centres(rng, n):
    """Per-sample centres and others across the map, some at the edge (the
    patch start clamps there)."""
    c = rng.integers(0, SEG_SZ, (n, 2)).astype(np.int32)
    c[0] = (0, SEG_SZ - 1)
    o = rng.integers(0, SEG_SZ, (n, 2)).astype(np.int32)
    o[1] = (SEG_SZ - 1, 1)
    return c, o


@pytest.mark.parametrize("arch", ["SegmentationNet10aDoersch",
                                  "SegmentationNet10aIsola"])
@pytest.mark.parametrize("track", [True, False])
def test_seg_baseline_eval_forward_matches_jax(arch, track):
    """train=False: the logits (dropout off) at per-sample centres, edges
    included, and the penultimate features over the whole map."""
    _, jnet, variables, tnet = seg_baseline_pair(arch, track)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 5, SEG_SZ, SEG_SZ)).astype(np.float32)
    c, o = _centres(rng, 4)
    ref = jnet.apply(variables, jnp.asarray(x), centre=jnp.asarray(c),
                     other=jnp.asarray(o), train=False)
    tnet.eval()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), torch.from_numpy(c),
                   torch.from_numpy(o))
        feats = tnet(torch.from_numpy(x), penultimate=True)
    assert got.shape == ref.shape == (4, 9 if "Doersch" in arch else 1)
    _close(got, ref)
    assert np.abs(np.asarray(ref)).max() > 0.1  # the check has teeth
    ref_feats = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False,
                                      penultimate=True))
    assert feats.shape == ref_feats.shape == (4, 512, SEG_SZ, SEG_SZ)
    _close_of_max(feats, ref_feats, 1e-5)
    # the edge rows and columns of the bilinear upsample on their own
    for sl in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0],
               np.s_[..., :, -1]):
        _close_of_max(feats.numpy()[sl], ref_feats[sl], 1e-5)


def test_siamese_branch_moves_bn_once_a_patch_set():
    """A train-mode forward with the dropout held off (a mask of ones in
    the port; the JAX head's dropout sees rate 0.5, so its logits are not
    compared here): the siamese BN's running statistics after the two
    calls, one for each patch set, equal flax's, and differ from one
    BN call over both sets."""
    _, jnet, variables, tnet = seg_baseline_pair("SegmentationNet10aDoersch")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 5, SEG_SZ, SEG_SZ)).astype(np.float32)
    c, o = _centres(rng, 4)
    _, upd = jnet.apply(variables, jnp.asarray(x), centre=jnp.asarray(c),
                        other=jnp.asarray(o), train=True,
                        mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(0)})
    ref = upd["batch_stats"]["_SiameseJointHead_0"]["siamese_bn"]
    tnet.train()
    with torch.no_grad():
        tnet(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(o))
    bn = tnet.head.siamese_bn
    _close(bn.running_mean, ref["mean"])
    _close(bn.running_var, ref["var"])
    before = variables["batch_stats"]["_SiameseJointHead_0"]["siamese_bn"]
    assert np.abs(np.asarray(ref["mean"]) - before["mean"]).max() > 1e-3


def test_get_patches_matches_dynamic_slice_clamping():
    """Starts inside the map, past its end and before its start: the port
    equals ``jax.lax.dynamic_slice``'s slices bit for bit (jax counts a
    negative start from the end, then clamps the slice into the map), and
    never raises."""
    feats = np.arange(3 * 2 * 10 * 12, dtype=np.float32).reshape(3, 2, 10,
                                                                 12)
    for centres in ([[5, 6], [0, 0], [9, 11]], [[-7, 3], [20, -4], [2, 30]]):
        c = np.asarray(centres, np.int32)
        for p in (1, 4, 5):
            ref = np.asarray(jax_get_patches(jnp.asarray(feats),
                                             jnp.asarray(c), p))
            got = get_patches(torch.from_numpy(feats), torch.from_numpy(c),
                              p).numpy()
            np.testing.assert_array_equal(got, ref)
    got = get_patches(torch.from_numpy(feats),
                      torch.tensor([[2, 2], [9, 11], [5, 6]]), 4).numpy()
    np.testing.assert_array_equal(got[0], feats[0, :, 0:4, 0:4])
    np.testing.assert_array_equal(got[1], feats[1, :, 6:10, 8:12])
    np.testing.assert_array_equal(got[2], feats[2, :, 3:7, 4:8])
