"""The port's baseline losses and host geometry against the JAX package:
``triplets_loss``, ``doersch_loss`` and ``isola_loss`` (values and
gradients, masked and unmasked, the eps exclusion, a batch with nothing
relevant); the Doersch and Isola patch geometry and the triplets
negatives' order, bit for bit over many seeds; the Doersch rgb stats and
their cache; the relevancy mask per pair with JAX's clamping gather; and,
by their distributions, the ``--per_sample_patches`` draws and the
colour-dropping noise, whose draws cannot match JAX's bit for bit.

Tolerances: loss values within rtol 1e-5 (atol 1e-7), gradients within
rtol 1e-4 (atol 1e-7): f32 reductions in two orders; the stats within
1e-6."""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu.ops import baselines as jb
from iic_tpu.train import seg_baseline_trainers as jtr
from iic_tpu_torch.ops import baselines as tb
from iic_tpu_torch.train import seg_baseline_trainers as ttr
from iic_tpu_torch.train.triplets_trainer import negative_order

V_RTOL, V_ATOL = 1e-5, 1e-7
G_RTOL, G_ATOL = 1e-4, 1e-7


def _grads(fn_t, fn_j, *arrays, argnums=(0,)):
    """Value and gradients of the port's ``fn_t`` and JAX's ``fn_j`` at the
    same numpy arrays (gradients w.r.t. ``argnums``)."""
    ts = [torch.tensor(a, requires_grad=i in argnums)
          if a.dtype == np.float32 else torch.tensor(a)
          for i, a in enumerate(arrays)]
    val_t = fn_t(*ts)
    val_t.backward()
    val_j, g_j = jax.value_and_grad(fn_j, argnums=argnums)(
        *[jnp.asarray(a) for a in arrays])
    return (float(val_t.detach()), [ts[i].grad.numpy() for i in argnums],
            float(val_j), [np.asarray(g) for g in g_j])


def _check(got, want):
    val_t, g_t, val_j, g_j = got
    np.testing.assert_allclose(val_t, val_j, rtol=V_RTOL, atol=V_ATOL)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL)
    assert np.isfinite(val_t)


@pytest.mark.parametrize("scale", [0.1, 3.0])
def test_triplets_loss_matches_jax(scale):
    """The KL triplet loss and its gradients w.r.t. all three logits, at
    small and large logits (a near-one-hot positive)."""
    rng = np.random.default_rng(0)
    o, p, n = (scale * rng.standard_normal((12, 10)).astype(np.float32)
               for _ in range(3))
    got = _grads(tb.triplets_loss, jb.triplets_loss, o, p, n,
                 argnums=(0, 1, 2))
    _check(got, None)
    assert abs(got[0]) > 5e-4 * scale  # the check has teeth


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_sample", [False, True])
def test_doersch_loss_matches_jax(masked, per_sample):
    """The 9-way cross-entropy with one label a batch or one a sample,
    masked and not."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((8, 9)).astype(np.float32)
    labels = (rng.integers(0, 9, 8) if per_sample
              else np.asarray(rng.integers(9))).astype(np.int32)
    mask = np.array([1, 0, 1, 1, 0, 0, 1, 1], np.float32)
    args = (logits, labels) + ((mask,) if masked else ())
    _check(_grads(tb.doersch_loss, jb.doersch_loss, *args), None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("adjacent", [0, 1])
def test_isola_loss_matches_jax(masked, adjacent):
    """The adjacency BCE, with logits whose p_t falls under machine eps
    (excluded from the sum, still counted by the mask) among them."""
    logits = np.array([[3.0], [-2.0], [0.5], [-50.0], [45.0], [0.0]],
                      np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    args = (logits, np.asarray(adjacent, np.int32)) + (
        (mask,) if masked else ())
    _check(_grads(tb.isola_loss, jb.isola_loss, *args), None)


def test_isola_eps_exclusion_keeps_the_denominator():
    """gt adjacent: the -50 logit's p_t (2e-22) is excluded from the sum
    but the mask's count (3) still divides it."""
    logits = torch.tensor([[3.0], [-2.0], [0.5], [-50.0]])
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
    pred = torch.sigmoid(logits[:, 0]).double()
    want = -(torch.log(pred[0]) + torch.log(pred[1])) / 3.0
    got = tb.isola_loss(logits, torch.tensor(1), mask)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("which", ["doersch", "isola"])
def test_nothing_relevant_gives_zero_not_nan(which):
    """An all-irrelevant batch: loss 0 and zero gradients in both
    packages."""
    rng = np.random.default_rng(2)
    k = 9 if which == "doersch" else 1
    logits = rng.standard_normal((5, k)).astype(np.float32)
    label = np.asarray(1, np.int32)
    mask = np.zeros(5, np.float32)
    fn_t = tb.doersch_loss if which == "doersch" else tb.isola_loss
    fn_j = jb.doersch_loss if which == "doersch" else jb.isola_loss
    got = _grads(fn_t, fn_j, logits, label, mask)
    assert got[0] == 0.0 and got[2] == 0.0
    assert not got[1][0].any() and not got[3][0].any()


def test_doersch_set_patches_bit_for_bit():
    """The same numpy Generator state -> the same (centre, other, label)
    and the same state after, over 32 seeds x 20 draws, at the default
    patch side 11 on 128^2 and a small 3 on 32^2."""
    for sz, p in ((128, 11), (32, 3)):
        for seed in range(32):
            r1 = np.random.default_rng(np.random.SeedSequence([seed, 1, 2]))
            r2 = np.random.default_rng(np.random.SeedSequence([seed, 1, 2]))
            for _ in range(20):
                a, b = ttr.doersch_set_patches(r1, sz, p), \
                    jtr.doersch_set_patches(r2, sz, p)
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
                assert a[2] == b[2] and a[0].dtype == b[0].dtype
            assert r1.random() == r2.random()


def test_isola_set_patches_bit_for_bit():
    """As above for Isola, including a tight geometry (sz < 4p) where the
    adjacency is re-drawn."""
    for sz, p in ((128, 11), (32, 3), (40, 11)):
        for seed in range(32):
            r1 = np.random.default_rng(seed)
            r2 = np.random.default_rng(seed)
            for _ in range(20):
                a, b = ttr.isola_set_patches(r1, sz, p), \
                    jtr.isola_set_patches(r2, sz, p)
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
                assert a[2] == b[2]
            assert r1.random() == r2.random()


def test_negative_order_is_the_jax_trainers():
    """iic_tpu/train/triplets_trainer.py draws each epoch's negatives as
    ``default_rng(SeedSequence([seed, e_i, 77])).permutation(n)``."""
    for seed in range(8):
        for e_i in range(1, 9):
            want = np.random.default_rng(
                np.random.SeedSequence([seed, e_i, 77])).permutation(660)
            np.testing.assert_array_equal(negative_order(seed, e_i, 660),
                                          want)


def _stats_cfg(tmp_path, cls, stats_dir):
    cfg = cls(model_ind=53, arch="SegmentationNet10aDoersch", mode="IID",
              dataset="SyntheticSeg3x64x12", dataset_root="", gt_k=3,
              output_k_A=3, output_k_B=3, num_sub_heads=1, batch_sz=4,
              num_dataloaders=1, out_root=str(tmp_path), input_sz=56,
              include_rgb=True, doersch_stats=stats_dir)
    return cfg.finalize(twohead=False)


def test_doersch_rgb_stats_match_jax_and_read_its_cache(tmp_path):
    """The port's stats within 1e-6 of JAX's on the same frames (and their
    subsample past ``max_imgs``); a cache the JAX function wrote is read
    back as it is."""
    from iic_tpu.data.seg_pipeline import (
        segmentation_create_dataloaders as jax_loaders)
    from iic_tpu.train.config import SegConfig as JSegConfig
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
    from iic_tpu_torch.train.config import SegConfig as TSegConfig

    jcfg = _stats_cfg(tmp_path, JSegConfig, "")
    tcfg = _stats_cfg(tmp_path, TSegConfig, "")
    jpipe = jax_loaders(jcfg)[0]
    tpipe = SegTrainPipeline(tcfg, ["train"], use_native=False)
    for max_imgs in (2000, 5):
        jm, js = jtr.compute_doersch_rgb_stats(jcfg, jpipe, max_imgs)
        tm, ts = ttr.compute_doersch_rgb_stats(tcfg, tpipe, max_imgs)
        np.testing.assert_allclose(tm, jm, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)
        assert tm.dtype == np.float32
    # a cache the JAX function writes; the port reads it
    jcfg.doersch_stats = str(tmp_path / "jax")
    jtr.compute_doersch_rgb_stats(jcfg, jpipe)
    cache = tmp_path / "jax" / f"{jcfg.dataset}_stats.pickle"
    with open(cache, "rb") as f:
        written = pickle.load(f)
    tcfg.doersch_stats = str(tmp_path / "jax")
    tm, ts = ttr.compute_doersch_rgb_stats(tcfg, tpipe)
    np.testing.assert_array_equal(tm, np.float32(written["mean"]))
    np.testing.assert_array_equal(ts, np.float32(written["stddev"]))
    with open(cache, "wb") as f:
        pickle.dump({"mean": np.array([0.1, 0.2, 0.3]),
                     "stddev": np.array([1.0, 2.0, 3.0])}, f)
    tm, ts = ttr.compute_doersch_rgb_stats(tcfg, tpipe)
    np.testing.assert_array_equal(tm, np.float32([0.1, 0.2, 0.3]))
    np.testing.assert_array_equal(ts, np.float32([1.0, 2.0, 3.0]))
    # and a cache the port writes has JAX's keys
    tcfg.doersch_stats = str(tmp_path / "torch")
    ttr.compute_doersch_rgb_stats(tcfg, tpipe)
    with open(tmp_path / "torch" / f"{tcfg.dataset}_stats.pickle",
              "rb") as f:
        assert set(pickle.load(f)) == {"mean", "stddev"}
    assert os.path.exists(cache)


def test_pair_relevance_clamps_like_the_jax_gather():
    """The relevancy mask per pair at centres in range, past the end and
    negative: the JAX trainer's ``vmap(lambda m, c: m[c[0], c[1]])``
    (negative indices count from the end, then clamp)."""
    rng = np.random.default_rng(3)
    mask = (rng.random((6, 10, 12)) > 0.5).astype(np.float32)
    centre = np.array([[0, 0], [9, 11], [15, 3], [-1, 4], [-30, -2],
                       [4, 40]], np.int32)
    other = centre[::-1].copy()
    gather = jax.vmap(lambda m, c: m[c[0], c[1]])
    jm = jnp.asarray(mask)
    want = ((gather(jm, jnp.asarray(centre)) + gather(jm, jnp.asarray(other)))
            > 0).astype(jnp.float32)
    got = ttr.pair_relevance(torch.from_numpy(mask),
                             torch.from_numpy(centre).long(),
                             torch.from_numpy(other).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["doersch", "isola"])
def test_per_sample_draws_match_the_jax_distribution(kind):
    """``--per_sample_patches`` draws of both packages at 128^2, p = 11,
    4096 samples each: the same centre range and offset set, label
    frequencies uniform (each within 0.02 of its expectation in both),
    every pair inside the image."""
    sz, p, n = 128, 11, 4096
    gen = torch.Generator().manual_seed(0)
    if kind == "doersch":
        c, o, lab = ttr.sample_doersch_pairs(gen, n, sz, p, "cpu")
        jc, jo, jlab = jtr.sample_doersch_pairs(jax.random.PRNGKey(0), n,
                                                sz, p)
        k = 9
    else:
        c, o, lab = ttr.sample_isola_pairs(gen, n, sz, p, "cpu")
        jc, jo, jlab = jtr.sample_isola_pairs(jax.random.PRNGKey(0), n, sz,
                                              p)
        k = 2
    c, o, lab = c.numpy(), o.numpy(), lab.numpy()
    jc, jo, jlab = np.asarray(jc), np.asarray(jo), np.asarray(jlab)
    assert (c.min(), c.max()) == (jc.min(), jc.max())
    for a, b in ((o - c, jo - jc),):
        assert {tuple(v) for v in a} == {tuple(v) for v in b}
    for labels in (lab, jlab):
        freq = np.bincount(labels, minlength=k) / n
        np.testing.assert_allclose(freq, 1.0 / k, atol=0.02)
    assert o.min() >= 0 and o.max() < sz
    if kind == "doersch":  # the offset is the label's grid position
        np.testing.assert_array_equal(
            o - c, ttr._POSITIONS[lab] * p)
    else:  # adjacent pairs one patch side away, the others 3-4
        steps = np.abs(o - c).max(1) // p
        assert set(steps[lab == 1]) == {1}
        assert set(steps[lab == 0]) == {3, 4}


def test_doersch_channel_noise_semantics_beside_jax():
    """Colour dropping in both packages on the same images: per image
    exactly one rgb channel kept bit for bit, the grey channel untouched,
    the two others noise at the kept channel's mean and std / 100 (the
    per-image mean within 0.02 of it, the std within 20% of it), and
    each keep-channel's share of 512 images within 0.07 of 1/3."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (512, 4, 16, 16)).astype(np.float32)
    mean3 = np.float32([0.2, 0.5, 0.8])
    std3 = np.float32([1.0, 2.0, 3.0])
    got = ttr.doersch_channel_noise(
        torch.Generator().manual_seed(0), torch.from_numpy(img),
        torch.from_numpy(mean3), torch.from_numpy(std3)).numpy()
    ref = np.asarray(jtr.doersch_channel_noise(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(mean3),
        jnp.asarray(std3)))
    for out in (got, ref):
        np.testing.assert_array_equal(out[:, 3], img[:, 3])
        kept = []
        for i in range(len(img)):
            same = [c for c in range(3) if np.array_equal(out[i, c],
                                                          img[i, c])]
            assert len(same) == 1, same
            k = same[0]
            kept.append(k)
            for c in set(range(3)) - {k}:
                assert abs(out[i, c].mean() - mean3[k]) < 0.02
                assert abs(out[i, c].std() / (std3[k] / 100) - 1) < 0.2
        share = np.bincount(kept, minlength=3) / len(img)
        np.testing.assert_allclose(share, 1 / 3, atol=0.07)
