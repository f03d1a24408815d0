"""The sobel tf2's flags of the port against the JAX package: the random
affine (``--use_random_affine``, the semisup finetune's
``--random_affine``), the cutout (``--cutout``) and the fluid warp
(``--fluid_warp`` with ``--rot_val`` and ``--rand_crop_szs_tf``).

The port's tf2 is applied to the draws the JAX tf2 makes from its keys
(each of its key splits replayed: the crop, the affine's six, the
cutout's coin and its three, the flip, the jitter, the rotation) and held
to the JAX tf2 at atol 1e-5 (f32 resampling and colour arithmetic in
different op orders); the draws' distributions are held beside JAX's
separately. Images are made from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from iic_tpu.data import transforms as jt
from iic_tpu_torch.cli import cluster_sobel, cluster_sobel_twohead
from iic_tpu_torch.data import pipeline as tpipe
from iic_tpu_torch.data import transforms as tt
from test_torch_cluster_data import ATOL, _cfgs, _imgs
from test_torch_cluster_grey import (
    _jax_choice_draw, _jax_crop_draw, _jax_jitter_draw, _jax_rotation_draw,
    _keys, _rate_ok, _stack)

H = W = 32  # the images; _cfgs crops 20 and resizes to 32


# ------------------------------------------------- JAX's draws, from its keys

AFFINE = ("affine_angle", "affine_shear", "affine_scale", "affine_tx",
          "affine_ty", "affine")
CUTOUT = ("cut_box", "cut_x", "cut_y")


def _torch_draws(names, values):
    return {n: torch.from_numpy(np.array(v)) for n, v in zip(names, values)}


def _jax_affine_draws(keys, p):
    """``random_affine_img``'s six splits of each key: angle, shear
    (degrees), scale, the translations (times 2) and the coin."""
    def one(key):
        ks = jax.random.split(key, 6)

        def u(k, lo, hi):
            return jax.random.uniform(k, (), minval=lo, maxval=hi)

        return (u(ks[0], -18.0, 18.0), u(ks[1], -10.0, 10.0),
                u(ks[2], 0.9, 1.1), u(ks[3], -0.1, 0.1) * 2.0,
                u(ks[4], -0.1, 0.1) * 2.0, jax.random.bernoulli(ks[5], p))

    return _torch_draws(AFFINE, jax.vmap(one)(keys))


def _jax_cutout_draws(keys, side, min_box, max_box):
    """``random_cutout``'s three splits of each key: the box side, then
    the centre as half + floor(U[0, 1) * (side - 2 * half))."""
    def one(key):
        kb, kx, ky = jax.random.split(key, 3)
        box = jax.random.randint(kb, (), min_box, max_box + 1)
        half = box // 2
        n = jnp.maximum(side - 2 * half, 1)
        return (box,
                half + jnp.floor(jax.random.uniform(kx, ()) * n).astype(int),
                half + jnp.floor(jax.random.uniform(ky, ()) * n).astype(int))

    return _torch_draws(CUTOUT, jax.vmap(one)(keys))


def _jax_sobel_tf2_draws(cfg, keys, h, w):
    """The draws JAX's sobel tf2 makes from each key: ``split(key, 7)`` ->
    crop (or choice crop), flip, jitter, affine, cutout coin, cutout,
    rotation."""
    ks = [jax.random.split(k, 7) for k in keys]
    draws = {}
    if cfg.fluid_warp:
        if cfg.rot_val > 0:
            draws.update(_stack([_jax_rotation_draw(k[6], cfg.rot_val)
                                 for k in ks], ("angle", "rotate")))
            draws["angle"] = draws["angle"].float()
        szs = tuple(cfg.rand_crop_szs_tf) or (cfg.rand_crop_sz,)
        draws.update(_stack([_jax_choice_draw(k[0], h, w, szs, "random")
                             for k in ks], ("choice", "top", "left")))
    else:
        draws.update(_stack([_jax_crop_draw(k[0], h, w, cfg.rand_crop_sz,
                                            "random") for k in ks],
                            ("top", "left")))
    split = jnp.stack(ks)
    if getattr(cfg, "use_random_affine", False):
        draws.update(_jax_affine_draws(split[:, 3], cfg.affine_p))
    if cfg.cutout:
        sz = cfg.rand_crop_sz
        draws["cutout"] = torch.tensor(
            [bool(jax.random.bernoulli(k[4], cfg.cutout_p)) for k in ks])
        draws.update(_jax_cutout_draws(split[:, 5], sz, int(sz * 0.2),
                                       int(sz * cfg.cutout_max_box)))
    draws["flip"] = torch.tensor([bool(jax.random.bernoulli(k[1]))
                                  for k in ks])
    f, o = zip(*[_jax_jitter_draw(k[2]) for k in ks])
    draws["jitter_factors"] = torch.tensor(np.array(f, np.float32))
    draws["jitter_order"] = torch.tensor(np.array(o))
    return draws


def _both_cfgs(**flags):
    """``_cfgs`` of test_torch_cluster_data, with the two flags the JAX
    ``ClusterConfig`` lacks (the semisup trainer sets them on its copy)
    set on both."""
    extra = {k: flags.pop(k) for k in ("use_random_affine", "affine_p")
             if k in flags}
    tcfg, jcfg = _cfgs(**flags)
    for cfg in (tcfg, jcfg):
        for k, v in extra.items():
            setattr(cfg, k, v)
    return tcfg, jcfg


# ------------------------------------------------------ the pieces alone

def test_random_affine_given_jax_draws_matches_jax():
    """``affine_where`` on ``random_affine_img``'s draws, 48 samples at
    p = 0.75: the draws span scales on both sides of 1 and shears of both
    signs, and the warped samples equal JAX's."""
    img = _imgs(0, 48, 20, 20)
    keys = _keys(1, 48)
    draws = _jax_affine_draws(keys, 0.75)
    scale, shear = draws["affine_scale"], draws["affine_shear"]
    assert scale.min() < 0.93 and scale.max() > 1.07
    assert shear.min() < -6 and shear.max() > 6
    assert 0 < int(draws["affine"].sum()) < 48
    ref = jax.vmap(lambda x, k: jt.random_affine_img(x, k, p=0.75))(
        jnp.asarray(img), keys)
    got = tt.affine_where(torch.from_numpy(img), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("scale", [0.9, 1.1])
def test_affine_scale_magnifies_above_one(scale):
    """The forward content map, not its inverse, reaches the image: a
    centred square grows by ``scale`` squared in area (a theta passed
    uninverted would shrink it where it should magnify)."""
    img = torch.zeros((1, 41, 41, 1))
    img[:, 10:31, 10:31] = 1.0
    zero = torch.zeros(1)
    draws = dict(affine_angle=zero, affine_shear=zero,
                 affine_scale=torch.tensor([scale]), affine_tx=zero,
                 affine_ty=zero, affine=torch.ones(1, dtype=torch.bool))
    area = float(tt.affine_where(img, draws).sum())
    assert abs(area / float(img.sum()) - scale ** 2) < 0.03


def test_random_cutout_given_jax_draws_matches_jax():
    """``cutout_where`` on ``random_cutout``'s draws zeroes the same box,
    bit for bit, over sides 4-14 of a 20-pixel crop."""
    img = _imgs(2, 64, 20, 20)
    keys = _keys(3, 64)
    draws = _jax_cutout_draws(keys, 20, 4, 14)
    draws["cutout"] = torch.ones(64, dtype=torch.bool)
    assert len(set(draws["cut_box"].tolist())) > 6
    ref = jax.vmap(lambda x, k: jt.random_cutout(x, k, 4, 14))(
        jnp.asarray(img), keys)
    got = tt.cutout_where(torch.from_numpy(img), draws)
    assert np.array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------- tf2 whole

TF2_CASES = [
    dict(use_random_affine=True, affine_p=0.5),
    dict(cutout=True, cutout_p=0.5, cutout_max_box=0.7),
    # table 3's: --random_affine --affine_p 0.5 --cutout --cutout_p 0.5
    # --cutout_max_box 0.7
    dict(use_random_affine=True, affine_p=0.5, cutout=True, cutout_p=0.5,
         cutout_max_box=0.7),
    dict(use_random_affine=True, affine_p=1.0, cutout=True, cutout_p=1.0,
         include_rgb=True),
    dict(fluid_warp=True),
    dict(fluid_warp=True, rot_val=25.0),
    dict(fluid_warp=True, rand_crop_szs_tf=(16, 20, 24)),
    dict(fluid_warp=True, rot_val=25.0, rand_crop_szs_tf=(16, 20, 24),
         use_random_affine=True, affine_p=0.5, include_rgb=True),
]


@pytest.mark.parametrize("flags", TF2_CASES)
def test_sobel_tf2_given_jax_draws_matches_jax(flags):
    """tf2 with the flags, applied to the draws the JAX tf2 makes from its
    keys, against the JAX package's tf2 (vmapped over the keys)."""
    tcfg, jcfg = _both_cfgs(**flags)
    img = _imgs(4, 24, H, W)
    keys = _keys(5, 24)
    draws = _jax_sobel_tf2_draws(jcfg, keys, H, W)
    got = tt.make_sobel_pair_transforms(tcfg)[1].apply(
        torch.from_numpy(img), draws)
    ref = jax.vmap(jt.make_sobel_pair_transforms(jcfg)[1])(
        jnp.asarray(img), keys)
    assert got.shape == (24, 32, 32, 4 if tcfg.include_rgb else 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("flags", TF2_CASES[2:])
def test_sobel_tf2_draws_are_what_apply_reads(flags):
    """``tf2.draw`` makes every draw ``tf2.apply`` reads (the same keys as
    JAX's draws), and ``tf2(img, g)`` is ``apply(img, draw(g))``."""
    tcfg, jcfg = _both_cfgs(**flags)
    tf2 = tt.make_sobel_pair_transforms(tcfg)[1]
    draws = tf2.draw(5, H, W, torch.Generator().manual_seed(3), "cpu")
    assert set(draws) == set(_jax_sobel_tf2_draws(jcfg, _keys(0, 1), H, W))
    x = torch.from_numpy(_imgs(8, 5, H, W))
    assert torch.equal(tf2(x, torch.Generator().manual_seed(3)),
                       tf2.apply(x, draws))


def test_cutout_with_fluid_warp_raises_as_jax_does():
    tcfg, jcfg = _both_cfgs(cutout=True, fluid_warp=True)
    with pytest.raises(ValueError, match="fluid_warp"):
        tt.make_sobel_pair_transforms(tcfg)
    with pytest.raises(AssertionError):
        jt.make_sobel_pair_transforms(jcfg)


# -------------------------------------------------------- distributions

def test_affine_draws_are_distributed_as_jax_draws():
    """Over 4000 draws of each package: angle, shear, scale and the
    translations uniform in their ranges (KS) and alike between the
    packages (two-sample KS), the coin at rate p."""
    n, p = 4000, 0.3
    got = tt.draw_affine(n, torch.Generator().manual_seed(0), "cpu", p=p)
    ref = _jax_affine_draws(_keys(9, n), p)
    for name, lo, hi in (("affine_angle", -18, 18),
                         ("affine_shear", -10, 10),
                         ("affine_scale", 0.9, 1.1),
                         ("affine_tx", -0.2, 0.2), ("affine_ty", -0.2, 0.2)):
        a, b = got[name].numpy(), ref[name].numpy()
        for v in (a, b):
            assert lo <= v.min() and v.max() <= hi, name
            assert stats.kstest(v, stats.uniform(lo, hi - lo).cdf).pvalue \
                > 1e-4, name
        assert stats.ks_2samp(a, b).pvalue > 1e-4, name
    for coin in (got["affine"], ref["affine"]):
        assert _rate_ok(float(coin.float().mean()), p, n)


def test_cutout_draws_are_distributed_as_jax_draws():
    """Over 4000 draws at a 20-pixel crop, sides 4-14: every side alike in
    both (chi-square against uniform), the centres inside the valid range
    and alike (two-sample KS on x and y), the coin at rate p."""
    n, side, lo, hi = 4000, 20, 4, 14
    got = tt.draw_cutout(n, side, side, lo, hi,
                         torch.Generator().manual_seed(1), "cpu", p=0.5)
    ref = _jax_cutout_draws(_keys(10, n), side, lo, hi)
    for d in (got, ref):
        box = d["cut_box"].numpy()
        counts = np.bincount(box - lo, minlength=hi - lo + 1)
        assert len(counts) == hi - lo + 1 and counts.min() > 0
        assert stats.chisquare(counts)[1] > 1e-4
        half = box // 2
        for c in ("cut_x", "cut_y"):
            v = d[c].numpy()
            assert (v >= half).all() and (v + half <= side).all()
    for c in CUTOUT:
        assert stats.ks_2samp(got[c].numpy(), ref[c].numpy()).pvalue > 1e-4
    assert _rate_ok(float(got["cutout"].float().mean()), 0.5, n)


# ---------------------------------------------------- through the CLIs

@pytest.mark.parametrize("cli", [cluster_sobel, cluster_sobel_twohead])
@pytest.mark.parametrize("flags", [
    ["--cutout", "--cutout_p", "0.5", "--cutout_max_box", "0.7"],
    ["--fluid_warp", "--rot_val", "25", "--rand_crop_szs_tf", "16", "20"]])
def test_sobel_clis_take_the_flags(cli, flags):
    """Both sobel CLIs' configs carry the flags into the pipeline, whose
    augment_pair gives the pair at the net's input size."""
    argv = ["--dataset", "Synthetic10x32x3x64", "--batch_sz", "6",
            "--num_dataloaders", "2", "--crop_orig", "--rand_crop_sz", "20",
            "--input_sz", "24", "--output_k", "10"] + flags
    cfg = cli.config(argv)
    assert cfg.cutout == ("--cutout" in flags)
    assert cfg.fluid_warp == ("--fluid_warp" in flags)
    pipe = tpipe.ClusterTrainPipeline(cfg, [True])
    imgs, imgs_tf = next(pipe.epoch(0, augmented=True))
    assert imgs.shape == imgs_tf.shape == (6, 1, 24, 24)


@pytest.mark.parametrize("flags", [{}, TF2_CASES[2]])
def test_tf2_pairs_reach_the_net_in_one_memory_format(flags):
    """The pair augmentation's two grey images have equal strides: tf2's
    grey output (made from the hue adjustment's channel planes) is laid
    out as tf1's, so both images of a pair go through the net in one
    memory format (a mixed pair costs each step layout transforms and
    slower BatchNorm kernels on the card)."""
    tcfg, _ = _both_cfgs(**flags)
    pipe = tpipe.ClusterTrainPipeline(tcfg, [True])
    imgs, imgs_tf = next(pipe.epoch(0, augmented=True))
    assert imgs.stride() == imgs_tf.stride()
