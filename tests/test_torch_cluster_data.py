"""The clustering data path of the port against the JAX package: the
synthetic and CIFAR readers bit for bit; the deterministic transforms
(centre crop, resize up and down, the tf3 eval path) elementwise; tf2's
composition given the same draws; the random draws' distributions; the
block-wise tiling of the pair augmentation; and the pipelines' batches.
Images are made from numpy seeds. Tolerance for float transforms: atol
1e-5 (f32 resampling and colour arithmetic in different op orders)."""

import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from iic_tpu.data import pipeline as jpipe
from iic_tpu.data import readers as jreaders
from iic_tpu.data import transforms as jt
from iic_tpu.train.config import ClusterConfig as JaxClusterConfig
from iic_tpu_torch.data import pipeline as tpipe
from iic_tpu_torch.data import readers as treaders
from iic_tpu_torch.data import transforms as tt
from iic_tpu_torch.ops.sobel import sobel_filter
from iic_tpu_torch.train.config import ClusterConfig

ATOL = 1e-5
DATASET = "Synthetic10x32x3x64"


def _cfgs(**kw):
    """The same model-640-shaped flags for both packages, finalised."""
    flags = dict(dataset=DATASET, batch_sz=24, num_dataloaders=3,
                 crop_orig=True, rand_crop_sz=20, input_sz=32, gt_k=10,
                 output_k_B=10, output_k_A=15)
    flags.update(kw)
    return (ClusterConfig(**flags).finalize(),
            JaxClusterConfig(**flags).finalize())


def _imgs(seed, b, h, w, c=3):
    return np.random.default_rng(seed).random((b, h, w, c)).astype(
        np.float32)


@pytest.mark.parametrize("name,train", [(DATASET, True), (DATASET, False),
                                        ("Synthetic5x24x1", True)])
def test_synthetic_sets_bit_equal(name, train):
    got = treaders.load_dataset(name, "", train)
    ref = jreaders.load_dataset(name, "", train)
    assert np.array_equal(got["images"], ref["images"])
    assert np.array_equal(got["labels"], ref["labels"])


def _write_cifar(root):
    rng = np.random.default_rng(0)

    def batch(path, n, key):
        d = {"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             key: rng.integers(0, 100 if key == "fine_labels" else 10,
                               n).tolist()}
        with open(path, "wb") as f:
            pickle.dump(d, f)

    c10 = root / "cifar-10-batches-py"
    c10.mkdir()
    for i in range(1, 6):
        batch(c10 / f"data_batch_{i}", 4, "labels")
    batch(c10 / "test_batch", 3, "labels")
    c100 = root / "cifar-100-python"
    c100.mkdir()
    batch(c100 / "train", 5, "fine_labels")
    batch(c100 / "test", 2, "fine_labels")


@pytest.mark.parametrize("name", ["CIFAR10", "CIFAR100", "CIFAR20"])
@pytest.mark.parametrize("train", [True, False])
def test_cifar_readers_bit_equal(tmp_path, name, train):
    """The pickle readers on small files in the CIFAR layout."""
    _write_cifar(tmp_path)
    got = treaders.load_dataset(name, str(tmp_path), train)
    ref = jreaders.load_dataset(name, str(tmp_path), train)
    assert got["images"].shape[1:] == (32, 32, 3)
    assert np.array_equal(got["images"], ref["images"])
    assert np.array_equal(got["labels"], ref["labels"])


@pytest.mark.parametrize("name", ["NoSuchSet"])
def test_unported_readers_raise(name):
    """A dataset name neither package knows."""
    with pytest.raises(ValueError, match=name):
        treaders.load_dataset(name, "", True)


@pytest.mark.parametrize("h,w,crop", [(32, 32, 20), (33, 33, 20),
                                      (24, 31, 17), (20, 20, 20)])
def test_center_crop_matches_jax(h, w, crop):
    """The offset rounds half up, as in the JAX package: exactly equal."""
    img = _imgs(0, 2, h, w)
    ref = jax.vmap(lambda x: jt.center_crop(x, crop))(jnp.asarray(img))
    got = tt.center_crop(torch.from_numpy(img), crop)
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("src,out", [(20, 32), (32, 20), (33, 17), (96, 64),
                                     (17, 17)])
def test_resize_matches_jax(src, out):
    """Bilinear, half-pixel centres, antialiased on downscale."""
    img = _imgs(1, 2, src, src, 4)
    ref = jax.vmap(lambda x: jt.resize(x, out))(jnp.asarray(img))
    got = tt.resize(torch.from_numpy(img), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("include_rgb", [False, True])
def test_mapping_loader_matches_jax(include_rgb):
    """The tf3 eval loader (centre crop 20 -> resize 32 -> grey): the same
    batches, labels and values."""
    tcfg, jcfg = _cfgs(include_rgb=include_rgb, batch_sz=27)
    got = list(tpipe.MappingLoader(tcfg, [True, False]))
    ref = list(jpipe.MappingLoader(jcfg, [True, False]))
    assert len(got) == len(ref) == 4  # 64 + 40 images in 27s, ragged last
    for (gi, gl), (ri, rl) in zip(got, ref):
        assert gi.shape == (len(rl), 4 if include_rgb else 1, 32, 32)
        np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=ATOL)
        assert np.array_equal(gl, np.asarray(rl))


def test_tf2_given_draws_matches_jax_composition():
    """tf2 = crop -> resize -> flip -> jitter -> grey: the port's apply with
    fixed draws against the JAX building blocks composed in the JAX tf2's
    order with the same draws."""
    tcfg, _ = _cfgs(include_rgb=True)
    _, tf2, _ = tt.make_sobel_pair_transforms(tcfg)
    img = _imgs(2, 3, 32, 32)
    draws = dict(top=torch.tensor([0, 12, 5]), left=torch.tensor([12, 0, 7]),
                 flip=torch.tensor([True, False, True]),
                 jitter_factors=torch.tensor([[1.2, 0.8, 1.3, 0.05],
                                              [0.7, 1.1, 0.6, -0.1],
                                              [1.0, 1.4, 0.9, 0.12]]),
                 jitter_order=torch.tensor([[2, 0, 3, 1], [3, 1, 0, 2],
                                            [0, 1, 2, 3]]))
    got = tf2.apply(torch.from_numpy(img), draws).numpy()
    ops = [jt._adjust_brightness, jt._adjust_contrast, jt._adjust_saturation,
           jt._adjust_hue]
    for i in range(3):
        x = jax.lax.dynamic_slice(
            jnp.asarray(img[i]), (int(draws["top"][i]),
                                  int(draws["left"][i]), 0), (20, 20, 3))
        x = jt.resize(x, 32)
        if draws["flip"][i]:
            x = x[:, ::-1, :]
        for op in draws["jitter_order"][i].tolist():
            x = ops[op](x, float(draws["jitter_factors"][i, op]))
        np.testing.assert_allclose(got[i], np.asarray(jt.append_grey(x, True)),
                                   atol=ATOL)


def _assert_uniform_ints(values, lo, hi, name):
    values = np.asarray(values)
    assert values.min() >= lo and values.max() < hi, name
    counts = np.bincount(values - lo, minlength=hi - lo)
    assert counts.min() > 0, f"{name}: support not covered: {counts}"
    assert stats.chisquare(counts)[1] > 1e-4, f"{name}: {counts}"


def test_random_crop_and_flip_draws_match_jax_distribution():
    """Crop corners uniform over the same valid positions in both packages
    (read back from a ramp image), and tf2's flips at rate 1/2 in both
    (binomial bound)."""
    n, side, crop = 3000, 32, 20
    ramp = (np.arange(side * side, dtype=np.float32)
            .reshape(1, side, side, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    corner = jax.vmap(lambda k: jt.random_crop(jnp.asarray(ramp[0]), k,
                                               crop)[0, 0, 0])(keys)
    gen = torch.Generator().manual_seed(0)
    tcorner = tt.random_crop(torch.from_numpy(ramp).expand(n, -1, -1, -1),
                             crop, gen)[:, 0, 0, 0]
    for name, c in (("jax", np.asarray(corner)), ("torch", tcorner.numpy())):
        c = c.astype(np.int64)
        _assert_uniform_ints(c // side, 0, side - crop + 1, f"{name} top")
        _assert_uniform_ints(c % side, 0, side - crop + 1, f"{name} left")
    tcfg, _ = _cfgs()
    flipped = tt.make_sobel_pair_transforms(tcfg)[1].draw(
        n, side, side, gen, "cpu")["flip"]
    jflipped = jax.vmap(lambda k: jt.random_flip(jnp.asarray(ramp[0]), k)
                        [0, 0, 0])(keys) != 0
    for rate in (float(flipped.float().mean()), float(np.mean(jflipped))):
        assert abs(rate - 0.5) < 4 * (0.25 / n) ** 0.5


def test_augment_pair_tiles_block_wise_like_jax():
    """Two constant grey images (0.1 and 0.7), r = 3: tf1 rows are image
    j % 2 exactly, tiled block-wise as JAX's ``jnp.tile``; each tf2 row is
    image j % 2 under its own brightness draw (the two ranges are
    disjoint), in both packages."""
    tcfg, jcfg = _cfgs()
    base = np.stack([np.full((32, 32, 3), v, np.uint8) for v in (26, 178)])
    pipe = tpipe.ClusterTrainPipeline(tcfg, [True], preloaded=(base, None))
    imgs, imgs_tf = pipe.augment_pair(torch.from_numpy(base),
                                      torch.Generator().manual_seed(0))
    jpipe_ = jpipe.ClusterTrainPipeline(jcfg, [True],
                                        preloaded=(base, np.zeros(2)))
    jimgs, jimgs_tf = jpipe_.augment_pair(jnp.asarray(base),
                                          jax.random.PRNGKey(0))
    assert imgs.shape == imgs_tf.shape == tuple(jimgs.shape) == (6, 1, 32, 32)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), atol=ATOL)
    for tf in (imgs_tf.numpy(), np.asarray(jimgs_tf)):
        means = tf.reshape(6, -1).mean(axis=1)
        assert np.all(means[0::2] < 0.2) and np.all(means[1::2] > 0.35)


def test_pipelines_yield_the_jax_batches():
    """Sequential order over train + test, ragged last batch kept, the same
    base images per batch; head B's pipeline is seeded seed + 1 and shares
    the images."""
    tcfg, jcfg = _cfgs(batch_sz=27)
    pa, pb, ma, mt = tpipe.cluster_twohead_create_dataloaders(tcfg, seed=3)
    ja, _, _, _ = jpipe.cluster_twohead_create_dataloaders(jcfg, seed=3)
    got = [b.numpy() for b, _ in pa.epoch(1)]
    ref = [np.asarray(b) for b, _ in ja.epoch(1, augmented=False)]
    assert len(got) == len(ref) == 12  # 64 + 40 images in 9s
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    assert (pa.seed, pb.seed) == (3, 4)
    assert pb.images is pa.images and ma.images is pa.images
    assert len(ma) == len(mt) == 4
    imgs, imgs_tf = next(pa.epoch(1, augmented=True))
    assert imgs.shape == imgs_tf.shape == (27, 1, 32, 32)


def test_demean_options_match_jax():
    """tf3 with --demean (data mean / std) and --per_img_demean."""
    kw = dict(demean=True, data_mean=(0.5,), data_std=(0.25,),
              per_img_demean=True)
    tcfg, jcfg = _cfgs(**kw)
    img = _imgs(3, 2, 32, 32)
    ref = jax.vmap(jt.make_sobel_pair_transforms(jcfg)[2])(jnp.asarray(img))
    got = tt.make_sobel_pair_transforms(tcfg)[2](torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _pair_statistics(imgs, imgs_tf, b):
    """Per-image statistics of a sobel pair batch (NCHW, rgb + grey; tf1
    tiled block-wise, so its first ``b`` rows are the images): for tf1 and
    for tf2, each channel's mean and variance and the grey channel's mean
    sobel magnitude; and each tf2 row's mean |tf1 - tf2|."""
    imgs, imgs_tf = (torch.from_numpy(np.array(x)) for x in (imgs, imgs_tf))
    out = {}
    for name, x in (("tf1", imgs[:b]), ("tf2", imgs_tf)):
        for c in range(x.shape[1]):
            out[f"{name} channel {c} mean"] = x[:, c].mean((1, 2))
            out[f"{name} channel {c} var"] = x[:, c].var((1, 2))
        d = sobel_filter(x[:, 3:4])
        out[f"{name} sobel magnitude"] = d.square().sum(1).sqrt().mean((1, 2))
    out["|tf1 - tf2|"] = (imgs - imgs_tf).abs().mean((1, 2, 3))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("tf2_jitter", [True, False])
def test_sobel_pair_statistics_match_jax(tf2_jitter, monkeypatch):
    """The learning evidence's pair (crop 28 -> 32, ``--include_rgb``, 2
    dataloaders) from the port's ``augment_pair`` and from JAX's on the
    same 600 synthetic uint8 images, each drawing its own: a two-sample
    Kolmogorov-Smirnov test on each per-image statistic of
    ``_pair_statistics`` (19 of them), the method of
    tests/test_transform_parity.py (p floor 1e-4). Without tf2's colour
    jitter in the port (the mutant, ``tf2_jitter=False``) some statistic
    must fall under the floor."""
    n = 600
    tcfg, jcfg = _cfgs(num_dataloaders=2, batch_sz=2 * n, rand_crop_sz=28,
                       include_rgb=True)
    base = treaders.load_dataset("Synthetic10x32x3x2048", "", True)[
        "images"][:n]
    if not tf2_jitter:
        monkeypatch.setattr(tt, "color_jitter_with", lambda img, f, o: img)
    pipe = tpipe.ClusterTrainPipeline(tcfg, [True], preloaded=(base, None))
    got = _pair_statistics(*pipe.augment_pair(
        torch.from_numpy(base), torch.Generator().manual_seed(0)), n)
    jpipe_ = jpipe.ClusterTrainPipeline(jcfg, [True],
                                        preloaded=(base, np.zeros(n)))
    ref = _pair_statistics(*jax.jit(jpipe_.augment_pair)(
        jnp.asarray(base), jax.random.PRNGKey(0)), n)
    assert len(got) == 19
    p = {k: stats.ks_2samp(got[k], ref[k]).pvalue for k in got}
    low = {k: v for k, v in p.items() if v <= 1e-4}
    if tf2_jitter:
        assert not low, low
    else:
        assert low, p
