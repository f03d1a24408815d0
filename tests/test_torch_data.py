"""The port's device ops and data path against the JAX package: Sobel in
its four channel layouts, the exact affine warp against JAX impl="gather",
the colour-jitter adjusts and the flip / affine composition given the same
draws, the host crop geometry, and SyntheticSeg bit for bit. Inputs are
made from a numpy seed."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu.data import transforms as jt
from iic_tpu.data import seg_transforms as jst
from iic_tpu.data.seg_datasets import SyntheticSeg as JaxSyntheticSeg
from iic_tpu.data.seg_datasets import (
    SyntheticSegStripes as JaxSyntheticSegStripes)
from iic_tpu.data.seg_pipeline import seg_partitions as jax_partitions
from iic_tpu.ops.affine import perform_affine_tf as jax_affine
from iic_tpu.ops.sobel import sobel_process as jax_sobel
from iic_tpu_torch.data import seg_pipeline as tp
from iic_tpu_torch.data import seg_transforms as tst
from iic_tpu_torch.data import transforms as tt
from iic_tpu_torch.data.seg_datasets import SyntheticSeg, SyntheticSegStripes
from iic_tpu_torch.ops.affine import perform_affine_tf
from iic_tpu_torch.ops.sobel import sobel_process


@pytest.mark.parametrize("using_ir,include_rgb,c", [
    (False, False, 1), (False, True, 4), (True, False, 2), (True, True, 5)])
def test_sobel_layouts_match_jax(using_ir, include_rgb, c):
    """All four layouts, exact to f32 rounding (atol 1e-5)."""
    x = np.random.default_rng(c).random((2, c, 9, 11)).astype(np.float32)
    ref = np.asarray(jax_sobel(jnp.asarray(x), include_rgb, using_IR=using_ir))
    got = sobel_process(torch.from_numpy(x), include_rgb,
                        using_IR=using_ir).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("hw", [(12, 12), (9, 14)])
def test_affine_warp_matches_jax_gather(hw):
    """grid_sample(align_corners=True, zeros) vs the JAX exact gather warp:
    atol 1e-5 (bilinear weights in f32)."""
    rng = np.random.default_rng(1)
    data = rng.random((4, 3, *hw)).astype(np.float32)
    a = np.radians(rng.uniform(-30, 30, 4))
    theta = np.zeros((4, 2, 3), np.float32)
    theta[:, 0, 0], theta[:, 0, 1] = np.cos(a) * 1.1, -np.sin(a)
    theta[:, 1, 0], theta[:, 1, 1] = np.sin(a), np.cos(a) * 0.9
    theta[:, :, 2] = rng.uniform(-0.2, 0.2, (4, 2))
    theta[1, 0] *= -1.0
    ref = np.asarray(jax_affine(jnp.asarray(data), jnp.asarray(theta),
                                impl="gather"))
    got = perform_affine_tf(torch.from_numpy(data),
                            torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


ADJUSTS = [("brightness", jt._adjust_brightness, tt.adjust_brightness, 1.3),
           ("contrast", jt._adjust_contrast, tt.adjust_contrast, 0.7),
           ("saturation", jt._adjust_saturation, tt.adjust_saturation, 1.4),
           ("hue", jt._adjust_hue, tt.adjust_hue, 0.11),
           ("hue_negative", jt._adjust_hue, tt.adjust_hue, -0.09)]


@pytest.mark.parametrize("name,jax_fn,torch_fn,f", ADJUSTS)
def test_colour_adjusts_match_jax(name, jax_fn, torch_fn, f):
    """Each adjust with the same factor: atol 1e-5."""
    img = np.random.default_rng(2).random((2, 6, 7, 3)).astype(np.float32)
    ref = np.stack([np.asarray(jax_fn(jnp.asarray(im), f)) for im in img])
    got = torch_fn(torch.from_numpy(img), torch.full((2,), f)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_grey_and_jitter_order_match_jax():
    """append_grey, and the four adjusts composed in a given order, against
    the JAX ops applied in that order: atol 1e-5."""
    rng = np.random.default_rng(4)
    img = rng.random((2, 5, 5, 3)).astype(np.float32)
    factors = np.array([[1.2, 0.8, 1.3, 0.05], [0.7, 1.1, 0.6, -0.1]],
                       np.float32)
    order = np.array([[2, 0, 3, 1], [3, 1, 0, 2]])
    ops = [jt._adjust_brightness, jt._adjust_contrast, jt._adjust_saturation,
           jt._adjust_hue]
    ref = []
    for im, fs, od in zip(img, factors, order):
        x = jnp.asarray(im)
        for op in od:
            x = ops[op](x, fs[op])
        ref.append(np.asarray(jt.append_grey(x, True)))
    got = tt.append_grey(tt.color_jitter_with(
        torch.from_numpy(img), torch.from_numpy(factors),
        torch.from_numpy(order)), True).numpy()
    np.testing.assert_allclose(got, np.stack(ref), atol=1e-5)


def _seg_cfg(**kw):
    cfg = dict(using_IR=False, sobel=True, include_rgb=True, flip_p=0.5,
               use_random_affine=True, jitter_brightness=0.4,
               jitter_contrast=0.4, jitter_saturation=0.4, jitter_hue=0.125)
    cfg.update(kw)
    return SimpleNamespace(**cfg)


def _jax_channels(rgb, ir, sobel, include_rgb):
    """The JAX pipeline's per-image channel prep (seg_pipeline.py:55-63)."""
    if sobel:
        x = jt.append_grey(rgb, include_rgb)
    else:
        x = rgb if include_rgb else jt.to_grey(rgb)
    if ir is not None:
        x = jnp.concatenate([x, ir], axis=-1)
    return jnp.transpose(x, (2, 0, 1))


@pytest.mark.parametrize("sobel,include_rgb,using_ir,affine,c_out", [
    (True, True, False, True, 4), (True, False, True, False, 1),
    (False, True, False, True, 3), (False, False, True, True, 1)])
def test_augment_composition_matches_jax(sobel, include_rgb, using_ir,
                                         affine, c_out):
    """Given the same draws (jitter factors and order; rotation, shear,
    scale; flip uniform), img1, img2 and affine2_to_1 match the JAX
    pipeline's composition: its jitter of img2, its channel prep, JAX's RSS
    matrix formula with its exact warp, then the flip that negates the
    affine's top row when uniform > flip_p. atol 1e-5."""
    rng = np.random.default_rng(5)
    b, sz = 3, 10
    imgs = rng.integers(0, 256, (b, sz, sz, 4 if using_ir else 3),
                        dtype=np.uint8)
    masks = (rng.random((b, sz, sz)) > 0.5).astype(np.uint8)
    factors = np.array([[1.2, 0.8, 1.3, 0.05], [0.7, 1.1, 0.6, -0.1],
                        [1.0, 1.3, 0.9, 0.12]], np.float32)
    order = np.array([[2, 0, 3, 1], [3, 1, 0, 2], [0, 1, 2, 3]])
    affine_u = rng.random((b, 3)).astype(np.float32)
    flip_u = np.array([0.2, 0.9, 0.7], np.float32)
    draws = dict(jitter_factors=torch.from_numpy(factors),
                 jitter_order=torch.from_numpy(order),
                 affine_u=torch.from_numpy(affine_u),
                 flip_u=torch.from_numpy(flip_u))
    cfg = _seg_cfg(sobel=sobel, include_rgb=include_rgb, using_IR=using_ir,
                   use_random_affine=affine)
    img1, img2, aff, m = tp.make_seg_augment(cfg).apply(
        torch.from_numpy(imgs), torch.from_numpy(masks), draws)
    assert img1.shape == img2.shape == (b, c_out + int(using_ir), sz, sz)

    ops = [jt._adjust_brightness, jt._adjust_contrast, jt._adjust_saturation,
           jt._adjust_hue]
    for i in range(b):
        img = jnp.asarray(imgs[i], jnp.float32) / 255.0
        rgb, ir = (img[..., :3], img[..., 3:4]) if using_ir else (img, None)
        jit = rgb
        for op in order[i]:
            jit = ops[op](jit, factors[i, op])
        x1 = _jax_channels(rgb, ir, sobel, include_rgb)
        x2 = _jax_channels(jit, ir, sobel, include_rgb)
        ref_aff = np.array([[1.0, 0, 0], [0, 1.0, 0]])
        if affine:
            rot = -30 + affine_u[i, 0] * 60
            shear = -10 + affine_u[i, 1] * 20
            scale = 0.8 + affine_u[i, 2] * 0.4
            a, sh = np.radians(rot), np.radians(shear)
            fwd = np.array([[np.cos(a) * scale, -np.sin(a + sh) * scale, 0],
                            [np.sin(a) * scale, np.cos(a + sh) * scale, 0]],
                           np.float32)
            x2 = jax_affine(x2[None], jnp.asarray(fwd)[None],
                            impl="gather")[0]
            ref_aff = np.concatenate([np.linalg.inv(fwd[:, :2]),
                                      np.zeros((2, 1))], 1)
        if flip_u[i] > 0.5:
            x2 = x2[:, :, ::-1]
            ref_aff[0] *= -1.0
        np.testing.assert_allclose(img1[i].numpy(), np.asarray(x1),
                                   atol=1e-6)
        np.testing.assert_allclose(img2[i].numpy(), np.asarray(x2),
                                   atol=1e-5)
        np.testing.assert_allclose(aff[i].numpy(), ref_aff, atol=1e-5)
    np.testing.assert_array_equal(m.numpy(), masks)


def test_rss_affine_matches_jax_seg_random_affine():
    """The JAX draw's matrix pair, rebuilt from its own uniforms: the
    port's rss_affines gives the same affine2_to_1 (atol 1e-6)."""
    key = jax.random.PRNGKey(3)
    _, aff_jax = jst.seg_random_affine(jnp.zeros((3, 6, 6)), key)
    ks = jax.random.split(key, 3)
    draws = [float(jax.random.uniform(ks[0], (), minval=-30.0, maxval=30.0)),
             float(jax.random.uniform(ks[1], (), minval=-10.0, maxval=10.0)),
             float(jax.random.uniform(ks[2], (), minval=0.8, maxval=1.2))]
    _, inv = tst.rss_affines(*[torch.tensor([d]) for d in draws])
    np.testing.assert_allclose(inv[0].numpy(), np.asarray(aff_jax),
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["centre", "random", "fixed"])
def test_pad_and_or_crop_matches_jax(mode):
    """Same crop centre and pixels for the same numpy rng stream."""
    img = np.arange(7 * 5 * 3, dtype=np.uint8).reshape(7, 5, 3)
    kw = dict(coords=(4, 3)) if mode == "fixed" else {}
    ref, c_ref = jst.pad_and_or_crop(img, 6, mode=mode,
                                     rng=np.random.default_rng(1), **kw)
    got, c_got = tst.pad_and_or_crop(img, 6, mode=mode,
                                     rng=np.random.default_rng(1), **kw)
    assert c_got == c_ref
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cls_pair,name,split", [
    ((SyntheticSeg, JaxSyntheticSeg), "SyntheticSeg3x20x6", "train"),
    ((SyntheticSeg, JaxSyntheticSeg), "SyntheticSegPotsdam3x16x40", "test"),
    ((SyntheticSegStripes, JaxSyntheticSegStripes),
     "SyntheticSegStripes4x24x5", "train")])
def test_synthetic_datasets_bit_equal(cls_pair, name, split):
    """The synthetic sets are the same arrays, bit for bit, and the host
    train / test samples agree for the same rng."""
    cfg = SimpleNamespace(dataset=name, input_sz=12,
                          gt_k=int(name.split("x")[0][-1]))
    ours, theirs = (c(cfg, split, "train") for c in cls_pair)
    np.testing.assert_array_equal(ours.images, theirs.images)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    for a, b in zip(ours.get_train(1, np.random.default_rng(9)),
                    theirs.get_train(1, np.random.default_rng(9))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.get_test(0), theirs.get_test(0)):
        np.testing.assert_array_equal(a, b)


def _pipe_cfg(**kw):
    cfg = dict(dataset="SyntheticSeg3x20x10", dataset_root="", mode="IID",
               gt_k=3, input_sz=16, batch_sz=4, num_dataloaders=1,
               dataloader_batch_sz=4, eval_batch_sz=None, using_IR=False,
               sobel=True, include_rgb=True, flip_p=0.5,
               use_random_affine=False, jitter_brightness=0.4,
               jitter_contrast=0.4, jitter_saturation=0.4, jitter_hue=0.125,
               pre_scale_all=False, use_random_scale=False)
    cfg.update(kw)
    return SimpleNamespace(**cfg)


@pytest.mark.parametrize("repeats", [1, 2])
def test_host_batches_match_jax_pipeline(repeats):
    """The port's host batches (order, repeats and crops) equal the JAX
    pipeline's numpy path for the same seed and epoch: 10 images in base
    batches of 4, each repeated ``repeats`` times with its own crops."""
    from iic_tpu.data.seg_pipeline import SegTrainPipeline as JaxPipe
    cfg = _pipe_cfg(num_dataloaders=repeats, batch_sz=4 * repeats)
    ours = tp.SegTrainPipeline(cfg, ["train"], seed=2)
    theirs = JaxPipe(cfg, ["train"], seed=2, use_native=False)
    got = list(ours.epoch(1))
    ref = list(theirs.epoch(1))
    assert len(got) == len(ref) == 3
    assert got[0][0].shape[0] == 4 * repeats
    for (gi, gm, _), (ri, rm, _) in zip(got, ref):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("mode,dataset", [
    ("IID", "SyntheticSeg3x20"), ("IID+", "SyntheticSeg3x20"),
    ("IID", "Coco164kCuratedFew"), ("IID+", "Potsdam"),
    ("IID", "Coco10kFull")])
def test_seg_partitions_match_jax(mode, dataset):
    cfg = SimpleNamespace(mode=mode, dataset=dataset)
    assert tuple(tp.seg_partitions(cfg)) == tuple(jax_partitions(cfg))


def test_mapping_loader_channels_match_jax():
    """The eval loader's transform equals the JAX one (append_grey, NCHW)."""
    from iic_tpu.data.seg_pipeline import SegMappingLoader as JaxLoader
    cfg = _pipe_cfg()
    ours = tp.SegMappingLoader(cfg, ["train"])
    theirs = JaxLoader(cfg, ["train"])
    (gi, gl, gm), = list(ours)[:1]
    (ri, rl, rm), = list(theirs)[:1]
    np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=1e-6)
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_array_equal(gm, rm)
