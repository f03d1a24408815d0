"""The port's host paths of the segmentation pipeline: the native C++ prep
(``iic_tpu_torch/native``, the JAX package's source built by g++ into
build/native/) against the port's numpy path and the JAX package's native
prep, the numpy fast path with its raw-frame mask cache against the JAX
numpy pipeline, the cache's budget gate, and the eval loader behind its
prefetch thread."""

from types import SimpleNamespace

import numpy as np
import pytest

from iic_tpu_torch import native
from iic_tpu_torch.data import seg_pipeline as tp

from test_paper_parity_run import _make_coco164k_curated, _make_potsdam


def _cfg(**kw):
    cfg = dict(dataset="SyntheticSeg3x48x32", dataset_root="", mode="IID",
               gt_k=3, input_sz=40, batch_sz=8, num_dataloaders=1,
               dataloader_batch_sz=8, eval_batch_sz=None, using_IR=False,
               sobel=True, include_rgb=True, flip_p=0.5,
               use_random_affine=False, jitter_brightness=0.4,
               jitter_contrast=0.4, jitter_saturation=0.4, jitter_hue=0.125,
               use_coarse_labels=True, include_things_labels=False,
               incl_animal_things=False, coco_164k_curated_version=6,
               fine_to_coarse_dict="", pre_scale_all=False,
               pre_scale_factor=0.5, use_random_scale=False, scale_min=0.8,
               scale_max=1.2)
    cfg.update(kw)
    return SimpleNamespace(**cfg)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    _make_coco164k_curated(str(root), n_train=12, n_val=2, sz=56)
    return str(root)


@pytest.fixture(scope="module")
def potsdam_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("potsdam")
    _make_potsdam(str(root), n_unlab=6, n_lab_train=4, n_lab_test=2)
    return str(root)


def _coco(root, **kw):
    return _cfg(dataset="Coco164kCuratedFew", dataset_root=root,
                input_sz=48, **kw)


def _batches(pipe, epoch):
    return [(i.numpy(), m.numpy()) for i, m, _ in pipe.epoch(epoch)]


def test_library_builds_into_build_native():
    lib = native.load_seg_prep()
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("libseg_prep-") and path.suffix == ".so"
    assert native.load_seg_prep() is lib  # loaded once a process
    jax_src = native.SRC.parents[2] / "iic_tpu" / "native" / "seg_prep.cpp"
    assert native.SRC.read_bytes() == jax_src.read_bytes()


@pytest.mark.parametrize("dataset", ["synthetic", "coco", "potsdam"])
def test_native_equals_numpy_without_rescale(dataset, coco_root,
                                             potsdam_root):
    """Same draws, same crops, same masks: bit-equal over a whole epoch
    (COCO with a label table that masks pixels out; Potsdam with
    unlabelled tiles and four channels)."""
    cfg = {"synthetic": _cfg(),
           "coco": _coco(coco_root),
           "potsdam": _cfg(dataset="Potsdam", dataset_root=potsdam_root,
                           input_sz=160, using_IR=True)}[dataset]
    parts = (["unlabelled_train", "labelled_train"] if dataset == "potsdam"
             else ["train2017"] if dataset == "coco" else ["train"])
    fast = tp.SegTrainPipeline(cfg, parts, seed=3, use_native=True)
    slow = tp.SegTrainPipeline(cfg, parts, seed=3, use_native=False)
    assert fast._native is not None and slow._native is None
    got, ref = _batches(fast, 1), _batches(slow, 1)
    assert len(got) == len(ref) > 1
    for (gi, gm), (ri, rm) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gm, rm)
    if dataset == "coco":
        assert 0 < np.concatenate([m for _, m in got]).mean() < 1


@pytest.mark.parametrize("scale", [
    dict(pre_scale_all=True, pre_scale_factor=0.6),
    dict(use_random_scale=True),
    dict(pre_scale_all=True, pre_scale_factor=0.6, use_random_scale=True)])
@pytest.mark.parametrize("dataset", ["synthetic", "coco"])
def test_native_equals_jax_native_with_rescale(dataset, scale, coco_root):
    """The same C++ on the same draws: the port's native batches equal the
    JAX package's native batches bit for bit under every rescale."""
    from iic_tpu.data.seg_pipeline import SegTrainPipeline as JaxPipe

    cfg = _coco(coco_root, **scale) if dataset == "coco" else _cfg(**scale)
    part = ["train2017"] if dataset == "coco" else ["train"]
    ours = tp.SegTrainPipeline(cfg, part, seed=5, use_native=True)
    theirs = JaxPipe(cfg, part, seed=5, use_native=True)
    assert theirs._native is not None
    order, rng_o = ours._epoch_order(0)
    rng_t = np.random.default_rng(np.random.SeedSequence([5, 0]))
    rng_t.permutation(ours.total)
    for b in range(2):
        idxs = order[b * 8:(b + 1) * 8]
        gi, gm = ours._native_batch(idxs, rng_o)
        ri, rm = theirs._native_batch(idxs, rng_t)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gm, rm)


def test_native_rescale_stays_within_the_jax_bound():
    """Under a rescale the native bilinear resize is not cv2's: masks stay
    equal to the numpy path's, images within the JAX package's own bound
    (tests/test_native.py: correlation > 0.995, median |d| <= 4)."""
    cfg = _cfg(pre_scale_all=True, pre_scale_factor=0.9, input_sz=32)
    fast = tp.SegTrainPipeline(cfg, ["train"], seed=5, use_native=True)
    slow = tp.SegTrainPipeline(cfg, ["train"], seed=5, use_native=False)
    (gi, gm), = _batches(fast, 0)[:1]
    (ri, rm), = _batches(slow, 0)[:1]
    np.testing.assert_array_equal(gm, rm)
    a, b = gi.astype(np.float32), ri.astype(np.float32)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.995
    assert np.median(np.abs(a - b)) <= 4


@pytest.mark.parametrize("cxx", ["/nonexistent/bin/g++", "false"])
def test_a_failed_build_raises(cxx, monkeypatch):
    """No quiet numpy fallback: a compiler that is missing or fails raises,
    from the builder and from a pipeline that asked for the native path."""
    with pytest.raises(RuntimeError, match="native seg_prep"):
        native.build_seg_prep(cxx=cxx)
    assert not native.library_path(cxx).exists()
    monkeypatch.setattr(native, "load_seg_prep",
                        lambda: native.build_seg_prep(cxx=cxx))
    with pytest.raises(RuntimeError, match="native seg_prep"):
        tp.SegTrainPipeline(_cfg(), ["train"], use_native=True)


def test_fast_path_with_mask_cache_matches_jax_over_two_epochs(coco_root):
    """The numpy fast path (uniform 56 x 56 COCO images, a label table that
    masks pixels out) equals the JAX pipeline's use_native=False batches
    over two epochs; the second epoch's masks come from the cache built in
    the first."""
    from iic_tpu.data.seg_pipeline import SegTrainPipeline as JaxPipe

    cfg = _coco(coco_root)
    ours = tp.SegTrainPipeline(cfg, ["train2017"], seed=2, use_native=False)
    theirs = JaxPipe(cfg, ["train2017"], seed=2, use_native=False)
    first = _batches(ours, 0)
    cached = dict(ours._mask_cache)
    assert len(cached) == ours.total
    second = _batches(ours, 1)
    assert all(ours._mask_cache[k] is v for k, v in cached.items())
    assert len(ours._mask_cache) == ours.total
    for e, got in ((0, first), (1, second)):
        ref = [(np.asarray(i), np.asarray(m))
               for i, m, _ in theirs.epoch(e, augmented=False)]
        assert len(got) == len(ref)
        for (gi, gm), (ri, rm) in zip(got, ref):
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gm, rm)
    assert 0 < np.concatenate([m for _, m in first]).mean() < 1


def test_fast_path_matches_per_sample_path(coco_root):
    """use_fast_host=False sends each sample through get_train: the same
    rng stream, bit-equal batches."""
    cfg = _coco(coco_root, batch_sz=5, dataloader_batch_sz=5)  # ragged
    fast = tp.SegTrainPipeline(cfg, ["train2017"], use_native=False)
    slow = tp.SegTrainPipeline(cfg, ["train2017"], use_native=False,
                               use_fast_host=False)
    for (fi, fm), (si, sm) in zip(_batches(fast, 0), _batches(slow, 0)):
        np.testing.assert_array_equal(fi, si)
        np.testing.assert_array_equal(fm, sm)
    assert fast._mask_cache and not slow._mask_cache


def test_mask_cache_budget_gate(coco_root, monkeypatch):
    """With the budget at 0 the fast path recomputes each batch's masks and
    gives the same batches (the cache only memoises keep[lab + 1])."""
    monkeypatch.setenv("IIC_TPU_MASK_CACHE_BYTES", "0")
    cfg = _coco(coco_root)
    gated = tp.SegTrainPipeline(cfg, ["train2017"], use_native=False)
    assert gated._mask_cache_budget == 0
    monkeypatch.delenv("IIC_TPU_MASK_CACHE_BYTES")
    cached = tp.SegTrainPipeline(cfg, ["train2017"], use_native=False)
    assert cached._mask_cache_budget == 256 * 1024 * 1024
    for (gi, gm), (ci, cm) in zip(_batches(gated, 0), _batches(cached, 0)):
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_array_equal(gm, cm)
    assert not gated._mask_cache and cached._mask_cache


@pytest.mark.parametrize("dataset", ["synthetic", "coco"])
def test_mapping_loader_prefetch_yields_the_same_batches(dataset,
                                                         coco_root):
    cfg = _coco(coco_root, eval_batch_sz=5) if dataset == "coco" else _cfg(
        eval_batch_sz=5)
    loader = tp.SegMappingLoader(
        cfg, ["val2017", "train2017"] if dataset == "coco" else ["train"])
    got, ref = list(loader), list(loader._batches())
    assert len(got) == len(ref) == len(loader) > 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), r[0].numpy())
        np.testing.assert_array_equal(g[1], r[1])
        np.testing.assert_array_equal(g[2], r[2])
