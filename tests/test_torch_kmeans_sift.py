"""The port's k-means + SIFT segmentation baseline
(``iic_tpu_torch/cli/kmeans_and_sift.py``) against the JAX CLI
(``iic_tpu/cli/kmeans_and_sift.py``), on the CPU: the colour and dense-SIFT
samples bit for bit on the same batches, the mapping loader's uint8 round
trip over all 256 levels, and whole runs of both CLIs on a SyntheticSeg
archetype that the port's ``save_meta`` wrote. The port fits its own
k-means where JAX fits scikit-learn's ``MiniBatchKMeans``, so a run is held
to JAX's given JAX's centroids (the k-means stubbed on the port's side):
samples, predictions, match and accuracy exactly equal; and the port's own
fit on the same samples is held to MiniBatchKMeans's inertia."""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from iic_tpu.cli import kmeans_and_sift as jks
from iic_tpu.data.seg_pipeline import SegMappingLoader as JaxMappingLoader
from iic_tpu.train.config import config_from_dict as jax_config_from_dict
from iic_tpu_torch.cli import kmeans_and_sift as tks
from iic_tpu_torch.data.seg_pipeline import SegMappingLoader
from iic_tpu_torch.evals import kmeans_eval
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import SegConfig

RealKMeans = kmeans_eval.KMeans

# the port's own fit against MiniBatchKMeans(random_state=0, n_init="auto")
# on the same samples: its inertia at most this many times theirs
INERTIA_RATIO = 1.01


def _write_archetype(out_root, model_ind=77, mode="IID", eval_mode=None,
                     **kw):
    """A finished run's config.pickle, written by the port's
    ``save_meta``; ``eval_mode`` overrides the one ``finalize`` derives."""
    cfg = SegConfig(
        model_ind=model_ind, arch="SegmentationNet10aTwoHead", mode=mode,
        dataset="SyntheticSeg3x48x32", dataset_root="", gt_k=3,
        output_k_A=6, output_k_B=3, batch_sz=8, num_dataloaders=1,
        input_sz=40, use_random_scale=False, use_random_affine=True,
        no_sobel=False, include_rgb=True, out_root=str(out_root),
        half_T_side_dense=2, num_epochs=2)
    for k, v in kw.items():
        setattr(cfg, k, v)
    cfg.finalize(twohead=True)
    if eval_mode is not None:
        cfg.eval_mode = eval_mode
    os.makedirs(os.path.join(str(out_root), str(model_ind)), exist_ok=True)
    ckpt.save_meta(cfg, {}, 0)
    return cfg


def _fake_batches(n=3, b=3, sz=40, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, sz, sz, c), dtype=np.uint8),
             rng.random((b, sz, sz)) > 0.3,
             rng.integers(0, 3, (b, sz, sz)).astype(np.int32))
            for _ in range(n)]


class _Cfg:
    input_sz = 40
    in_channels = 3


def _torch_batches(batches, labels=True):
    return [(torch.from_numpy(i), torch.from_numpy(m),
             torch.from_numpy(la) if labels else None)
            for i, m, la in batches]


@pytest.mark.parametrize("test_code", [False, True])
@pytest.mark.parametrize("labels", [True, False])
def test_colour_samples_equal_jax(labels, test_code):
    batches = _fake_batches()
    theirs = jks.get_vectorised_colour_samples(
        _Cfg(), iter([(i, m, la if labels else None)
                      for i, m, la in batches]), test_code=test_code)
    ours = tks.get_vectorised_colour_samples(
        _Cfg(), iter(_torch_batches(batches, labels)), test_code=test_code)
    if not labels:
        theirs, ours = (theirs,), (ours,)
    for got, want in zip(ours, theirs):
        assert torch.is_tensor(got) and got.dtype == torch.from_numpy(
            want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    n = sum(m.sum() for _, m, _ in batches[:2 if test_code else 3])
    assert len(ours[0]) == n


@pytest.mark.parametrize("test_code", [False, True])
def test_sift_samples_equal_jax(test_code):
    pytest.importorskip("cv2")
    batches = _fake_batches(b=2)
    theirs = jks.get_vectorised_sift_samples(_Cfg(), iter(batches),
                                             test_code=test_code)
    ours = tks.get_vectorised_sift_samples(
        _Cfg(), iter(_torch_batches(batches)), test_code=test_code)
    for got, want in zip(ours, theirs):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert ours[0].shape[1] == tks.SIFT_DLEN == jks.SIFT_DLEN
    assert tks.SIFT_STEP == jks.SIFT_STEP


def test_mapping_round_trip_recovers_every_level(tmp_path):
    """The mapping loaders' raw colour / 255, times 255 and truncated to
    uint8, gives every one of the 256 levels back, in both packages (their
    floats need not be equal: torch divides, XLA multiplies by the
    reciprocal)."""
    cfg = tks.raw_colour_config(_write_archetype(tmp_path))
    jcfg = jks_raw_colour(jax_config_from_dict(ckpt_meta(tmp_path)["config"]))
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    imgs = np.stack([levels, levels.T, levels[::-1]], -1)[None]
    labels = np.zeros((1, 16, 16), np.int32)
    masks = np.ones((1, 16, 16), bool)
    ours = SegMappingLoader(cfg, ["train"]).transform(torch.from_numpy(imgs))
    theirs = JaxMappingLoader(jcfg, ["train"])._transform_jit(imgs)
    (got, _, _), = tks._iter_mapping([(ours, labels, masks)])
    (want, _, _), = jks._iter_mapping(None, [(theirs, labels, masks)])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), imgs)
    np.testing.assert_array_equal(want, imgs)


def jks_raw_colour(cfg):
    """The JAX CLI's own forcing to raw colour (its main does it inline)."""
    cfg.include_rgb, cfg.no_sobel, cfg.sobel = True, True, False
    cfg.in_channels = 4 if cfg.using_IR else 3
    return cfg


def ckpt_meta(out_root, model_ind=77):
    with open(os.path.join(str(out_root), str(model_ind),
                           "config.pickle"), "rb") as f:
        return pickle.load(f)


def _recorders(module, monkeypatch, store):
    """Record every (samples[, labels]) a CLI's sample functions return,
    in call order (the train samples, then the mapping samples)."""
    for name in ("get_vectorised_colour_samples",
                 "get_vectorised_sift_samples"):
        real = getattr(module, name)

        def rec(*a, _real=real, **kw):
            out = _real(*a, **kw)
            store.append(out)
            return out

        monkeypatch.setattr(module, name, rec)


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


CASES = {"colour": ([], "hung"), "colour-all": (None, "hung"),
         "colour-orig": ([], "orig"), "sift": (["--do_sift"], "hung")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_equals_jax_given_its_centroids(tmp_path, monkeypatch, case):
    """Both CLIs on one archetype: the train samples the k-means is fitted
    on and the mapping samples bit-equal; from JAX's MiniBatchKMeans
    centroids, the port's predictions, match and accuracy exactly JAX's;
    the port's own k-means on the same samples within INERTIA_RATIO of
    MiniBatchKMeans's inertia. ``colour-all`` runs without --test_code
    (every batch, the numpy subsample of --max_num_train)."""
    from sklearn import cluster as skcluster

    RealMiniBatchKMeans = skcluster.MiniBatchKMeans
    extra, eval_mode = CASES[case]
    if "--do_sift" in (extra or []):
        pytest.importorskip("cv2")
    _write_archetype(tmp_path, eval_mode=eval_mode)
    assert ckpt_meta(tmp_path)["config"]["eval_mode"] == eval_mode
    argv = ["--model_ind", "78", "--IID_model_ind", "77",
            "--max_num_train", "3000", "--out_root", str(tmp_path)]
    argv += ["--test_code"] + extra if extra is not None else []
    jax_fits, jax_preds, jax_samples = [], [], []

    class Recorded(RealMiniBatchKMeans):
        def fit(self, x, *a, **kw):
            jax_fits.append(np.array(x))
            return super().fit(x, *a, **kw)

        def predict(self, x, *a, **kw):
            out = super().predict(x, *a, **kw)
            jax_preds.append(out)
            return out

    monkeypatch.setattr(skcluster, "MiniBatchKMeans", Recorded)
    _recorders(jks, monkeypatch, jax_samples)
    jax_acc = jks.main(argv)
    jax_meta = ckpt_meta(tmp_path, 78)
    centroids = jax_meta["centroids"]

    fits, preds, samples = [], [], []

    class Given(RealKMeans):
        def fit(self, x):
            fits.append(x)
            self.cluster_centers_ = torch.from_numpy(centroids).float().to(
                x.device)
            return self

        def predict(self, x):
            out = super().predict(x)
            preds.append(out)
            return out

    monkeypatch.setattr(kmeans_eval, "KMeans", Given)
    _recorders(tks, monkeypatch, samples)
    acc = tks.main(argv, device="cpu")
    meta = ckpt_meta(tmp_path, 78)

    (train,), (jtrain,) = fits, jax_fits
    np.testing.assert_array_equal(train.numpy(), jtrain)
    assert train.dtype == torch.uint8
    for got, want in zip(samples[1], jax_samples[1]):  # the mapping set's
        np.testing.assert_array_equal(_host(got), want)
    np.testing.assert_array_equal(preds[0].numpy(), jax_preds[0])
    assert meta["match"] == jax_meta["match"]
    assert acc == jax_acc
    assert meta["history"]["epoch_acc"] == jax_meta["history"]["epoch_acc"]
    assert isinstance(meta["centroids"], np.ndarray)
    assert os.path.exists(os.path.join(str(tmp_path), "78", "config.txt"))

    # the port's own fit, against MiniBatchKMeans, both scored in float64
    x = jtrain.astype(np.float64)

    def inertia(c):
        return ((x[:, None, :] - np.asarray(c, np.float64)[None]) ** 2).sum(
            -1).min(1).sum()

    real = RealKMeans(3, seed=0).fit(torch.from_numpy(jtrain))
    theirs = RealMiniBatchKMeans(n_clusters=3, random_state=0,
                                 n_init="auto").fit(jtrain)
    assert inertia(real.cluster_centers_.numpy()) <= INERTIA_RATIO * \
        inertia(theirs.cluster_centers_)
    shutil.rmtree(os.path.join(str(tmp_path), "78"))


def _argv(tmp_path, archetype):
    return ["--model_ind", str(archetype + 1), "--IID_model_ind",
            str(archetype), "--max_num_train", "100", "--test_code",
            "--out_root", str(tmp_path)]


def test_rejects_a_non_iid_archetype(tmp_path):
    _write_archetype(tmp_path, model_ind=79, mode="IID+")
    for main in (jks.main, lambda a: tks.main(a, device="cpu")):
        with pytest.raises(AssertionError):
            main(_argv(tmp_path, 79))


def test_orig_soft_asserts_as_jax_does(tmp_path):
    _write_archetype(tmp_path, model_ind=81, eval_mode="orig_soft")
    for main in (jks.main, lambda a: tks.main(a, device="cpu")):
        with pytest.raises(AssertionError):
            main(_argv(tmp_path, 81))
    shutil.rmtree(os.path.join(str(tmp_path), "82"))
