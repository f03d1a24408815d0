"""The port's k-means (``iic_tpu_torch/evals/kmeans_eval.py``) against
scikit-learn, and its evals against the JAX package's:

- separated blobs: the same partition as ``sklearn.cluster.KMeans`` up to
  a permutation of the cluster ids;
- overlapping blobs: inertia at most 1.001x KMeans's (n_init 10) and at
  most MiniBatchKMeans's (the solver the JAX segmentation eval calls);
- a fit held to its own Lloyd iterations replayed in float64: equal labels
  but for points within 1e-6 (relative) of a tie, centroids within 1e-4
  of max (the check ``chip_smoke.py`` makes on the card);
- ``kmeans_segmentation_eval`` on the same loader and separable per-pixel
  features: the same sample drawn, the same accuracy;
- ``triplets_eval`` with ``--kmeans_on_features`` (and by argmax) on a
  TripletsNet6c from carried-over weights and clusterable images: the same
  accuracy, masses and per-class hits;
- ``kmeans_cluster_assess``: the same accuracy.

scikit-learn is needed here only (``pytest.importorskip``); the port does
not import it."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.evals import kmeans_eval as jkm
from iic_tpu.train.triplets_trainer import triplets_eval as jax_triplets_eval
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import load_triplets_net
from iic_tpu_torch.evals import kmeans_eval as tkm
from iic_tpu_torch.parallel.train_step import make_apply_fn
from iic_tpu_torch.train.triplets_trainer import make_history, triplets_eval
from test_torch_cluster_models import random_flax_variables

sklearn_cluster = pytest.importorskip("sklearn.cluster")


def _blobs(n, k, d, spread, seed):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d)) * 5.0
    labels = rng.integers(0, k, n)
    x = centres[labels] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32), labels


def _same_partition(a, b, k):
    votes = np.zeros((k, k), int)
    np.add.at(votes, (a, b), 1)
    return ((votes > 0).sum(1) == 1).all() and ((votes > 0).sum(0) == 1).all()


@pytest.mark.parametrize("k,d", [(3, 16), (10, 64)])
def test_separated_blobs_give_sklearns_partition(k, d):
    x, truth = _blobs(2000, k, d, 0.3, seed=k)
    ours = tkm.KMeans(k, seed=0).fit(torch.from_numpy(x))
    ref = sklearn_cluster.KMeans(n_clusters=k, n_init=10,
                                 random_state=0).fit(x)
    assert _same_partition(ours.labels_.numpy(), ref.labels_, k)
    assert _same_partition(ours.labels_.numpy(), truth, k)
    np.testing.assert_allclose(ours.inertia_, ref.inertia_, rtol=1e-4)
    np.testing.assert_array_equal(
        ours.predict(torch.from_numpy(x)).numpy(), ours.labels_.numpy())


def _inertia(x, centres):
    d = ((x[:, None, :].astype(np.float64) - centres[None]) ** 2).sum(-1)
    return d.min(1).sum()


@pytest.mark.parametrize("k,seed", [(3, 0), (15, 1), (10, 2)])
def test_overlapping_blobs_inertia_against_sklearn(k, seed):
    """Inertia in float64 at each solver's centroids."""
    x, _ = _blobs(3000, k, 8, 4.0, seed=seed)
    ours = tkm.KMeans(k, seed=0).fit(torch.from_numpy(x))
    full = sklearn_cluster.KMeans(n_clusters=k, n_init=10,
                                  random_state=0).fit(x)
    mini = sklearn_cluster.MiniBatchKMeans(n_clusters=k, random_state=0,
                                           n_init="auto").fit(x)
    got = _inertia(x, ours.cluster_centers_.numpy())
    assert got <= 1.001 * _inertia(x, full.cluster_centers_)
    assert got <= _inertia(x, mini.cluster_centers_)
    np.testing.assert_allclose(ours.inertia_, got, rtol=1e-4)


def test_empty_cluster_takes_the_farthest_point():
    """A seed far from every point leaves its cluster empty: it moves to
    the point farthest from its centroid, as sklearn relocates it."""
    x = torch.tensor([[0.0], [0.1], [0.2], [10.0], [10.1], [30.0]])
    centres, labels, _, _ = tkm.lloyd(x, torch.tensor([[0.1], [10.0],
                                                        [100.0]]),
                                      max_iter=1)
    assert centres[2, 0] == 30.0
    assert sorted(labels.tolist()) == [0, 0, 0, 1, 1, 2]


def test_float64_replay_of_a_fit():
    x, _ = _blobs(4000, 10, 32, 2.0, seed=5)
    km = tkm.KMeans(10, seed=3).fit(torch.from_numpy(x))
    rep = tkm.replay_float64(torch.from_numpy(x), km)
    assert rep["mismatches"] == 0
    assert rep["centre_err"] <= 1e-4
    assert km.n_iter_ > 1


class _SegLoader:
    """A mapping loader over fixed numpy batches (imgs, labels, mask)."""

    def __init__(self, batches, wrap):
        self.batches, self.wrap = batches, wrap

    def __iter__(self):
        for imgs, labels, mask in self.batches:
            yield self.wrap(imgs), labels, mask

    def __len__(self):
        return len(self.batches)


def _seg_batches(k=3, n_batches=3, b=4, sz=12, d=6, seed=0):
    """Per-pixel features separable by class (one-hot x 3 + noise) laid out
    as (b, d, sz, sz) "images", their label maps and masks (~70% set)."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((k, d)) * 3.0
    out = []
    for _ in range(n_batches):
        labels = rng.integers(0, k, (b, sz, sz)).astype(np.int32)
        feats = proj[labels] + 0.3 * rng.standard_normal((b, sz, sz, d))
        mask = (rng.random((b, sz, sz)) < 0.7).astype(np.float32)
        out.append((feats.transpose(0, 3, 1, 2).astype(np.float32), labels,
                    mask))
    return out


@pytest.mark.parametrize("max_samples", [50_000, 200])
def test_kmeans_segmentation_eval_matches_jax(max_samples):
    """The same loader and features in both packages (the features are the
    batches themselves): the same sampled pixels (max_samples 200 draws a
    quota of 66 a batch) and the same accuracy; the match (cluster id ->
    class) is a permutation in both, and its ids are each solver's own."""
    batches = _seg_batches()
    ref = jkm.kmeans_segmentation_eval(
        lambda im: im, _SegLoader(batches, jnp.asarray), 3,
        max_num_samples=max_samples, seed=0)
    got = tkm.kmeans_segmentation_eval(
        lambda im: im, _SegLoader(batches, torch.from_numpy), 3,
        max_num_samples=max_samples, seed=0)
    assert got["acc"] == ref["acc"]
    assert sorted(c for c, _ in got["match"]) == [0, 1, 2]
    assert sorted(t for _, t in got["match"]) == [0, 1, 2]
    assert got["acc"] > 0.95


def test_kmeans_sample_is_the_jax_sample(monkeypatch):
    """The rows the port fits on are the ones the JAX function hands to
    MiniBatchKMeans.fit, in the same order."""
    batches = _seg_batches(seed=1)
    seen = {}

    class Capture:
        def __init__(self, **kw):
            pass

        def fit(self, x):
            seen["jax"] = np.asarray(x)
            return self

    monkeypatch.setattr(sklearn_cluster, "MiniBatchKMeans", Capture)
    jkm.train_kmeans_on_features(lambda im: im,
                                 _SegLoader(batches, jnp.asarray), 3,
                                 max_num_samples=100, seed=4)

    def capture_fit(self, x):
        seen["torch"] = x
        return self

    monkeypatch.setattr(tkm.KMeans, "fit", capture_fit)
    tkm.train_kmeans_on_features(lambda im: im,
                                 _SegLoader(batches, torch.from_numpy), 3,
                                 max_num_samples=100, seed=4)
    np.testing.assert_array_equal(seen["torch"].numpy(), seen["jax"])
    assert len(seen["jax"]) == 99


def test_kmeans_cluster_assess_matches_jax():
    x, truth = _blobs(600, 5, 12, 0.5, seed=7)
    ref = jkm.kmeans_cluster_assess(x, truth, 5, seed=0)
    got = tkm.kmeans_cluster_assess(x, truth, 5, seed=0, device="cpu")
    assert got == ref == 1.0


@pytest.mark.parametrize("kmeans", [True, False])
def test_triplets_eval_matches_jax(kmeans):
    """A TripletsNet6c from carried-over weights on 60 images of 3 classes
    (a per-class grey level and texture plus noise): the same accuracy,
    masses and per-class hits, over the k-means of the features or the
    argmax of the logits."""
    cfg = SimpleNamespace(arch="TripletsNet6c", in_channels=1, output_k=3,
                          gt_k=3, input_sz=24, batchnorm_track=True, seed=0)
    jnet = jmodels.build(cfg.arch, cfg)
    variables = random_flax_variables(jnet, 1, heads=None, seed=3,
                                      head_std=0.1, sz=24)
    tnet = load_triplets_net(variables, tmodels.build(cfg.arch, cfg))
    rng = np.random.default_rng(0)
    labels = np.repeat(np.arange(3), 20).astype(np.int32)
    yy = np.mgrid[0:24, 0:24][0] / 24.0
    imgs = np.stack([0.2 + 0.3 * c + 0.2 * np.sin(yy * (c + 1) * 6)
                     + 0.02 * rng.standard_normal((24, 24))
                     for c in labels])[:, None].astype(np.float32)
    batches = [(imgs[i:i + 16], labels[i:i + 16]) for i in range(0, 60, 16)]

    def jfn(features):
        return lambda im: jnet.apply(variables, jnp.asarray(im), train=False,
                                     kmeans_use_features=features)

    jhist = {"epoch_acc": [], "masses": [], "per_class_acc": []}
    jax_triplets_eval(cfg, jfn(False), batches, jhist,
                      features_fn=jfn(True) if kmeans else None)
    thist = make_history()
    triplets_eval(cfg, make_apply_fn(tnet),
                  [(torch.from_numpy(a), b) for a, b in batches], thist,
                  features_fn=(make_apply_fn(tnet, kmeans_use_features=True)
                               if kmeans else None))
    for key in ("epoch_acc", "masses", "per_class_acc"):
        assert thist[key] == jhist[key], key
    if kmeans:
        assert thist["epoch_acc"] == [1.0]
