"""K-means on features (``iic_tpu/evals/kmeans_eval.py``), with the port's
own k-means in torch on the features' device.

``KMeans`` minimises scikit-learn's objective (the sum of squared
distances to the nearest centroid) by sklearn's ``KMeans`` method:
k-means++ seeding (greedy, 2 + log k local trials) from an explicit
``torch.Generator``, Lloyd iterations on the data centred on its mean, the
distances taken as ||x||^2 - 2 x.c + ||c||^2 through ``torch.matmul`` in
full f32 (no TF32), an empty cluster moved to the point farthest from its
centroid, sklearn's stop (labels unchanged, or a total squared centroid
shift under ``tol`` times the mean feature variance; at most ``max_iter``
iterations), and the best of ``n_init`` runs by inertia. Where the JAX
module fits ``MiniBatchKMeans`` (the segmentation eval), the port fits
full-batch Lloyd on the same sample: the per-batch quota that
``np.random.default_rng(seed).choice`` draws over each batch's masked
pixels, reproduced exactly. Prediction runs batch by batch on the device,
over every masked pixel; the Hungarian match and the accuracy are the
host's (``evals.metrics``). No NMI or ARI: the JAX module computes them
only under its ``GET_NMI_ARI``, which is False.
"""

from contextlib import contextmanager

import numpy as np
import torch

from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.evals.metrics import (
    accuracy, hungarian_match, reorder_preds)

PREDICT_ROWS = 1 << 20  # rows a distance block holds


@contextmanager
def _full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sq_distances(x, centres, x_sq=None):
    """(n, d) rows, (k, d) centroids -> (n, k) squared distances,
    ||x||^2 - 2 x.c + ||c||^2, clamped at 0."""
    if x_sq is None:
        x_sq = (x * x).sum(1)
    c_sq = (centres * centres).sum(1)
    with _full_f32_matmul():
        dots = x @ centres.T
    return (x_sq[:, None] - 2.0 * dots + c_sq[None, :]).clamp_(min=0.0)


def kmeans_plusplus(x, k, generator, x_sq=None):
    """sklearn's greedy k-means++ seeding: the first centroid a uniform
    draw; each next one the best, by the potential it leaves, of 2 + log k
    candidates drawn with probability proportional to the squared distance
    to the nearest centroid so far. Returns (k, d) centroids."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    first = torch.randint(n, (1,), generator=generator, device=x.device)
    centres = [x[first[0]]]
    closest = sq_distances(x, x[first], x_sq)[:, 0]
    pot = closest.sum()
    for _ in range(1, k):
        u = torch.rand(trials, generator=generator, device=x.device,
                       dtype=torch.float64) * pot.double()
        cand = torch.searchsorted(torch.cumsum(closest.double(), 0), u)
        cand = cand.clamp_(max=n - 1)
        dist = torch.minimum(closest[None, :],
                             sq_distances(x, x[cand], x_sq).T)
        pots = dist.sum(1)
        best = int(torch.argmin(pots))
        pot, closest = pots[best], dist[best]
        centres.append(x[cand[best]])
    return torch.stack(centres)


def _m_step(x, x64, labels, dist_min, k):
    """New centroids in ``x``'s dtype: the mean of each cluster's rows,
    summed in float64 (``x64``, x as float64: an f32 sum of tens of
    thousands of rows drifts by up to 1e-3 of it, and on the card its
    atomic adds come in no fixed order); an empty cluster takes the row
    farthest from its centroid, which leaves its own cluster's sums
    (sklearn's ``_relocate_empty_clusters``)."""
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
    sums.index_add_(0, labels, x64)
    counts = torch.bincount(labels, minlength=k).double()
    empty = torch.nonzero(counts == 0).flatten()
    if empty.numel():
        far = torch.topk(dist_min, empty.numel()).indices
        for new, idx in zip(empty.tolist(), far.tolist()):
            old = int(labels[idx])
            sums[old] -= x64[idx]
            counts[old] -= 1
            sums[new] = x64[idx]
            counts[new] = 1
    return (sums / counts[:, None]).to(x.dtype)


def lloyd(x, centres, max_iter=300, tol=0.0, trace=None):
    """Lloyd iterations from ``centres`` (no centring here; the caller's
    tolerance is absolute): stop when the labels repeat or the total
    squared centroid shift is at most ``tol``, or after ``max_iter``.
    Returns (centroids, labels, inertia, iterations), the labels and
    inertia of a final E-step on the returned centroids. A ``trace`` list
    gets each iteration's (centroids in, labels, centroids out)."""
    k = centres.shape[0]
    x_sq = (x * x).sum(1)
    x64 = x.double()
    prev = None
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        dist = sq_distances(x, centres, x_sq)
        dist_min, labels = dist.min(1)
        new = _m_step(x, x64, labels, dist_min, k)
        if trace is not None:
            trace.append((centres, labels, new))
        shift = float(((new - centres) ** 2).sum())
        centres = new
        if prev is not None and torch.equal(labels, prev):
            break
        if shift <= tol:
            break
        prev = labels
    dist_min, labels = sq_distances(x, centres, x_sq).min(1)
    return centres, labels, float(dist_min.sum()), n_iter


class KMeans:
    """``sklearn.cluster.KMeans(n_clusters, n_init, max_iter, tol,
    random_state=seed)`` on a (n, d) tensor, on its device. After ``fit``:
    ``cluster_centers_`` (k, d), ``labels_`` (n,), ``inertia_``,
    ``n_iter_`` and ``init_centers_`` (the best run's seeds), tensors on
    the data's device."""

    def __init__(self, n_clusters, n_init=10, max_iter=300, tol=1e-4,
                 seed=0):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed

    def fit(self, x):
        x = torch.as_tensor(x).float()
        if x.shape[0] < self.n_clusters:
            raise ValueError(f"{x.shape[0]} samples for {self.n_clusters} "
                             "clusters")
        mean = x.mean(0)
        xc = x - mean
        tol = float(xc.var(0, unbiased=False).mean()) * self.tol
        x_sq = (xc * xc).sum(1)
        gen = torch.Generator(device=x.device).manual_seed(self.seed)
        best = None
        for _ in range(self.n_init):
            init = kmeans_plusplus(xc, self.n_clusters, gen, x_sq)
            run = lloyd(xc, init, self.max_iter, tol)
            if best is None or run[2] < best[0][2]:
                best = (run, init)
        (centres, labels, inertia, n_iter), init = best
        self.cluster_centers_ = centres + mean
        self.init_centers_ = init + mean
        self.labels_ = labels
        self.inertia_ = inertia
        self.n_iter_ = n_iter
        return self

    def predict(self, x):
        """Nearest centroid of each row, in blocks of ``PREDICT_ROWS``."""
        x = torch.as_tensor(x).float()
        c = self.cluster_centers_.to(x.device)
        return torch.cat([sq_distances(x[i:i + PREDICT_ROWS], c).argmin(1)
                          for i in range(0, x.shape[0], PREDICT_ROWS)])

    def fit_predict(self, x):
        return self.fit(x).labels_


def replay_float64(x, kmeans, tie_rel=1e-6):
    """Hold a fit's Lloyd iterations, one by one, to the same iterations in
    float64 on the CPU. The best run is re-run from its seeds
    (``kmeans.init_centers_``) on the data's device, recording each
    iteration; each E-step's labels are held to float64 ones from the same
    centroids, and each M-step's centroids to the float64 mean of the same
    labels. (A whole float64 run from the seeds is no reference: Lloyd's
    iterations carry a flip at a near tie into later ones, and at 50 000
    points the two runs end apart.) Returns {"mismatches": labels that
    differ at points not within ``tie_rel`` (relative) of a tie between
    their two nearest float64 centroids, "ties": such points, summed over
    the iterations and the final E-step; "centre_err": the largest |M-step
    centroid - float64 mean| / max |float64 mean|; "iterations"}."""
    x = torch.as_tensor(x).float()
    mean = x.mean(0)
    xc = x - mean
    trace = []
    centres, labels, _, n_iter = lloyd(
        xc, (kmeans.init_centers_ - mean).to(x.device), kmeans.n_iter_,
        0.0, trace=trace)
    trace.append((centres, labels, None))
    x64 = xc.double().cpu()
    mismatches = ties = 0
    err = 0.0
    for c_in, lab, c_out in trace:
        lab = lab.cpu()
        d, want = torch.topk(sq_distances(x64, c_in.double().cpu()), 2,
                             dim=1, largest=False)
        tie = (d[:, 1] - d[:, 0]) <= tie_rel * d[:, 1]
        mismatches += int(((lab != want[:, 0]) & ~tie).sum())
        ties += int(tie.sum())
        if c_out is not None:
            ref = _m_step(x64, x64, lab, torch.zeros(len(lab),
                                                     dtype=x64.dtype),
                          c_in.shape[0])
            err = max(err, float((c_out.double().cpu() - ref).abs().max()
                                 / ref.abs().max()))
    return {"mismatches": mismatches, "ties": ties, "centre_err": err,
            "iterations": n_iter}


def _masked_rows(feats, mask):
    """(bn, d, h, w) features and a (bn, h, w) host mask -> (flat indices
    of the masked pixels, numpy; a function gathering (n, d) rows of them
    on the device)."""
    bn, _, h, w = feats.shape
    flat = np.flatnonzero(np.asarray(mask).reshape(-1).astype(bool))

    def rows(idx):
        t = torch.from_numpy(idx).to(feats.device)
        return feats[t // (h * w), :, (t // w) % h, t % w].float()

    return flat, rows


def train_kmeans_on_features(features_fn, dataloader, gt_k,
                             max_num_samples=50_000, seed=0,
                             verbose=False):
    """Fit ``KMeans`` (gt_k clusters) on a sample of masked per-pixel
    features. ``features_fn(imgs) -> (bn, d, h, w)``; the loader yields
    (imgs, labels, mask). Each batch gives max_num_samples // batches
    pixels, drawn without replacement by ``np.random.default_rng(seed)``
    as the JAX function draws them."""
    rng = np.random.default_rng(seed)
    chunks = []
    per_batch = max(max_num_samples // max(len(dataloader), 1), 1)
    for b_i, (imgs, _, mask) in enumerate(dataloader):
        if verbose:
            print(f"kmeans eval: sampling features, batch {b_i}")
        flat, rows = _masked_rows(features_fn(imgs), mask)
        take = min(per_batch, len(flat))
        chunks.append(rows(flat[rng.choice(len(flat), take, replace=False)]))
    samples = torch.cat(chunks)[:max_num_samples]
    if len(samples) < max_num_samples:
        print(f"kmeans eval: sampled {len(samples)} of the requested "
              f"{max_num_samples} pixel features (sparse masks)")
    return KMeans(gt_k, seed=seed).fit(samples)


def apply_trained_kmeans(features_fn, dataloader, kmeans, verbose=False):
    """Predict cluster ids per masked pixel; returns (preds, targets), int32
    numpy."""
    preds_l, targets_l = [], []
    for b_i, (imgs, labels, mask) in enumerate(dataloader):
        if verbose:
            print(f"kmeans eval: predicting, batch {b_i}")
        flat, rows = _masked_rows(features_fn(imgs), mask)
        preds_l.append(kmeans.predict(rows(flat)).cpu().numpy()
                       .astype(np.int32))
        targets_l.append(np.asarray(labels).reshape(-1)[flat]
                         .astype(np.int32))
    return np.concatenate(preds_l), np.concatenate(targets_l)


def kmeans_segmentation_eval(features_fn, dataloader, gt_k,
                             max_num_samples=50_000, seed=0,
                             verbose=False):
    """Fit on the sample, predict every masked pixel, Hungarian-match the
    clusters to the classes. Returns {"acc", "match"}."""
    kmeans = train_kmeans_on_features(features_fn, dataloader, gt_k,
                                      max_num_samples, seed, verbose=verbose)
    preds, targets = apply_trained_kmeans(features_fn, dataloader, kmeans,
                                          verbose=verbose)
    match = hungarian_match(preds, targets, preds_k=gt_k, targets_k=gt_k)
    return {"acc": accuracy(reorder_preds(preds, match), targets, gt_k),
            "match": match}


def kmeans_cluster_assess(features, targets, gt_k, seed=0, device=None):
    """k-means (n_init 10) on (N, d) image features, Hungarian, accuracy.
    A tensor stays on its device; numpy goes to ``device`` (cuda:0 unless
    given)."""
    if not torch.is_tensor(features):
        features = torch.from_numpy(np.asarray(features)).to(
            resolve_device(device))
    preds = KMeans(gt_k, seed=seed).fit_predict(features)
    preds = preds.cpu().numpy().astype(np.int32)
    targets = np.asarray(targets).astype(np.int32)
    match = hungarian_match(preds, targets, preds_k=gt_k, targets_k=gt_k)
    return accuracy(reorder_preds(preds, match), targets, gt_k)
