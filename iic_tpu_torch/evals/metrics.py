"""Cluster-to-class matching and metrics (``iic_tpu/evals/metrics.py``).

Reference: code/utils/cluster/eval_metrics.py. The reference builds the
k x k vote matrix with a Python double loop of elementwise GPU comparisons
(:40-44); here it is one exact host-side int64 bincount over fused class
pairs (O(N) with no (N, k) one-hot materialisation — at segmentation
scale the eval flattens 1e8+ masked pixels, where a device one-hot would
OOM and f32 accumulation would saturate at 2^24 votes per cell). The tiny
assignment problem is then solved on host with scipy (sklearn's removed
``linear_assignment`` was exactly scipy's ``linear_sum_assignment``).
"""

import numpy as np
from scipy.optimize import linear_sum_assignment


def vote_matrix(flat_preds, flat_targets, preds_k, targets_k):
    """votes[c1, c2] = #samples with pred == c1 and target == c2.

    Exact integer counts (reference eval_metrics.py:40-44 semantics)."""
    p = np.asarray(flat_preds).astype(np.int64).ravel()
    t = np.asarray(flat_targets).astype(np.int64).ravel()
    if p.size:
        # callers mask out ignore-labels before voting; an out-of-range id
        # here (e.g. an unmasked -1) would otherwise crash deep inside
        # bincount/reshape with a baffling message
        assert p.min() >= 0 and p.max() < preds_k, (
            f"pred ids outside [0, {preds_k}): "
            f"[{p.min()}, {p.max()}] — unmasked ignore-label?")
        assert t.min() >= 0 and t.max() < targets_k, (
            f"target ids outside [0, {targets_k}): "
            f"[{t.min()}, {t.max()}] — unmasked ignore-label?")
    counts = np.bincount(p * targets_k + t,
                         minlength=preds_k * targets_k)
    return counts.reshape(preds_k, targets_k).astype(np.float64)


def hungarian_match(flat_preds, flat_targets, preds_k, targets_k):
    """One-to-one match maximising votes (reference ``_hungarian_match``,
    eval_metrics.py:29-54). Returns list of (pred_c, target_c) tuples."""
    assert preds_k == targets_k
    num_samples = int(np.shape(flat_targets)[0])
    votes = np.asarray(vote_matrix(flat_preds, flat_targets,
                                   preds_k, targets_k))
    # reference minimises (num_samples - votes)
    row, col = linear_sum_assignment(num_samples - votes)
    return list(zip(row.tolist(), col.tolist()))


def original_match(flat_preds, flat_targets, preds_k, targets_k):
    """Many-to-one match: each output channel to its most frequent ground
    truth (reference ``_original_match``, eval_metrics.py:9-26)."""
    votes = np.asarray(vote_matrix(flat_preds, flat_targets,
                                   preds_k, targets_k))
    return [(out_c, int(np.argmax(votes[out_c])))
            for out_c in range(preds_k)]


def reorder_preds(flat_preds, match, dtype=np.int32):
    """Apply a match (list of (pred, target)) to relabel predictions
    (reference cluster_eval.py:216-217)."""
    flat_preds = np.asarray(flat_preds)
    reordered = np.zeros_like(flat_preds, dtype=dtype)
    for pred_i, target_i in match:
        reordered[flat_preds == pred_i] = target_i
    return reordered


def accuracy(preds, targets, num_k=None):
    """Mean 0/1 accuracy (reference ``_acc``, eval_metrics.py:57-70).
    An empty prediction set (e.g. an all-irrelevant eval subset) counts
    as 0 rather than crashing or propagating NaN into epoch_acc."""
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    assert preds.shape == targets.shape
    if preds.shape[0] == 0:
        return 0.0
    if num_k is not None:
        assert preds.max() < num_k and targets.max() < num_k
    return float((preds == targets).sum() / preds.shape[0])

