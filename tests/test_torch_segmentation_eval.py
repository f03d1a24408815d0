"""The port's ``evals/segmentation_eval.py`` against the JAX package's on
the same softmax maps, labels and relevancy masks: ``segmentation_get_data``
(the masked predictions and targets, exactly) and ``segmentation_eval``
(every stat, the best sub-head's match included, and the history and
is_best over two epochs), in mode IID (the assignment set scored) and IID+
(the match re-applied to a held-out set)."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iic_tpu.evals.cluster_eval import EvalHistory as JaxEvalHistory
from iic_tpu.evals.segmentation_eval import (
    segmentation_eval as jax_segmentation_eval,
    segmentation_get_data as jax_get_data)
from iic_tpu_torch.evals.cluster_eval import EvalHistory
from iic_tpu_torch.evals.segmentation_eval import (
    segmentation_eval, segmentation_get_data)


def _loader(seed, n_batches=3, b=4, k=4, sz=10):
    """(batch index, labels (b, sz, sz), mask) batches; the labels follow
    a per-sub-head permutation of the argmax in ~70% of the pixels."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, k, (b, sz, sz)).astype(np.int32),
             (rng.random((b, sz, sz)) < 0.6).astype(np.float32))
            for i in range(n_batches)]


def _outs(loader, seed, s=3, k=4):
    """Softmax maps (s, b, k, h, w) for each batch, their argmax agreeing
    with the labels under a permutation per sub-head (the same for every
    loader) in 30-70% of the pixels."""
    perms = [np.random.default_rng(99 + h).permutation(k) for h in range(s)]
    rng = np.random.default_rng(seed)
    outs = []
    for _, labels, _ in loader:
        logits = rng.standard_normal((s,) + labels.shape[:1] + (k,)
                                     + labels.shape[1:])
        for h in range(s):
            hit = rng.random(labels.shape) < 0.3 + 0.2 * h
            onehot = np.eye(k)[perms[h][labels]].transpose(0, 3, 1, 2)
            logits[h] += 4.0 * onehot * hit[:, None]
        e = np.exp(logits - logits.max(2, keepdims=True))
        outs.append((e / e.sum(2, keepdims=True)).astype(np.float32))
    return outs


@pytest.mark.parametrize("mode", ["IID", "IID+"])
def test_segmentation_eval_matches_jax(mode):
    cfg = SimpleNamespace(num_sub_heads=3, output_k=4, gt_k=4, mode=mode,
                          eval_mode="hung" if mode == "IID" else "orig")
    assign, test = _loader(0), _loader(1)
    outs = {"a": _outs(assign, 2), "t": _outs(test, 3)}
    # batch ids 0-2 index the assignment maps, 10-12 the test maps
    test = [(i + 10, lab, m) for i, lab, m in test]

    def apply(wrap):
        return lambda i: wrap(outs["a"][i] if i < 10 else outs["t"][i - 10])

    got_p, got_t = segmentation_get_data(cfg, apply(torch.from_numpy),
                                         assign)
    ref_p, ref_t = jax_get_data(cfg, apply(jnp.asarray), assign)
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_t, ref_t)
    assert got_p.shape == (3, int(sum(m.sum() for _, _, m in assign)))

    got_hist, ref_hist = EvalHistory(), JaxEvalHistory()
    for epoch in range(2):
        if epoch:  # a second epoch with sharper maps: a new best
            outs = {key: [np.where(o == o.max(2, keepdims=True), 1.0, 0.0)
                          .astype(np.float32) for o in v]
                    for key, v in outs.items()}
        got = segmentation_eval(cfg, apply(torch.from_numpy), assign, test,
                                history=got_hist)
        ref = jax_segmentation_eval(cfg, apply(jnp.asarray), assign, test,
                                    history=ref_hist)
        assert got == ref
    assert got_hist.epoch_stats == ref_hist.epoch_stats
    assert got_hist.epoch_acc == ref_hist.epoch_acc
    assert got_hist.epoch_avg_subhead_acc == ref_hist.epoch_avg_subhead_acc
    stats = segmentation_eval(cfg, apply(torch.from_numpy), assign, test,
                              return_only=True)
    assert stats == jax_segmentation_eval(cfg, apply(jnp.asarray), assign,
                                          test, return_only=True)
    assert 0.3 < stats["best"] <= 1.0
    assert stats["best_train_sub_head"] == 2
