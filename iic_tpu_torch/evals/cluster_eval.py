"""Sub-head evaluation by cluster-to-class matching
(``iic_tpu/evals/cluster_eval.py``: ``EvalHistory``,
``clustering_get_data``, ``get_assignment_data_matches``,
``cluster_subheads_eval``, ``cluster_eval``, ``get_subhead_using_loss``).

The caller supplies ``apply_fn(imgs) -> (num_sub_heads, bn, k, ...)``, a
forward that already encodes the BN mode, sobel and the head, and a
``get_data_fn`` that turns a loader into flat per-sub-head predictions and
targets: ``clustering_get_data`` by default,
``segmentation_eval.segmentation_get_data`` for segmentation. "Double
eval" (once with train-mode BN, once with eval-mode BN) is two apply_fns.
"""

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from iic_tpu_torch.evals.metrics import (
    accuracy, hungarian_match, original_match, reorder_preds)
from iic_tpu_torch.ops.iid_loss import iid_loss_multihead


@dataclasses.dataclass
class EvalHistory:
    """The metric lists the reference keeps on its config."""
    epoch_acc: List[float] = dataclasses.field(default_factory=list)
    epoch_avg_subhead_acc: List[float] = dataclasses.field(
        default_factory=list)
    epoch_stats: List[dict] = dataclasses.field(default_factory=list)
    double_eval_acc: List[float] = dataclasses.field(default_factory=list)
    double_eval_avg_subhead_acc: List[float] = dataclasses.field(
        default_factory=list)
    double_eval_stats: List[dict] = dataclasses.field(default_factory=list)

    def truncate(self, last_epoch):
        """Drop entries past the checkpointed epoch."""
        n = last_epoch + 1
        for f in ("epoch_acc", "epoch_avg_subhead_acc", "epoch_stats",
                  "double_eval_acc", "double_eval_avg_subhead_acc",
                  "double_eval_stats"):
            del getattr(self, f)[n:]


def clustering_get_data(config, apply_fn, dataloader):
    """Per-sub-head argmax predictions and targets over a mapping loader
    that yields (imgs, targets). Returns (flat_predss (num_sub_heads, N)
    int32, flat_targets (N,) int32)."""
    predss, targets = [], []
    for imgs, tgts in dataloader:
        x_outs = apply_fn(imgs)  # (H, bn, k) softmax
        assert x_outs.shape[0] == config.num_sub_heads
        assert x_outs.shape[2] == config.output_k
        predss.append(x_outs.argmax(dim=-1).cpu().numpy())  # (H, bn)
        targets.append(np.asarray(tgts))
    flat_predss = np.concatenate(predss, axis=1).astype(np.int32)
    flat_targets = np.concatenate(targets, axis=0).astype(np.int32)
    assert flat_predss.shape[1] == flat_targets.shape[0]
    return flat_predss, flat_targets


def get_assignment_data_matches(config, apply_fn,
                                mapping_assignment_dataloader,
                                get_data_fn=clustering_get_data,
                                just_matches=False):
    """Best matches per sub-head from the mapping-assignment set."""
    flat_predss, flat_targets = get_data_fn(
        config, apply_fn, mapping_assignment_dataloader)

    all_matches = []
    all_accs = np.zeros(config.num_sub_heads, dtype=np.float32)
    for i in range(config.num_sub_heads):
        if config.eval_mode == "hung":
            match = hungarian_match(flat_predss[i], flat_targets,
                                    preds_k=config.output_k,
                                    targets_k=config.gt_k)
        elif config.eval_mode == "orig":
            match = original_match(flat_predss[i], flat_targets,
                                   preds_k=config.output_k,
                                   targets_k=config.gt_k)
        else:
            raise ValueError(config.eval_mode)
        all_matches.append(match)

        if not just_matches:
            found = set(p for p, _ in match)
            assert len(found) == config.output_k  # every channel mapped
            reordered = reorder_preds(flat_predss[i], match)
            all_accs[i] = accuracy(reordered, flat_targets, config.gt_k)

    if just_matches:
        return all_matches
    return all_matches, all_accs


def cluster_subheads_eval(config, apply_fn, mapping_assignment_dataloader,
                          mapping_test_dataloader,
                          get_data_fn=clustering_get_data,
                          use_sub_head: Optional[int] = None):
    """Match on the assignment set; IID mode reuses those accuracies as
    test accuracies, IID+ re-maps onto the held-out test set. Returns the
    stats dict."""
    all_matches, train_accs = get_assignment_data_matches(
        config, apply_fn, mapping_assignment_dataloader,
        get_data_fn=get_data_fn)

    best_sub_head_eval = int(np.argmax(train_accs))
    if (config.num_sub_heads > 1) and (use_sub_head is not None):
        best_sub_head = use_sub_head
    else:
        best_sub_head = best_sub_head_eval

    if config.mode == "IID":
        test_accs = train_accs
    elif config.mode == "IID+":
        flat_predss, flat_targets = get_data_fn(
            config, apply_fn, mapping_test_dataloader)
        test_accs = np.zeros(config.num_sub_heads, dtype=np.float32)
        for i in range(config.num_sub_heads):
            reordered = reorder_preds(flat_predss[i], all_matches[i])
            test_accs[i] = accuracy(reordered, flat_targets, config.gt_k)
    else:
        raise ValueError(config.mode)

    return {
        "test_accs": [float(a) for a in test_accs],
        "avg": float(np.mean(test_accs)),
        "std": float(np.std(test_accs)),
        "best": float(test_accs[best_sub_head]),
        "worst": float(test_accs.min()),
        "best_train_sub_head": int(best_sub_head),
        "best_train_sub_head_match": all_matches[best_sub_head],
        "train_accs": [float(a) for a in train_accs],
    }


def cluster_eval(config, apply_fn, mapping_assignment_dataloader,
                 mapping_test_dataloader,
                 history: Optional[EvalHistory] = None,
                 double_eval_apply_fn: Optional[Callable] = None,
                 get_data_fn=clustering_get_data,
                 use_sub_head: Optional[int] = None):
    """One evaluation: ``apply_fn`` is the eval-mode forward; with
    ``double_eval_apply_fn`` (train-mode BN) the double-eval stats are taken
    first. Appends to ``history`` and returns (is_best, stats)."""
    if double_eval_apply_fn is not None:
        stats2 = cluster_subheads_eval(
            config, double_eval_apply_fn, mapping_assignment_dataloader,
            mapping_test_dataloader, get_data_fn=get_data_fn,
            use_sub_head=use_sub_head)
        if history is not None:
            history.double_eval_stats.append(stats2)
            history.double_eval_acc.append(stats2["best"])
            history.double_eval_avg_subhead_acc.append(stats2["avg"])

    stats = cluster_subheads_eval(
        config, apply_fn, mapping_assignment_dataloader,
        mapping_test_dataloader, get_data_fn=get_data_fn,
        use_sub_head=use_sub_head)

    is_best = False
    if history is not None:
        acc = stats["best"]
        is_best = (len(history.epoch_acc) > 0
                   and acc > max(history.epoch_acc))
        history.epoch_stats.append(stats)
        history.epoch_acc.append(acc)
        history.epoch_avg_subhead_acc.append(stats["avg"])
    return is_best, stats


def get_subhead_using_loss(config, apply_fn_pairs, lamb=1.0):
    """Unsupervised sub-head selection: the sub-head with the lowest IID
    loss summed over head-B batches. ``apply_fn_pairs`` yields ((H, bn, k),
    (H, bn, k)) softmax output pairs."""
    loss_per_sub_head = np.zeros(config.num_sub_heads)
    with torch.no_grad():
        for x_outs, x_tf_outs in apply_fn_pairs:
            _, _, losses = iid_loss_multihead(x_outs, x_tf_outs, lamb=lamb)
            loss_per_sub_head += losses.cpu().numpy()
    return int(np.argmin(loss_per_sub_head))
