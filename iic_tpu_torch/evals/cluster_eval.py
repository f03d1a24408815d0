"""Sub-head evaluation by cluster-to-class matching
(``iic_tpu/evals/cluster_eval.py``: ``EvalHistory``,
``get_assignment_data_matches``, ``cluster_subheads_eval``).

The caller supplies ``apply_fn(imgs) -> (num_sub_heads, bn, k, ...)`` and a
``get_data_fn`` that turns a loader into flat per-sub-head predictions and
targets (``segmentation_eval.segmentation_get_data`` for segmentation).
"""

import dataclasses
from typing import List, Optional

import numpy as np

from iic_tpu_torch.evals.metrics import (
    accuracy, hungarian_match, original_match, reorder_preds)


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


def get_assignment_data_matches(config, apply_fn,
                                mapping_assignment_dataloader,
                                get_data_fn, just_matches=False):
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
                          mapping_test_dataloader, get_data_fn,
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
