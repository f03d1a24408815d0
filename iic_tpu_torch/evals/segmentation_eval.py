"""Segmentation evaluation (``iic_tpu/evals/segmentation_eval.py``):
per-pixel argmax predictions, flattened, relevancy mask applied, then the
same Hungarian machinery as clustering."""

from typing import Optional

import numpy as np

from iic_tpu_torch.evals.cluster_eval import (
    EvalHistory, cluster_subheads_eval)


def segmentation_get_data(config, apply_fn, dataloader):
    """``apply_fn(imgs) -> (H, bn, k, h, w)`` softmax maps (a tensor);
    the loader yields (imgs, flat_targets (bn, h, w), mask (bn, h, w)).
    Returns (flat_predss (H, M), flat_targets (M,)) with the mask applied,
    batch by batch."""
    assert config.output_k <= 255
    predss, targets = [], []
    for imgs, flat_targets, mask in dataloader:
        x_outs = apply_fn(imgs)  # (H, bn, k, h, w)
        assert x_outs.shape[0] == config.num_sub_heads
        assert x_outs.shape[2] == config.output_k
        m = np.asarray(mask).reshape(-1).astype(bool)
        preds = x_outs.argmax(dim=2).cpu().numpy()  # (H, bn, h, w)
        predss.append(preds.reshape(preds.shape[0], -1)[:, m]
                      .astype(np.int32))
        targets.append(np.asarray(flat_targets).reshape(-1)[m]
                       .astype(np.int32))
    return np.concatenate(predss, axis=1), np.concatenate(targets)


def segmentation_eval(config, apply_fn, mapping_assignment_dataloader,
                      mapping_test_dataloader,
                      history: Optional[EvalHistory] = None,
                      return_only: bool = False):
    """Stats of one evaluation; with ``history``, append them and return
    whether this is the best epoch so far."""
    stats = cluster_subheads_eval(
        config, apply_fn,
        mapping_assignment_dataloader=mapping_assignment_dataloader,
        mapping_test_dataloader=mapping_test_dataloader,
        get_data_fn=segmentation_get_data)

    if return_only or history is None:
        return stats

    acc = stats["best"]
    is_best = (len(history.epoch_acc) > 0) and (acc > max(history.epoch_acc))
    history.epoch_stats.append(stats)
    history.epoch_acc.append(acc)
    history.epoch_avg_subhead_acc.append(stats["avg"])
    return is_best
