"""Baseline losses (``iic_tpu/ops/baselines.py``).

``triplets_loss``: the KL-divergence triplet objective of the reference's
triplets baseline,
  KL(softmax(pos) || softmax(orig)) - KL(softmax(neg) || softmax(orig)),
each KL the mean over ALL elements (torch's 'elementwise_mean', which
``F.kl_div(..., reduction="mean")`` computes with a warning that it is not
the batch mean), with 0 log 0 = 0.

``doersch_loss`` / ``isola_loss``: the context-prediction (9-way position
cross-entropy) and adjacency-prediction (binary cross-entropy) objectives
of the segmentation baselines, optionally relevancy-masked per sample.
"""

import sys

import torch
import torch.nn.functional as F


def _kl_div_elementwise_mean(target_probs, input_log_probs):
    """The mean over all elements of target * (log target - input)."""
    return (torch.special.xlogy(target_probs, target_probs)
            - target_probs * input_log_probs).mean()


def triplets_loss(outs_orig, outs_pos, outs_neg):
    """(bn, k) logits each. Minimised."""
    orig = F.log_softmax(outs_orig, dim=1)
    return (_kl_div_elementwise_mean(F.softmax(outs_pos, dim=1), orig)
            - _kl_div_elementwise_mean(F.softmax(outs_neg, dim=1), orig))


def doersch_loss(position_logits, position_labels, mask_per_pred=None):
    """9-way patch-position cross-entropy. ``position_labels`` is one label
    for the batch (0-d) or one a sample (bn,). With ``mask_per_pred`` (bn,)
    a sample counts iff it is relevant, and the sum is normalised by the
    relevant count."""
    labels = torch.as_tensor(position_labels, device=position_logits.device)
    labels = labels.long().expand(position_logits.shape[0])
    per_elem = F.cross_entropy(position_logits, labels, reduction="none")
    if mask_per_pred is None:
        return per_elem.mean()
    return _masked_mean(per_elem, mask_per_pred)


def isola_loss(adjacency_logit, is_adjacent, mask_per_pred=None):
    """Binary cross-entropy on the adjacency probability; (bn, 1) logits.
    With ``mask_per_pred``: per sample -log p_t, p_t the probability of the
    true class; a sample whose p_t is below ``sys.float_info.epsilon``
    contributes 0, but still counts in the denominator, the relevant
    count."""
    logit = adjacency_logit.squeeze(-1)
    gt = torch.as_tensor(is_adjacent, device=logit.device)
    gt = gt.expand(logit.shape).to(torch.float32)
    if mask_per_pred is None:
        return F.binary_cross_entropy_with_logits(logit, gt)
    eps = sys.float_info.epsilon
    pred = torch.sigmoid(logit)
    p_t = torch.where(gt > 0.5, pred, 1.0 - pred)
    keep = (p_t >= eps).to(torch.float32)
    per_elem = -keep * torch.log(torch.clamp(p_t, min=eps))
    return _masked_mean(per_elem, mask_per_pred)


def _masked_mean(per_elem, mask):
    """sum(mask * x) / sum(mask); 0, not NaN, for a batch in which nothing
    is relevant."""
    m = mask.to(torch.float32)
    norm = m.sum()
    return torch.where(norm > 0,
                       (m * per_elem).sum() / torch.clamp(norm, min=1.0),
                       torch.zeros_like(norm))
