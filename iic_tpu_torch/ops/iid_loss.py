"""Clustering IID mutual-information loss (``iic_tpu/ops/iid_loss.py``).

The joint is one k x k matmul ``z^T z_tf`` in full f32 (the JAX package's
``Precision.HIGHEST``; the trainer keeps cuBLAS out of TF32). Every
function also takes a leading sub-head axis, (S, bn, k), in place of the
JAX package's ``vmap``. ``impl="fused"`` routes through K3, the fused CUDA
kernel (``ops/kernels/iid_loss.py``). Under a ``mesh`` (the JAX package's
``axis_name``) the unnormalised joint is summed over ranks before the
symmetrise and the normalise: the global-batch joint.
"""

import sys

import torch

from iic_tpu_torch.ops.kernels.iid_loss import iid_loss_fused
from iic_tpu_torch.parallel.mesh import all_reduce_joint

# Matches the reference EPS = sys.float_info.epsilon (2^-52, not FLT_EPSILON)
EPS = sys.float_info.epsilon


def compute_joint(x_out, x_tf_out, weights=None, mesh=None):
    """Joint distribution P (k x k) from paired softmax outputs (..., bn, k):
    sum of outer products over the batch, symmetrised, normalised to 1.
    ``weights`` (bn,) weights each sample's outer product; all ones is
    identical to none (zero masks a padded row out exactly). ``mesh``: the
    unnormalised joint is summed over its ranks first."""
    if tuple(x_tf_out.shape) != tuple(x_out.shape):
        raise ValueError(f"shapes {tuple(x_out.shape)} and "
                         f"{tuple(x_tf_out.shape)} differ")
    dtype = torch.promote_types(x_out.dtype, torch.float32)
    x_out = x_out.to(dtype)
    if weights is not None:
        if tuple(weights.shape) != (x_out.shape[-2],):
            raise ValueError(f"weights {tuple(weights.shape)} for batch "
                             f"{x_out.shape[-2]}")
        x_out = x_out * weights.to(dtype)[:, None]
    p_i_j = torch.matmul(x_out.transpose(-1, -2), x_tf_out.to(dtype))
    p_i_j = all_reduce_joint(p_i_j, mesh)
    p_i_j = (p_i_j + p_i_j.transpose(-1, -2)) / 2.0  # symmetrise
    return p_i_j / p_i_j.sum(dim=(-2, -1), keepdim=True)  # normalise


def iid_loss_from_joint(p_i_j, lamb=1.0, eps=EPS):
    """MI objective from a normalised joint (..., k, k). Returns (loss,
    loss_no_lamb). The marginals come from the *unclamped* joint; then joint
    and marginals are clamped below eps (reference clamp order)."""
    p_i = p_i_j.sum(dim=-1, keepdim=True)  # marginal over j, (..., k, 1)
    p_j = p_i_j.sum(dim=-2, keepdim=True)  # marginal over i, (..., 1, k)

    p_i_j = p_i_j.clamp_min(eps)
    p_i = p_i.clamp_min(eps)
    p_j = p_j.clamp_min(eps)

    log_p, log_pi, log_pj = torch.log(p_i_j), torch.log(p_i), torch.log(p_j)
    loss = -(p_i_j * (log_p - lamb * log_pj - lamb * log_pi)).sum(
        dim=(-2, -1))
    loss_no_lamb = -(p_i_j * (log_p - log_pj - log_pi)).sum(dim=(-2, -1))
    return loss, loss_no_lamb


def IID_loss(x_out, x_tf_out, lamb=1.0, EPS=EPS, impl="xla", weights=None,
             mesh=None):
    """IID clustering loss (reference ``IID_loss``): ``(loss,
    loss_no_lamb)`` for softmax outputs (bn, k), or per sub-head for
    (S, bn, k).

    ``impl="xla"`` is the plain torch formulation (the JAX package's name
    for its default path, kept so flags carry over); ``impl="fused"`` runs
    K3, which hard-codes machine epsilon and takes no weights and no mesh
    (its joint is one rank's). ``mesh``: the global joint over its
    ranks."""
    if impl == "fused":
        if mesh is not None:
            raise ValueError("the fused kernel computes one rank's joint; "
                             "use impl='xla' with a mesh")
        if EPS != sys.float_info.epsilon:
            raise ValueError("the fused kernel hard-codes machine epsilon; "
                             "pass impl='xla' for a custom EPS")
        if weights is not None:
            raise ValueError("the weighted loss is xla-only")
        return iid_loss_fused(x_out, x_tf_out, lamb)
    if impl != "xla":
        raise ValueError(f"unknown impl {impl!r}")
    p_i_j = compute_joint(x_out, x_tf_out, weights=weights, mesh=mesh)
    return iid_loss_from_joint(p_i_j, lamb=lamb, eps=EPS)


def iid_loss_multihead(x_outs, x_tf_outs, lamb=1.0):
    """Per-sub-head IID loss over (S, bn, k) pairs: (mean loss, mean
    loss_no_lamb, per-sub-head losses (S,))."""
    losses, losses_no_lamb = IID_loss(x_outs, x_tf_outs, lamb=lamb)
    return losses.mean(), losses_no_lamb.mean(), losses
