"""Segmentation IID losses with local spatial invariance
(``iic_tpu/ops/iid_seg_loss.py``).

Inputs keep the JAX layout: head maps (N, K, H, W), affines (N, 2, 3),
relevancy masks (N, H, W). The displacement joint of the uncollapsed loss
runs the hand-written CUDA kernels (``joint_impl="pallas"``, the JAX
package's name for its own kernel, kept so command lines carry over) or
the plain conv (``joint_impl="conv"``). Under a ``mesh`` (the JAX
package's ``axis_name``) each rank's raw joint is summed over the ranks
before any normalisation: K1 runs on the rank's shard, and K2 receives the
same upstream gradient on every rank.
"""

import sys

import torch

from iic_tpu_torch.ops.affine import perform_affine_tf
from iic_tpu_torch.ops.kernels.seg_joint import (
    displacement_joint_dense, displacement_joint_dense_kernel)
from iic_tpu_torch.parallel.mesh import all_reduce_joint

EPS = sys.float_info.epsilon

__all__ = ["EPS", "random_translation_multiple", "displacement_joint_collapsed",
           "displacement_joint_dense", "IID_segmentation_loss",
           "IID_segmentation_loss_uncollapsed"]


def random_translation_multiple(data, half_side_min, half_side_max,
                                generator=None):
    """Shift the whole batch by one random (x, y) displacement of magnitude
    in [min, max] and random polarity, zero-filling (reference
    ``random_translation_multiple``)."""
    n, c, h, w = data.shape
    dev = generator.device if generator is not None else torch.device("cpu")
    mag = torch.randint(half_side_min, half_side_max + 1, (2,),
                        generator=generator, device=dev)
    sign = torch.randint(0, 2, (2,), generator=generator, device=dev) * 2 - 1
    tx, ty = (mag * sign + half_side_max).tolist()
    padded = torch.nn.functional.pad(data, (half_side_max,) * 4)
    return padded[:, :, ty:ty + h, tx:tx + w]


def _box_sum_1d(x, half_t, dim):
    """Windowed sum of size 2*half_t+1 along ``dim``, zero-padded, as a
    cumsum difference."""
    t = 2 * half_t + 1
    length = x.shape[dim]
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - dim)] = half_t + 1
    pad[2 * (x.ndim - 1 - dim) + 1] = half_t
    c = torch.cumsum(torch.nn.functional.pad(x, pad), dim=dim)
    return c.narrow(dim, t, length) - c.narrow(dim, 0, length)


def _box_sum(x, half_t):
    """Sum over a (2*half_t+1)^2 window at every position of (N, K, H, W)."""
    if half_t == 0:
        return x
    return _box_sum_1d(_box_sum_1d(x, half_t, 2), half_t, 3)


def displacement_joint_collapsed(x1, x2, half_t):
    """(K, K) joint summed over displacements, as a box filter and one
    matmul (equals the conv joint summed over its (T, T) dims)."""
    x1_box = _box_sum(x1.float(), half_t)
    return torch.einsum("nihw,njhw->ij", x1_box, x2.float())


def _warp_mask(x1_outs, x2_outs, all_affine2_to_1, all_mask_img1,
               half_T_side_sparse_min, half_T_side_sparse_max, generator):
    """Inverse-affine warp of x2 into x1's frame, optional sparse random
    translation, relevancy masking."""
    if x1_outs.shape != x2_outs.shape:
        raise ValueError("head maps differ in shape")
    bn, k, h, w = x1_outs.shape
    x2_outs_inv = perform_affine_tf(x2_outs, all_affine2_to_1)
    if half_T_side_sparse_min != 0 or half_T_side_sparse_max != 0:
        x2_outs_inv = random_translation_multiple(
            x2_outs_inv, half_T_side_sparse_min, half_T_side_sparse_max,
            generator=generator)
    mask = all_mask_img1.reshape(bn, 1, h, w).to(x1_outs.dtype)
    return x1_outs * mask, x2_outs_inv * mask


def _mi(p, p_i_mat, p_j_mat, lamb):
    """Clamped MI terms -> (loss, loss_no_lamb) sums."""
    p = p.clamp_min(EPS)
    log_i = torch.log(p_i_mat.clamp_min(EPS))
    log_j = torch.log(p_j_mat.clamp_min(EPS))
    log_p = torch.log(p)
    loss = -torch.sum(p * (log_p - lamb * log_i - lamb * log_j))
    loss_no_lamb = -torch.sum(p * (log_p - log_i - log_j))
    return loss, loss_no_lamb


def IID_segmentation_loss(x1_outs, x2_outs, all_affine2_to_1=None,
                          all_mask_img1=None, lamb=1.0,
                          half_T_side_dense=None,
                          half_T_side_sparse_min=None,
                          half_T_side_sparse_max=None, generator=None,
                          mesh=None):
    """Collapsed loss: normalise by a detached total, THEN symmetrise,
    clamp joint and marginals. Returns ``(loss, loss_no_lamb)``. ``mesh``:
    the raw joint is summed over its ranks first."""
    x1m, x2m = _warp_mask(x1_outs, x2_outs, all_affine2_to_1, all_mask_img1,
                          half_T_side_sparse_min, half_T_side_sparse_max,
                          generator)
    p = displacement_joint_collapsed(x1m, x2m, half_T_side_dense)
    p = all_reduce_joint(p, mesh)
    p = p / p.sum().detach()
    p = (p + p.t()) / 2.0
    k = p.shape[0]
    return _mi(p, p.sum(dim=1).reshape(k, 1), p.sum(dim=0).reshape(1, k),
               lamb)


def IID_segmentation_loss_uncollapsed(x1_outs, x2_outs,
                                      all_affine2_to_1=None,
                                      all_mask_img1=None, lamb=1.0,
                                      half_T_side_dense=None,
                                      half_T_side_sparse_min=None,
                                      half_T_side_sparse_max=None,
                                      generator=None, joint_impl="pallas",
                                      mesh=None):
    """Uncollapsed loss: each of the T x T displacement joints is normalised,
    symmetrised and clamped on its own; the sum is divided by T^2. ``mesh``:
    the raw (k, k, T, T) joint is summed over its ranks first.

    joint_impl: "pallas" runs the hand-written CUDA kernels (the plain conv
    for CPU tensors), "conv" the plain conv; "fft" is not ported.
    """
    if joint_impl == "pallas":
        joint_fn = displacement_joint_dense_kernel
    elif joint_impl == "conv":
        joint_fn = displacement_joint_dense
    elif joint_impl == "fft":
        raise NotImplementedError(
            "joint_impl='fft' is not ported; use 'pallas' or 'conv'")
    else:
        raise ValueError(f"unknown joint_impl {joint_impl!r}")
    x1m, x2m = _warp_mask(x1_outs, x2_outs, all_affine2_to_1, all_mask_img1,
                          half_T_side_sparse_min, half_T_side_sparse_max,
                          generator)
    t_side = 2 * half_T_side_dense + 1
    p = joint_fn(x1m, x2m, half_T_side_dense)      # (k, k, T, T)
    p = all_reduce_joint(p, mesh)
    p = p.permute(2, 3, 0, 1)                      # (T, T, k, k)
    p = p / p.sum(dim=(2, 3), keepdim=True)        # per-displacement norm
    p = (p + p.transpose(2, 3)) / 2.0
    loss, loss_no_lamb = _mi(p, p.sum(dim=2, keepdim=True),
                             p.sum(dim=3, keepdim=True), lamb)
    denom = t_side * t_side
    return loss / denom, loss_no_lamb / denom
