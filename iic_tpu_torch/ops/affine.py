"""Differentiable affine warps (``iic_tpu/ops/affine.py``, ``impl="gather"``).

PyTorch's own ``affine_grid`` / ``grid_sample`` with ``align_corners=True``,
bilinear, zero padding are the reference's exact semantics: normalised -1
maps to the centre of the first pixel and +1 to the centre of the last, and
out-of-bounds corners contribute zero. The JAX package's approximate
``"matmul"`` warp is not ported; the port always warps exactly.
"""

import torch.nn.functional as F


def affine_grid(theta, size):
    """(N, 2, 3) output->input matrices in normalised coordinates ->
    (N, H, W, 2) sampling grid, last dim (x, y)."""
    return F.affine_grid(theta.float(), list(size), align_corners=True)


def grid_sample(data, grid):
    """Bilinear, zero-padded sampling of (N, C, H, W) at (N, Ho, Wo, 2)."""
    return F.grid_sample(data.float(), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def perform_affine_tf(data, tf_matrices):
    """Warp (N, K, H, W) maps by per-sample (N, 2, 3) affine matrices,
    keeping gradients (reference ``perform_affine_tf``)."""
    n, r, c = tf_matrices.shape
    if n != data.shape[0] or (r, c) != (2, 3):
        raise ValueError(f"perform_affine_tf: matrices {tuple(tf_matrices.shape)}"
                         f" for data {tuple(data.shape)}")
    return grid_sample(data, affine_grid(tf_matrices, data.shape))
