"""Segmentation geometry transforms (``iic_tpu/data/seg_transforms.py``).

Host side (numpy, variable-size images before batching): centre padding and
the centre / fixed / random crop conventions. Device side: the random
rotation-shear-scale affine of img2 and its inverse.
"""

import math

import numpy as np
import torch

from iic_tpu_torch.ops.affine import perform_affine_tf


def pad_if_too_small(data, sz):
    """Centre-pad with zeros to at least (sz, sz)."""
    reshape = data.ndim == 2
    if reshape:
        data = data[:, :, None]
    h, w, c = data.shape
    if h >= sz and w >= sz:
        out = data
    else:
        new_h, new_w = max(h, sz), max(w, sz)
        out = np.zeros((new_h, new_w, c), dtype=data.dtype)
        h_start = int(new_h / 2.0) - int(h / 2.0)
        w_start = int(new_w / 2.0) - int(w / 2.0)
        out[h_start:h_start + h, w_start:w_start + w, :] = data
    return out[:, :, 0] if reshape else out


def pad_and_or_crop(orig_data, sz, mode=None, coords=None, rng=None):
    """Crop to (sz, sz) about a centre chosen by ``mode``; returns
    (data, (h_c, w_c)) so a label map can be cropped at the same centre
    with mode="fixed". ``rng`` is a ``np.random.Generator``."""
    data = pad_if_too_small(orig_data, sz)
    reshape = data.ndim == 2
    if reshape:
        data = data[:, :, None]
    h, w, _ = data.shape
    if mode == "centre":
        h_c, w_c = int(h / 2.0), int(w / 2.0)
    elif mode == "fixed":
        if coords is None:
            raise ValueError("mode='fixed' needs coords")
        h_c, w_c = coords
    elif mode == "random":
        half = int(sz / 2.0)
        if sz % 2 == 1:
            h_c_max, w_c_max = h - 1 - half, w - 1 - half
        else:
            h_c_max, w_c_max = h - half, w - half
        h_c = int(rng.integers(half, h_c_max + 1))
        w_c = int(rng.integers(half, w_c_max + 1))
    else:
        raise ValueError(mode)
    h_start = h_c - int(sz / 2.0)
    w_start = w_c - int(sz / 2.0)
    data = data[h_start:h_start + sz, w_start:w_start + sz, :]
    return (data[:, :, 0] if reshape else data), (h_c, w_c)


def rss_affines(rot_deg, shear_deg, scale):
    """Per-sample rotation-shear-scale matrices (B, 2, 3) from per-sample
    draws (B,):  [[cos(a)s, -sin(a+sh)s, 0], [sin(a)s, cos(a+sh)s, 0]],
    and their analytic inverses affine2_to_1."""
    a = rot_deg * (math.pi / 180.0)
    sh = shear_deg * (math.pi / 180.0)
    m00 = torch.cos(a) * scale
    m01 = -torch.sin(a + sh) * scale
    m10 = torch.sin(a) * scale
    m11 = torch.cos(a + sh) * scale
    zero = torch.zeros_like(m00)
    fwd = torch.stack([torch.stack([m00, m01, zero], -1),
                       torch.stack([m10, m11, zero], -1)], -2)
    det = (m00 * m11 - m01 * m10)[:, None, None]
    inv = torch.stack([torch.stack([m11, -m01, zero], -1),
                       torch.stack([-m10, m00, zero], -1)], -2) / det
    return fwd, inv


def seg_random_affine(imgs_chw, u, min_rot=-30.0, max_rot=30.0,
                      min_shear=-10.0, max_shear=10.0, min_scale=0.8,
                      max_scale=1.2):
    """Warp a batch (B, C, H, W) by RSS affines drawn from the uniforms
    ``u`` (B, 3) in [0, 1) (rotation, shear, scale); returns (warped,
    affine2_to_1 (B, 2, 3)). The warp is exact bilinear."""
    rot = min_rot + u[:, 0] * (max_rot - min_rot)
    shear = min_shear + u[:, 1] * (max_shear - min_shear)
    scale = min_scale + u[:, 2] * (max_scale - min_scale)
    fwd, inv = rss_affines(rot, shear, scale)
    return perform_affine_tf(imgs_chw, fwd), inv
