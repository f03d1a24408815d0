"""Displacement joint of the uncollapsed segmentation loss: the CUDA kernels
K1 (forward) and K2 (input gradient), their plain PyTorch versions, and the
``SegJoint`` autograd function that ties them together.

Replaces ``iic_tpu/ops/pallas/seg_joint_kernel.py``: K1 replaces
``_joint_kernel`` (launched by ``_joint_pallas_raw``), K2 replaces
``_dgrad_kernel`` (launched by ``_dgrad_pallas``), and ``SegJoint`` replaces
the ``jax.custom_vjp`` ``displacement_joint_dense_pallas``. The kernels'
source, with the note on what bounds them on the H100 and how their design
answers it, is ``iic_tpu_torch/csrc/seg_joint.cu``.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; it never falls back.
"""

import ctypes
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from iic_tpu_torch.ops.kernels import _build

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"seg_joint_fwd": 0, "seg_joint_dgrad": 0}

# Blocks K1 aims to put in flight: eight per SM of the H100's 132.
_TARGET_BLOCKS = 8 * 132
_TILE = 64  # K1's output tile edge (csrc/seg_joint.cu BM, BN)


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextmanager
def full_f32():
    """Run cuDNN convolutions in full f32 inside the block (the plain
    versions mirror the JAX package's ``Precision.HIGHEST``), whatever the
    process-wide TF32 setting is."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ------------------------------------------------------------ plain versions

def _at_least_f32(x):
    """f32, or f64 for f64 input (a float64 reference for the checks)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def displacement_joint_dense(x1, x2, half_t):
    """Plain version of K1: the (k, k, T, T) joint as a conv whose filters
    are activations, out[i,j,u,v] = sum_{n,p,q} x1[n,i,u+p-h,v+q-h] *
    x2[n,j,p,q] (``iic_tpu/ops/iid_seg_loss.py::displacement_joint_dense``).
    """
    lhs = _at_least_f32(x1).transpose(0, 1)  # (k, n, h, w)
    rhs = _at_least_f32(x2).transpose(0, 1)
    with full_f32():
        return F.conv2d(lhs, rhs, padding=half_t)


def dgrad_plain(g2d, other, half_t):
    """Plain version of K2, with ``_dgrad_pallas``'s contract: ``g2d`` is the
    (kT, kT) reordered adjoint, g2d[(v,i),(u,j)] = g[i,j,u,v]; ``other`` the
    row-shifted operand (n, k, h, w). Returns dx[n,i,y,x] = sum_{j,u,v}
    g[i,j,u,v] * other[n,j,y-u+h,x-v+h], a conv of ``other`` with g flipped
    in both displacement axes."""
    k = other.shape[1]
    t = 2 * half_t + 1
    g = _at_least_f32(g2d).reshape(t, k, t, k).permute(1, 3, 2, 0)  # i,j,u,v
    with full_f32():
        return F.conv2d(_at_least_f32(other), g.flip(2, 3), padding=half_t)


# ------------------------------------------------------------------ wrappers

def _check(name, x, shape=None):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")


def _lib():
    lib = _build.library("seg_joint")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seg_joint_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.seg_joint_fwd.restype = i
        lib.seg_joint_dgrad.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.seg_joint_dgrad.restype = i
        lib._typed = True
    return lib


def _split(rows, tiles):
    """(splits, rows_per_chunk) cutting ``rows`` (n, y) rows so that K1 puts
    about _TARGET_BLOCKS blocks in flight."""
    want = max(1, min(rows, -(-_TARGET_BLOCKS // tiles)))
    per = -(-rows // want)
    return -(-rows // per), per


def joint_fwd(x1, x2, half_t):
    """K1: the (k, k, T, T) displacement joint of x1, x2 (n, k, h, w)."""
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return displacement_joint_dense(x1, x2, half_t)
    if x1.device.type != "cuda" or x2.device != x1.device:
        raise ValueError(f"joint_fwd: inputs on {x1.device} and {x2.device}")
    _check("x1", x1)
    _check("x2", x2, x1.shape)
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    tk = k * t
    tiles = (-(-tk // _TILE)) ** 2
    splits, per = _split(n * h, tiles)
    part = torch.empty((splits, tk, tk), device=x1.device, dtype=torch.float32)
    out = torch.empty((k, k, t, t), device=x1.device, dtype=torch.float32)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = _lib().seg_joint_fwd(x1.data_ptr(), x2.data_ptr(), part.data_ptr(),
                               out.data_ptr(), n, k, h, w, half_t, splits,
                               per, stream)
    if err != 0:
        raise RuntimeError(f"seg_joint_fwd launch failed: CUDA error {err}")
    LAUNCHES["seg_joint_fwd"] += 1
    return out


def joint_dgrad(g2d, other, half_t):
    """K2: the gradient for the column-shifted operand, in the unpadded
    (n, k, h, w) frame (see ``dgrad_plain`` for the contract)."""
    if g2d.device.type == "cpu" and other.device.type == "cpu":
        return dgrad_plain(g2d, other, half_t)
    if other.device.type != "cuda" or g2d.device != other.device:
        raise ValueError(f"joint_dgrad: inputs on {g2d.device} and "
                         f"{other.device}")
    n, k, h, w = other.shape
    tk = k * (2 * half_t + 1)
    _check("other", other)
    _check("g2d", g2d, (tk, tk))
    dx = torch.empty_like(other)
    with torch.cuda.device(other.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = _lib().seg_joint_dgrad(g2d.data_ptr(), other.data_ptr(),
                                 dx.data_ptr(), n, k, h, w, half_t, stream)
    if err != 0:
        raise RuntimeError(f"seg_joint_dgrad launch failed: CUDA error {err}")
    LAUNCHES["seg_joint_dgrad"] += 1
    return dx


def adjoints(g):
    """The two reordered (kT, kT) adjoints of a joint cotangent g (k,k,T,T),
    as ``_joint_bwd`` builds them: for dx1, G[(v,i),(u,j)] = g[i,j,u,v];
    for dx2 (swap symmetry P[i,j,u,v] = P_swap[j,i,2h-u,2h-v]),
    G_swap[(v',j),(u',i)] = g[i,j,2h-u',2h-v']."""
    k, _, t, _ = g.shape
    g = g.float()
    g2d = g.permute(3, 0, 2, 1).reshape(t * k, t * k).contiguous()
    g2d_swap = (g.flip(2, 3).permute(3, 1, 2, 0).reshape(t * k, t * k)
                .contiguous())
    return g2d, g2d_swap


class SegJoint(torch.autograd.Function):
    """The displacement joint with K1 forward and K2 backward."""

    @staticmethod
    def forward(ctx, x1, x2, half_t):
        x1 = x1.contiguous()
        x2 = x2.contiguous()
        ctx.save_for_backward(x1, x2)
        ctx.half_t = half_t
        return joint_fwd(x1, x2, half_t)

    @staticmethod
    def backward(ctx, g):
        x1, x2 = ctx.saved_tensors
        g2d, g2d_swap = adjoints(g)
        dx1 = joint_dgrad(g2d, x2, ctx.half_t)
        dx2 = joint_dgrad(g2d_swap, x1, ctx.half_t)
        return dx1.to(x1.dtype), dx2.to(x2.dtype), None


def displacement_joint_dense_kernel(x1, x2, half_t):
    """Drop-in for ``displacement_joint_dense`` through K1 / K2."""
    return SegJoint.apply(x1, x2, half_t)
