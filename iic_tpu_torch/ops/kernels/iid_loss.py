"""Fused clustering IID loss: the CUDA kernel K3 (forward), its plain
PyTorch version, the analytic backward and the ``IIDLossFused`` autograd
function that ties them together.

Replaces ``iic_tpu/ops/pallas/iid_loss_kernel.py``: K3 replaces
``_fwd_kernel`` (launched by ``_fwd``), and ``IIDLossFused`` the
``jax.custom_vjp`` ``iid_loss_fused``, whose backward (``_vjp_bwd``) is
plain array math there and torch ops here. The kernel's source, with the
note on what bounds it on the H100 and how its design answers it, is
``iic_tpu_torch/csrc/iid_loss.cu``.

Inputs are softmax pairs z, zt of shape (bn, k), or (S, bn, k) for S
sub-heads in one launch; each sub-head's numbers are the same either way.
The kernel has two forms (``FORMS``): ``"cluster"``, the default, one
thread-block cluster of ``CLUSTER`` blocks per sub-head, each block a
contiguous range of the rows, the partial joints added in rank order
through distributed shared memory; and ``"block"``, the port's first
kernel, one block per sub-head walking all its rows, kept for timing
against it.
A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; it never falls back.
"""

import ctypes
import sys

import torch

from iic_tpu_torch.ops.kernels import _build

EPS = sys.float_info.epsilon  # 2^-52, as the reference; the kernel's too
FORMS = ("cluster", "block")
# Blocks of a sub-head's cluster in the cluster form (the kernel's
# ``kCluster``): 16, a non-portable size, faster than 8, the portable
# maximum, at the clustering path's shapes on the H100
CLUSTER = 16

# Launches of the kernel, counted where the wrapper launches it.
LAUNCHES = {"iid_loss_fwd": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------- plain version

def _marginals(p):
    """Row sums (..., k, 1) and column sums (..., 1, k) of the joint."""
    return p.sum(dim=-1, keepdim=True), p.sum(dim=-2, keepdim=True)


def iid_loss_fused_plain(z, zt, lamb=1.0):
    """Plain version of K3: (loss, loss_nl, P, total) for z, zt (..., bn, k),
    in f32 (f64 for f64 input, a float64 reference for the checks)."""
    dtype = torch.promote_types(z.dtype, torch.float32)
    z, zt = z.to(dtype), zt.to(dtype)
    s = torch.matmul(z.transpose(-1, -2), zt)
    s = (s + s.transpose(-1, -2)) / 2.0
    total = s.sum(dim=(-2, -1))
    p = s / total[..., None, None]
    p_i, p_j = _marginals(p)
    log_p = torch.log(p.clamp_min(EPS))
    log_pi = torch.log(p_i.clamp_min(EPS))
    log_pj = torch.log(p_j.clamp_min(EPS))
    p_c = p.clamp_min(EPS)
    loss = -(p_c * (log_p - lamb * log_pj - lamb * log_pi)).sum(dim=(-2, -1))
    loss_nl = -(p_c * (log_p - log_pj - log_pi)).sum(dim=(-2, -1))
    return loss, loss_nl, p, total


# ------------------------------------------------------------------ wrapper

def _lib():
    lib = _build.library("iid_loss")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.iid_loss_fwd.argtypes = [p, p, p, p, p, p, i, i, i,
                                     ctypes.c_float, i, p]
        lib.iid_loss_fwd.restype = i
        lib.iid_loss_max_k.argtypes = []
        lib.iid_loss_max_k.restype = i
        lib.iid_loss_launch_floor.argtypes = [i, i, p]
        lib.iid_loss_launch_floor.restype = i
        lib.iid_loss_smem.argtypes = [i, i]
        lib.iid_loss_smem.restype = i
        lib.max_k = lib.iid_loss_max_k()
        lib._typed = True
    return lib


def iid_loss_fwd(z, zt, lamb=1.0, form="cluster"):
    """K3: (loss, loss_nl, P, total) for z, zt (bn, k) or (S, bn, k), in
    the form ``form`` (one of ``FORMS``)."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    device = z.device
    if device.type == "cpu" and zt.device.type == "cpu":
        return iid_loss_fused_plain(z, zt, lamb)
    if device.type != "cuda" or zt.device != device:
        raise ValueError(f"iid_loss_fwd: inputs on {device} and "
                         f"{zt.device}")
    if z.dim() not in (2, 3) or tuple(zt.shape) != tuple(z.shape):
        raise ValueError(f"iid_loss_fwd: expected two (bn, k) or (S, bn, k) "
                         f"tensors, got {tuple(z.shape)} and "
                         f"{tuple(zt.shape)}")
    for name, x in (("z", z), ("zt", zt)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: kernel takes a contiguous tensor")
    lib = _lib()
    s, bn, k = z.shape if z.dim() == 3 else (1, *z.shape)
    if bn < 1 or not 1 <= k <= lib.max_k:
        raise ValueError(f"iid_loss_fwd: bn={bn}, k={k}; the kernel takes "
                         f"bn >= 1 and 1 <= k <= {lib.max_k}")
    out = dict(device=device, dtype=torch.float32)
    loss, loss_nl, total = (torch.empty((s,), **out) for _ in range(3))
    p = torch.empty((s, k, k), **out)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.iid_loss_fwd(z.data_ptr(), zt.data_ptr(), loss.data_ptr(),
                           loss_nl.data_ptr(), p.data_ptr(),
                           total.data_ptr(), s, bn, k, float(lamb),
                           CLUSTER if form == "cluster" else 0, stream)
    if err != 0:
        raise RuntimeError(f"iid_loss_fwd launch failed: CUDA error {err}")
    LAUNCHES["iid_loss_fwd"] += 1
    if z.dim() == 2:
        return loss[0], loss_nl[0], p[0], total[0]
    return loss, loss_nl, p, total


# ----------------------------------------------------------------- backward

def iid_loss_bwd(z, zt, p, total, g_loss, g_loss_nl, lamb):
    """Analytic gradient of (loss, loss_nl) for z, zt from the saved P and
    total (``_vjp_bwd``): the clamps are stop-gradient masks, the marginals
    sums of the unclamped P. Batched over leading sub-head dims."""
    p_i, p_j = _marginals(p)
    m = (p >= EPS).to(p.dtype)
    mi = (p_i >= EPS).to(p.dtype)
    mj = (p_j >= EPS).to(p.dtype)
    p_c = p.clamp_min(EPS)
    p_i_c = p_i.clamp_min(EPS)
    p_j_c = p_j.clamp_min(EPS)
    log_p, log_pi, log_pj = torch.log(p_c), torch.log(p_i_c), torch.log(p_j_c)
    row_sum_pc, col_sum_pc = _marginals(p_c)

    def dl_dp(lam, gscale):
        d = -(log_p + 1.0 - lam * log_pj - lam * log_pi) * m
        d = d + lam * (row_sum_pc / p_i_c) * mi
        d = d + lam * (col_sum_pc / p_j_c) * mj
        return gscale[..., None, None] * d

    d_p = dl_dp(lamb, g_loss) + dl_dp(1.0, g_loss_nl)
    # P = sym(S) / T with T = sum(S):
    # dS = (dP + dP^T) / (2T) - sum(dP * P) / T
    t = total[..., None, None]
    inner = (d_p * p).sum(dim=(-2, -1), keepdim=True)
    d_s = (d_p + d_p.transpose(-1, -2)) / (2.0 * t) - inner / t
    dz = torch.matmul(zt.to(p.dtype), d_s.transpose(-1, -2))
    dzt = torch.matmul(z.to(p.dtype), d_s)
    return dz.to(z.dtype), dzt.to(zt.dtype)


class IIDLossFused(torch.autograd.Function):
    """(loss, loss_nl) through K3 forward and the analytic backward."""

    @staticmethod
    def forward(ctx, z, zt, lamb):
        z = z.contiguous()
        zt = zt.contiguous()
        loss, loss_nl, p, total = iid_loss_fwd(z, zt, lamb)
        ctx.save_for_backward(z, zt, p, total)
        ctx.lamb = lamb
        return loss, loss_nl

    @staticmethod
    def backward(ctx, g_loss, g_loss_nl):
        z, zt, p, total = ctx.saved_tensors
        dz, dzt = iid_loss_bwd(z, zt, p, total, g_loss, g_loss_nl, ctx.lamb)
        return dz, dzt, None


def iid_loss_fused(z, zt, lamb=1.0):
    """Fused IID loss: (bn, k) or (S, bn, k) softmax pairs -> (loss,
    loss_no_lamb), scalars or (S,). Matches ``ops.iid_loss.IID_loss``."""
    return IIDLossFused.apply(z, zt, lamb)
