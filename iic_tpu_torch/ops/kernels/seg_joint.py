"""Displacement joint of the uncollapsed segmentation loss: the CUDA kernels
K1 (forward) and K2 (input gradient), their plain PyTorch versions, and the
``SegJoint`` autograd function that ties them together. Both kernels round
their operands to bf16 on the card, as the TPU kernels do, and at k > 4
run on the tensor cores: K1 on the stack product of
``csrc/joint_fwd_common.cuh`` (which X7 shares), K2 on X8's implicit GEMM.
Their operand layouts and shared-memory plans are here so that the training
path needs nothing of the experiment tool's module (``joint_exp``), which
imports them from here.

Replaces ``iic_tpu/ops/pallas/seg_joint_kernel.py``: K1 replaces
``_joint_kernel`` (launched by ``_joint_pallas_raw``), K2 replaces
``_dgrad_kernel`` (launched by ``_dgrad_pallas``), and ``SegJoint`` replaces
the ``jax.custom_vjp`` ``displacement_joint_dense_pallas``. The kernels'
source, with the note on what bounds them on the H100 and how their design
answers it, is ``iic_tpu_torch/csrc/seg_joint.cu`` (K1's tensor-core form in
``csrc/joint_fwd_common.cuh``, K2's in ``csrc/dgrad_common.cuh``).

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

# Blocks K1's CUDA-core form aims to put in flight: eight per SM of the
# H100's 132.
_TARGET_BLOCKS = 8 * 132
_TILE = 64  # the CUDA-core form's output tile edge (csrc/joint_common.cuh)
_SMEM_BLOCK = 232448  # shared memory a block may use on the H100
K1_FORMS = ("wgmma", "cuda-core")
# K1's tensor-core form (csrc/joint_fwd_common.cuh): channels of a chunk,
# pixels of a column slab, rows of a row slab, shifts v of an M tile, core
# matrices along N of a warpgroup, warpgroups of a block (an N tile is
# _JF_WGS * _JF_CM / 2 shifts u), and its dynamic shared memory
_JF_CH, _JF_PIX, _JF_ROWS, _JF_V, _JF_CM, _JF_WGS = 16, 64, 16, 4, 21, 2
_JF_U = _JF_WGS * _JF_CM // 2
_JF_A_PIX = _JF_PIX + _JF_V
_JF_SMEM = ((_JF_ROWS + _JF_U - 1) * 2 * _JF_PIX * 16
            + _JF_ROWS * 2 * _JF_A_PIX * 16)
K1_RB = 16  # K1's pass rows: the TPU kernel's row tile (_RB)
# The (n, y) rows of a split-K chunk of K1's tensor-core form: the tensor
# cores' f32 sums truncate, so a chunk's error grows with its depth
K1_CHUNK_ROWS = 128
# Blocks of the tensor-core form past which chunks grow instead of splits
# (bounds the partials at ~180 MB for large T)
_K1_MAX_BLOCKS = 16 * 132
# X8's implicit GEMM (csrc/dgrad_common.cuh): window rows, tile pixels,
# channels of a chunk, epilogue pitch
_V8_WIN, _V8_PIX, _V8_CH = 8, 64, 16
_V8_EPI_PITCH = _V8_PIX + 4
K2_FORMS = ("wgmma", "cuda-core")
_K2_TY, _K2_KM, _K2_PX = 32, 4, 16  # the CUDA-core form's tile (seg_joint.cu)


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


def _bf16_values(x):
    """x rounded to bf16 (nearest even, as the TPU kernels' astype), in
    f32, or in f64 for f64 input (a float64 reference for the checks)."""
    return x.to(torch.bfloat16).to(torch.promote_types(x.dtype,
                                                       torch.float32))


def displacement_joint_dense(x1, x2, half_t):
    """Plain version of K1: the (k, k, T, T) joint as a conv whose filters
    are activations, out[i,j,u,v] = sum_{n,p,q} x1[n,i,u+p-h,v+q-h] *
    x2[n,j,p,q] (``iic_tpu/ops/iid_seg_loss.py::displacement_joint_dense``).
    """
    lhs = _at_least_f32(x1).transpose(0, 1)  # (k, n, h, w)
    rhs = _at_least_f32(x2).transpose(0, 1)
    with full_f32():
        return F.conv2d(lhs, rhs, padding=half_t)


def joint_fwd_bf16_plain(x1, x2, half_t):
    """What K1 computes on the card, as the TPU kernel does: the joint of x1
    and x2 rounded to bf16, exact products, f32 sums (f64 for f64 input,
    the tight check of the kernel)."""
    return displacement_joint_dense(_bf16_values(x1), _bf16_values(x2),
                                    half_t)


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
        lib.seg_joint_fwd.argtypes = [p] * 6 + [i] * 8 + [p]
        lib.seg_joint_fwd.restype = i
        lib.seg_joint_fwd_small.argtypes = [p, p, p, p] + [i] * 7 + [p]
        lib.seg_joint_fwd_small.restype = i
        lib.seg_joint_dgrad.argtypes = [p, p, p] + [i] * 6 + [p]
        lib.seg_joint_dgrad.restype = i
        lib.seg_joint_dgrad_small.argtypes = [p, p, p] + [i] * 5 + [p]
        lib.seg_joint_dgrad_small.restype = i
        lib._typed = True
    return lib


def _split(rows, tiles):
    """(splits, rows_per_chunk) cutting ``rows`` (n, y) rows so that K1's
    CUDA-core form puts about _TARGET_BLOCKS blocks in flight."""
    want = max(1, min(rows, -(-_TARGET_BLOCKS // tiles)))
    per = -(-rows // want)
    return -(-rows // per), per


def channels_last_chunks(x):
    """x (n, k, h, w) channels-last in chunks of 16 channels, bf16 (nearest
    even), zero past k: (n, ceil(k/16), h, w, 16), the layout K1's and X7's
    tensor-core form read both inputs in and K2's and X8's read ``other``
    in. A plain permute and pad."""
    n, k, h, w = x.shape
    c = -(-k // _JF_CH)
    o = F.pad(x.to(torch.bfloat16).permute(0, 2, 3, 1), (0, c * _JF_CH - k))
    return o.reshape(n, h, w, c, _JF_CH).permute(0, 3, 1, 2, 4).contiguous()


def k1_tiles(k, half_t):
    """(N tiles, M tiles) of K1's tensor-core form: per 16-channel chunk,
    N tiles of _JF_U shifts u and M tiles of _JF_V shifts v."""
    t = 2 * half_t + 1
    c = -(-k // _JF_CH)
    return c * -(-t // _JF_U), c * -(-t // _JF_V)


def k1_plan(n, k, h, half_t, rb=K1_RB, chunk_rows=K1_CHUNK_ROWS):
    """(passes_per_chunk, splits) of K1's tensor-core form: the passes of
    ``rb`` rows of one image (n * ceil(h / rb)) cut into chunks of about
    ``chunk_rows`` rows (at least one pass), or of more where the blocks
    would pass _K1_MAX_BLOCKS."""
    passes = n * -(-h // rb)
    tiles = k1_tiles(k, half_t)
    per = max(1, chunk_rows // rb,
              -(-passes // max(1, _K1_MAX_BLOCKS // (tiles[0] * tiles[1]))))
    return per, -(-passes // per)


def k1_smem(form):
    """Shared memory of a K1 block in ``form``: the tensor-core form's two
    slab buffers, each an x2 window and x1 rows (csrc/joint_fwd_common.cuh
    2 * JF_SMEM, whatever k, h or w), the CUDA-core form's two 16 x 68 f32
    tiles."""
    return 2 * _JF_SMEM if form == "wgmma" else 2 * 16 * (_TILE + 4) * 4


def k1_form(k, half_t):
    """K1's form on the card: the CUDA-core kernel at k <= 4, where the
    tensor-core form pads the channels to 16 and issues 5.3x the work (at
    k = 3); else the stack product on the tensor cores (``"wgmma"``).
    ``half_t`` changes neither form's shared memory."""
    return "cuda-core" if k <= 4 else "wgmma"


def check_k1_smem(form):
    """Refuses a K1 form whose block needs more shared memory than a block
    can use."""
    need = k1_smem(form)
    if need > _SMEM_BLOCK:
        raise ValueError(f"joint_fwd ({form}): a block needs {need} bytes "
                         f"of shared memory, over the {_SMEM_BLOCK} a block "
                         f"can use")


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def launch_joint_fwd_mma(entry, x1, x2, half_t, rb, chunk_rows):
    """Runs K1's tensor-core form (``entry``: K1's C entry point on f32
    inputs, or X7's or X3's on bf16) on x1, x2 (n, k, h, w): the kernel's
    layout pass into ``channels_last_chunks``'s layout, the stack product
    over chunks of about ``chunk_rows`` rows in passes of ``rb`` rows
    (``k1_plan``) and the ordered reduce. Returns the (k, k, T, T) joint,
    or raises with the CUDA error (a negative code: minus the CUresult of
    a refused tensor map)."""
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    tk = k * t
    per, splits = k1_plan(n, k, h, half_t, rb, chunk_rows)
    xc = torch.empty((2, n, -(-k // _JF_CH), h, w, _JF_CH), device=x1.device,
                     dtype=torch.bfloat16)
    part = torch.empty((splits, tk, tk), device=x1.device)
    out = torch.empty((k, k, t, t), device=x1.device)
    err = entry(x1.data_ptr(), x2.data_ptr(), xc[0].data_ptr(),
                xc[1].data_ptr(), part.data_ptr(), out.data_ptr(), n, k, h, w,
                half_t, rb, per, splits, _stream(x1.device))
    if err < 0:
        raise RuntimeError(f"joint forward (wgmma): tensor map refused, "
                           f"CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"joint forward (wgmma) launch failed: CUDA error "
                           f"{err}")
    return out


def joint_fwd(x1, x2, half_t, form=None):
    """K1: the (k, k, T, T) displacement joint of x1, x2 (n, k, h, w). On
    the card both inputs are rounded to bf16 and the sums run in f32, as in
    the TPU kernel (``joint_fwd_bf16_plain``); ``form`` (one of
    ``K1_FORMS``) overrides ``k1_form``'s choice."""
    if form is not None and form not in K1_FORMS:
        raise ValueError(f"form {form!r}: expected one of {K1_FORMS}")
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return displacement_joint_dense(x1, x2, half_t)
    if x1.device.type != "cuda" or x2.device != x1.device:
        raise ValueError(f"joint_fwd: inputs on {x1.device} and {x2.device}")
    _check("x1", x1)
    _check("x2", x2, x1.shape)
    n, k, h, w = x1.shape
    form = form or k1_form(k, half_t)
    check_k1_smem(form)
    if form == "wgmma":
        out = launch_joint_fwd_mma(_lib().seg_joint_fwd, x1, x2, half_t,
                                   K1_RB, K1_CHUNK_ROWS)
    else:
        t = 2 * half_t + 1
        tk = k * t
        splits, per = _split(n * h, (-(-tk // _TILE)) ** 2)
        a, b = x1.to(torch.bfloat16), x2.to(torch.bfloat16)
        part = torch.empty((splits, tk, tk), device=x1.device)
        out = torch.empty((k, k, t, t), device=x1.device)
        err = _lib().seg_joint_fwd_small(
            a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), n,
            k, h, w, half_t, splits, per, _stream(x1.device))
        if err != 0:
            raise RuntimeError(f"seg_joint_fwd launch failed: CUDA error "
                               f"{err}")
    LAUNCHES["seg_joint_fwd"] += 1
    return out


def _v8_cols(k):
    """X8's N: output channels a block owns, k padded to 8 or 16."""
    return 8 if k <= 8 else 16


def _v8_smem(n_cols, half_t, slab, patches=1):
    """Dynamic shared memory of X8's implicit GEMM (csrc/dgrad_common.cuh
    v8_smem; csrc/joint_exp_bwd.cu v9_smem for X9's ``patches``): the
    channels-last patch of 32-byte pixels, whole ((8 + 2h) rows x (64 + 2h)
    pixels, ``patches`` of them side by side) at slab 0, else one slab of
    ``slab`` rows x 64 pixels, whose memory the (8, N, 68) f32 epilogue tile
    reuses, and two adjoint chunks of T tiles of 16 x N bf16."""
    pixels = (slab * _V8_PIX if slab else
              patches * (_V8_WIN + 2 * half_t) * (_V8_PIX + 2 * half_t))
    epi = _V8_WIN * n_cols * _V8_EPI_PITCH * 4
    region = -(-max(pixels * 2 * _V8_CH, epi) // 128) * 128
    return region + 2 * (2 * half_t + 1) * n_cols * 2 * _V8_CH


def slab_plan(n_cols, half_t, patches=1):
    """0 when the whole patches fit a block's shared memory, else the most
    patch rows a slab can hold (a block then stages, for each v, only the 64
    columns that v reads)."""
    if _v8_smem(n_cols, half_t, 0, patches) <= _SMEM_BLOCK:
        return 0
    slab = _V8_WIN + 2 * half_t
    while slab > 1 and _v8_smem(n_cols, half_t, slab) > _SMEM_BLOCK:
        slab -= 1
    return slab


def dgrad_v8_slab(k, half_t):
    """X8's (and K2's) patch plan: 0 when the whole patch fits a block's
    shared memory (h <= 22 at k > 8, h <= 24 at k <= 8), else the most patch
    rows a slab can hold, in which a block stages, for each v, only the 64
    columns that v reads."""
    return slab_plan(_v8_cols(k), half_t)


def dgrad_v8_smem(k, half_t):
    """X8's (and K2's) dynamic shared memory under its patch plan
    (``dgrad_v8_slab``). It does not depend on rb."""
    return _v8_smem(_v8_cols(k), half_t, dgrad_v8_slab(k, half_t))


def dgrad_v8_operands(g2d, other, half_t, n_cols=None):
    """The operands of X8's implicit GEMM in the layouts its kernel reads
    (csrc/dgrad_common.cuh), both bf16 (nearest even) and zero past k:
    ``gc``, the adjoint as (i chunk, j chunk, v, u) tiles B(u, v)[j, i] =
    G[(v, i), (u, j)] of 16 x N, N = ``n_cols`` (by default 8 for k <= 8
    and 16 above; X9 takes 16 at every k), each in wgmma's K-major layout
    without swizzle (core matrix (i/8, j/8) at ((j/8) * N/8 + i/8) * 128
    bytes); and ``oc``, ``other`` channels-last in chunks of 16 channels,
    (n, ceil(k/16), h, w, 16). A plain permute and pad, as the TPU tool's
    ``jnp.pad``."""
    n, k, h, w = other.shape
    t = 2 * half_t + 1
    n_cols = n_cols or _v8_cols(k)
    ic, jc = -(-k // n_cols), -(-k // _V8_CH)
    g = F.pad(g2d.to(torch.bfloat16).reshape(t, k, t, k),  # [v, i, u, j]
              (0, jc * _V8_CH - k, 0, 0, 0, ic * n_cols - k))
    gc = (g.reshape(t, ic, n_cols // 8, 8, t, jc, 2, 8)
          .permute(1, 5, 0, 4, 6, 2, 3, 7).contiguous())
    return gc, channels_last_chunks(other)


def _k2_small_smem(half_t):
    """Shared memory of K2's CUDA-core form: the f32 adjoint chunk (T, T,
    KM) and the f32 patch (32 + 2h) x (8 PX + 2h)."""
    t = 2 * half_t + 1
    return 4 * (t * t * _K2_KM
                + (_K2_TY + 2 * half_t) * (8 * _K2_PX + 2 * half_t))


def k2_form(k, half_t):
    """K2's form on the card: the CUDA-core kernel at k <= 4, where the
    tensor-core form pads j to 16 channels and N to 8 and issues 5.3x the
    work (at k = 3), as long as its adjoint fits a block; else X8's
    implicit GEMM on the tensor cores (``"wgmma"``)."""
    if k <= 4 and _k2_small_smem(half_t) <= _SMEM_BLOCK:
        return "cuda-core"
    return "wgmma"


def joint_dgrad(g2d, other, half_t, form=None):
    """K2: the gradient for the column-shifted operand, in the unpadded
    (n, k, h, w) frame (see ``dgrad_plain`` for the contract). On the card
    the adjoint and ``other`` are rounded to bf16 and the sums run in f32,
    as in the TPU kernel; ``form`` (one of ``K2_FORMS``) overrides
    ``k2_form``'s choice."""
    if form is not None and form not in K2_FORMS:
        raise ValueError(f"form {form!r}: expected one of {K2_FORMS}")
    if g2d.device.type == "cpu" and other.device.type == "cpu":
        return dgrad_plain(g2d, other, half_t)
    if other.device.type != "cuda" or g2d.device != other.device:
        raise ValueError(f"joint_dgrad: inputs on {g2d.device} and "
                         f"{other.device}")
    n, k, h, w = other.shape
    tk = k * (2 * half_t + 1)
    _check("other", other)
    _check("g2d", g2d, (tk, tk))
    form = form or k2_form(k, half_t)
    need = (dgrad_v8_smem(k, half_t) if form == "wgmma"
            else _k2_small_smem(half_t))
    if need > _SMEM_BLOCK:
        raise ValueError(f"joint_dgrad ({form}) k={k} half_t={half_t}: a "
                         f"block needs {need} bytes of shared memory, over "
                         f"the {_SMEM_BLOCK} a block can use")
    dx = torch.empty_like(other)
    stream = _stream(other.device)
    if form == "wgmma":
        gc, oc = dgrad_v8_operands(g2d, other, half_t)
        err = _lib().seg_joint_dgrad(gc.data_ptr(), oc.data_ptr(),
                                     dx.data_ptr(), n, k, h, w, half_t,
                                     dgrad_v8_slab(k, half_t), stream)
    else:
        gb = g2d.to(torch.bfloat16)
        ob = other.to(torch.bfloat16)
        err = _lib().seg_joint_dgrad_small(gb.data_ptr(), ob.data_ptr(),
                                           dx.data_ptr(), n, k, h, w,
                                           half_t, stream)
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
