"""Kernels of the displacement-joint experiment tool, with their plain
PyTorch versions: the forward probes X2 (joint forward with bf16 operands,
and its ablations), X1 (the stack-product probe), X7 (the joint forward
with bf16 operands on K1's kernels) and X3-X6 (the same joint, with the next
stage fetched while the current one is multiplied), and the backward probes
X8 (input gradient with bf16 operands) and X9 (both input gradients in one
launch, each per-displacement partial rounded to bf16).

Replaces the nine kernels of ``tools/joint_kernel_exp.py``: X2 replaces
``_joint_kernel_v2`` (launched by ``joint_fwd_v2``), X1 ``_mm_probe_kernel``
(``mm_probe``), X7 ``_joint_kernel_v8`` (``joint_fwd_v8``), X3-X6
``_joint_kernel_v3`` / ``_v4`` / ``_v5`` / ``_v6`` (``joint_fwd_v3`` ...
``joint_fwd_v6``), X8 ``_dgrad_kernel_v8`` (``dgrad_v8``, called twice by
``bwd_v8``) and X9 ``_dgrad_kernel_v7`` (``dgrad_fused_v7``). The kernels'
sources, with the note on what bounds them on the H100, how their design
answers it and the exact definition of each mode, are
``iic_tpu_torch/csrc/joint_exp.cu`` (X1, X2, X7; X2 and X7's
tensor-core form are K1's stack product in ``csrc/joint_fwd_common.cuh``,
X2's modes instantiations of its kernel but copies-only, which walks and
stages its slabs),
``iic_tpu_torch/csrc/joint_exp_tma.cu`` (the tensor-core forms of X3-X6:
K1's stack product fed by TMA through a two-slot mbarrier ring, X3's slot
and phase the slab's parity, X4's slot picked by a branch on it, X5's and
X6's two slabs an iteration from static slots),
``iic_tpu_torch/csrc/joint_exp_pipe.cu`` (the CUDA-core forms of X3-X6)
and
``iic_tpu_torch/csrc/joint_exp_bwd.cu`` (X8, X9; X8's kernel is the
implicit GEMM of ``csrc/dgrad_common.cuh``, which K2 shares, and whose
operand layout and shared-memory plan ``seg_joint`` holds).

Where the TPU tool leaves an output undefined, the port defines it: the TPU
``mm-only`` and ``mm_probe`` multiply uninitialised scratch, ``copies-only``
adds one row of each stack into the accumulator and ``aligned-copies``
builds at the TPU's tile-aligned offsets. Here ``mm-only`` and ``mm_probe``
multiply tiles of bf16 ones, so every output entry is the count of
contraction terms the kernel issued (a pass skipped or misindexed shows);
``copies-only`` gives an order-free checksum of the staged bf16 bits and
``aligned-copies`` the zero-displacement joint broadcast over (u, v).

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; it never falls back.
"""

import ctypes

import torch
import torch.nn.functional as F

from iic_tpu_torch.ops.kernels import _build
from iic_tpu_torch.ops.kernels import seg_joint as sj
from iic_tpu_torch.ops.kernels.seg_joint import (
    _SMEM_BLOCK, _V8_CH, _bf16_values, _stream, _v8_smem,
    dgrad_v8_operands, dgrad_v8_slab, dgrad_v8_smem)

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"joint_fwd_v2": 0, "mm_probe": 0, "joint_fwd_v8": 0,
            "joint_fwd_v3": 0, "joint_fwd_v4": 0, "joint_fwd_v5": 0,
            "joint_fwd_v6": 0, "dgrad_v8": 0, "dgrad_fused_v7": 0}

MODES = ("full", "rank3", "mm-only", "copies-only", "aligned-copies")
FORMS = ("mk-nk", "mk-kn")
# The forms of X3-X6: K1's stack product on the tensor cores, fed
# by TMA, or their first kernels on the CUDA cores; by default K1's
# (seg_joint.k1_form: the CUDA-core pipelines at k <= 4)
X_FORMS = sj.K1_FORMS
# csrc/joint_exp.cu joint_exp_fwd_v2's modes; "rank3" is the "full" launch
# on this card
_MODE_IDS = {"full": 0, "rank3": 0, "mm-only": 1, "copies-only": 2,
             "aligned-copies": 3}
_WL = 128        # the TPU tool's lane width: X1's row tiles are rb x 128
_TILE = 64       # the CUDA-core kernels' output tile edge (joint_common.cuh)
_BQ = 8          # image columns per X1 pass (csrc/joint_exp.cu BQ)
_PROBE_M, _PROBE_N = 64, 160  # X1's output tile (csrc/joint_exp.cu PROBE_*)
_PROBE_GUARD = 1024           # zeroed bytes after each X1 tile
_V7_RB = 16    # X9's tile rows (the TPU tool's _RB)
_V6_RB = 16    # X6's rows of a pass (the TPU tool's _RB)
_V9_COLS = 16  # X9's N at every k (csrc/joint_exp_bwd.cu V9_COLS)
_TARGET_BLOCKS = 8 * 132  # blocks to put in flight: eight per SM
# The tensor-core forms of X3-X6 (csrc/joint_exp_tma.cu): the TMA
# boxes (channels, pixels, rows, images x chunks) of an x1 channel half
# (the slab's rows) and of an x2 one (its window), and a slot's byte
# offsets: the halves' windows [half][row][pixel][8], then the halves' x1
# rows, 68 pixels each
X3_BOX_A = (8, sj._JF_A_PIX, sj._JF_ROWS, 1)
X3_BOX_B = (8, sj._JF_PIX, sj._JF_ROWS + sj._JF_U - 1, 1)
_XT_WIN = X3_BOX_B[1] * X3_BOX_B[2] * 16
_XT_A_ROW = X3_BOX_A[1] * 16
_XT_A_OFF = 2 * _XT_WIN
_XT_A_HALF = X3_BOX_A[2] * _XT_A_ROW


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def probe_smem(rb):
    """X1's dynamic shared memory (csrc/joint_exp.cu probe_smem): the
    (64, 8*rb) A and (160, 8*rb) B tiles of bf16 ones, each followed by a
    zeroed guard."""
    return 2 * (_PROBE_M + _PROBE_N) * _BQ * rb + 2 * _PROBE_GUARD


def _check_shift(half_t, rb):
    """The TPU tool's asserts: 2*half_t <= 128 and 2*half_t <= 2*rb."""
    if rb < 1 or not (2 * half_t <= _WL and 2 * half_t <= 2 * rb):
        raise ValueError(f"half_t={half_t}, rb={rb}: need rb >= 1, "
                         f"2*half_t <= {_WL} and 2*half_t <= 2*rb")


def _check_lanes(half_t):
    """The TPU tool's assert where rb is fixed: 2*half_t <= 128."""
    if not 0 <= 2 * half_t <= _WL:
        raise ValueError(f"half_t={half_t}: need 2*half_t <= {_WL}")


def _check_smem(name, need, limit=_SMEM_BLOCK):
    if need > limit:
        raise ValueError(f"{name}: a block needs {need} bytes of shared "
                         f"memory, over the {limit} a block can use")


def _check_form(form):
    if form not in X_FORMS:
        raise ValueError(f"form {form!r}: expected one of {X_FORMS}")


def check_args(half_t, rb):
    """X2's limits: the TPU tool's asserts (2*half_t <= 128 and 2*half_t <=
    2*rb). The card adds none: K1's stack product stages slabs of 16 rows
    whatever rb (``seg_joint.k1_smem``)."""
    _check_shift(half_t, rb)


def check_probe(half_t, rb, form):
    """X1's limits: the TPU tool's asserts, rb even (a pass of depth 8*rb is
    rb/2 whole k16 steps) and its two tiles in a block's shared memory."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    _check_shift(half_t, rb)
    if rb % 2:
        raise ValueError(f"rb={rb}: X1 needs an even rb (a pass is rb/2 "
                         f"k16 steps)")
    _check_smem(f"mm_probe rb={rb}", probe_smem(rb))


def check_dgrad_v8(k, half_t, rb):
    """X8's limits: the TPU tool's asserts and the block's shared memory,
    which its patch plan keeps under the limit for every h they admit. Any
    rb >= 1 tiles the rows: a block walks its rb rows in windows of 8."""
    _check_shift(half_t, rb)
    _check_smem(f"dgrad_v8 k={k} half_t={half_t}", dgrad_v8_smem(k, half_t))


def fused_v7_slab(k, half_t):
    """X9's patch plan: 0 when the whole patches of all ceil(k/16) j chunks
    fit a block's shared memory beside the adjoint chunks (k <= 32 at
    h = 10), else the most patch rows a slab can hold, in which a block
    stages, for each (v, j chunk), only the 64 columns that v reads."""
    return sj.slab_plan(_V9_COLS, half_t, -(-k // _V8_CH))


def fused_v7_smem(k, half_t):
    """X9's dynamic shared memory under its patch plan (``fused_v7_slab``):
    X8's layout with one whole patch per j chunk, or X8's slab."""
    return _v8_smem(_V9_COLS, half_t, fused_v7_slab(k, half_t),
                    -(-k // _V8_CH))


def check_fused_v7(k, half_t):
    """X9's limits: the TPU tool's assert (2*half_t <= 128; its rb is fixed
    at 16) and the block's shared memory, which its patch plan keeps under
    the limit for every k and every h the assert admits."""
    _check_lanes(half_t)
    _check_smem(f"dgrad_fused_v7 k={k} half_t={half_t}",
                fused_v7_smem(k, half_t))


def row_window(h, half_t, rb):
    """(t_lo, t_hi): the rb-row tiles the TPU kernels walk over."""
    return half_t // rb, -(-(half_t + h) // rb)


def _split(units, tiles, quantum=1):
    """(splits, per): ``units`` cut into chunks of ``per`` (a multiple of
    ``quantum``) so that about _TARGET_BLOCKS blocks are in flight."""
    want = max(1, min(-(-units // quantum), -(-_TARGET_BLOCKS // tiles)))
    per = -(-(-(-units // want)) // quantum) * quantum
    return -(-units // per), per


# ------------------------------------------------------------ plain versions

def _bits(x):
    """The bf16 bit patterns of x as non-negative int64."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def copies_checksum(x1, x2, half_t):
    """Plain version of X2 ``copies-only``: P[i,j,u,v] = float((S_A[v,i] +
    S_B[u,j]) mod 2^32) with S_A[v,i] = sum_{n,y,q} bits(x1[n,i,y,q+v-h]) and
    S_B[u,j] = sum_{n,y,q} bits(x2[n,j,y+h-u,q]), zero outside the frame."""
    _, _, h, w = x1.shape
    t = 2 * half_t + 1
    d = torch.arange(t, device=x1.device) - half_t  # v - h, and h - u reversed

    def window_sums(per_line, size, shift):
        # sums of per_line[c, s] over s in [shift, size + shift) ∩ [0, size)
        cum = torch.nn.functional.pad(per_line.cumsum(1), (1, 0))
        lo = shift.clamp(0, size)
        hi = (shift + size).clamp(0, size)
        return cum[:, hi] - cum[:, lo]  # (k, t)

    s_a = window_sums(_bits(x1).sum(dim=(0, 2)), w, d)            # [i, v]
    s_b = window_sums(_bits(x2).sum(dim=(0, 3)), h, d.flip(0))    # [j, u]
    total = s_a[:, None, None, :] + s_b[None, :, :, None]  # [i, j, u, v]
    return (total % 2 ** 32).to(torch.float64).to(torch.float32)


def mm_only_terms(n, h, w):
    """The contraction terms X2 ``mm-only`` issues per output entry: K1's
    slab walk, rows x 16-pixel k16 steps x 16 summed over the slabs. The
    passes of rb rows of one image cover each row once and a row's column
    slabs its ceil(w/16) steps, so n * h * ceil(w/16) * 16 whatever rb."""
    return n * h * -(-w // 16) * 16


def joint_fwd_v2_plain(x1, x2, half_t, mode="full", rb=16):
    """Plain version of X2: the (k, k, T, T) joint of x1, x2 rounded to
    bf16, accumulated in f32 (f64 for f64 input), for ``mode`` (see the
    module docstring). ``mm-only``'s entries are ``mm_only_terms``, exact
    in f32 up to 2^24; no mode depends on ``rb``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    if mode == "copies-only":
        return copies_checksum(x1, x2, half_t)
    if mode == "mm-only":
        return torch.full((k, k, t, t), float(mm_only_terms(n, h, w)),
                          device=x1.device)
    if mode == "aligned-copies":
        p0 = sj.joint_fwd_bf16_plain(x1, x2, 0)
        return p0.expand(k, k, t, t).contiguous()
    return sj.joint_fwd_bf16_plain(x1, x2, half_t)


def joint_fwd_v8_plain(x1, x2, half_t, rb=16):
    """Plain version of X7: K1's function on the card
    (``seg_joint.joint_fwd_bf16_plain``), the joint of x1, x2 rounded to
    bf16 with f32 accumulation; ``rb`` changes only the kernel's summation
    order."""
    return sj.joint_fwd_bf16_plain(x1, x2, half_t)


def joint_fwd_v3_plain(x1, x2, half_t, rb=16, flat=True):
    """Plain version of X3: X2 ``full``'s plain version. X3 multiplies the
    same bf16 operands into the same f32 joint in either form; ``rb`` and
    ``flat`` change only the kernel's summation order and the TPU's stack
    layout."""
    return joint_fwd_v2_plain(x1, x2, half_t, "full", rb)


def joint_fwd_v4_plain(x1, x2, half_t, rb=16):
    """Plain version of X4: X2 ``full``'s plain version (X4 only picks its
    slot by a branch, and on the CUDA cores stages each stage's product in
    a second accumulator before adding it)."""
    return joint_fwd_v2_plain(x1, x2, half_t, "full", rb)


def joint_fwd_v5_plain(x1, x2, half_t, rb=16):
    """Plain version of X5: X2 ``full``'s plain version (X5's priming and
    padding products add zeros)."""
    return joint_fwd_v2_plain(x1, x2, half_t, "full", rb)


def joint_fwd_v6_plain(x1, x2, half_t, roll_build=False):
    """Plain version of X6: X2 ``full``'s plain version. X6 rounds its f32
    inputs to bf16 itself, nearest even as X2's wrapper does, and
    ``roll_build`` builds the same stack values another way."""
    return joint_fwd_v2_plain(x1, x2, half_t, "full")


def dgrad_v8_plain(g2d, other, half_t):
    """Plain version of X8: K2's plain version on the bf16-rounded adjoint
    and input, dx[n,i,y,x] = sum_{j,u,v} G[(v,i),(u,j)] *
    other[n,j,y-u+h,x-v+h] in f32 (f64 for f64 ``other``)."""
    o = _bf16_values(other)
    return sj.dgrad_plain(_bf16_values(g2d).to(o.dtype), o, half_t)


def _dgrad_rounded_partials(g2d, other, half_t):
    """sum_v bf16(p_v), p_v[n,i,y,x] = sum_{u,j} G[(v,i),(u,j)] *
    other[n,j,y-u+h,x-v+h] with G and ``other`` rounded to bf16, summed in
    v order. p_v is one conv with column 2h - v of the flipped adjoint,
    padded by (h, 0), shifted in x by h - v. With f64 input the partials
    are f64 and are rounded to bf16 too."""
    o = _bf16_values(other)
    w = o.shape[3]
    k = o.shape[1]
    t = 2 * half_t + 1
    gf = (_bf16_values(g2d).to(o.dtype).reshape(t, k, t, k)
          .permute(1, 3, 2, 0).flip(2, 3))  # [i, j, 2h-u, 2h-v]
    dx = torch.zeros_like(o)
    with sj.full_f32():
        for v in range(t):
            col = gf[:, :, :, 2 * half_t - v:2 * half_t - v + 1].contiguous()
            c = F.conv2d(o, col, padding=(half_t, 0))
            d = half_t - v  # p_v[..., x] = c[..., x + d], zero outside
            p = torch.zeros_like(c)
            lo, hi = max(0, -d), min(w, w - d)
            if lo < hi:
                p[..., lo:hi] = c[..., lo + d:hi + d]
            dx += _bf16_values(p)
    return dx


def dgrad_fused_v7_plain(g, x1, x2, half_t):
    """Plain version of X9: (dx1, dx2) for the joint cotangent g (k,k,T,T),
    each the sum over v of its bf16-rounded per-displacement partials (see
    ``_dgrad_rounded_partials``), dx1 on x2 and the adjoint, dx2 on x1 and
    the swapped adjoint (``seg_joint.adjoints``)."""
    g2d, g2d_swap = sj.adjoints(g)
    return (_dgrad_rounded_partials(g2d, x2, half_t),
            _dgrad_rounded_partials(g2d_swap, x1, half_t))


def mm_probe_plain(n, k, h, half_t, rb, device):
    """Plain version of X1: its (kT, kT) product of tiles of ones, every
    entry the count of terms issued, n * (t_hi - t_lo) * rb * 128 (exact in
    f32 up to 2^24)."""
    tk = k * (2 * half_t + 1)
    terms = probe_passes(n, h, half_t, rb) * _BQ * rb
    return torch.full((tk, tk), float(terms), device=device)


# ------------------------------------------------------------------ wrappers

def _lib():
    lib = _build.library("joint_exp")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.joint_exp_fwd_v2.argtypes = [p] * 7 + [i] * 9 + [p]
        lib.joint_exp_fwd_v2.restype = i
        lib.joint_exp_mm_probe.argtypes = [p, p] + [i] * 6 + [p]
        lib.joint_exp_mm_probe.restype = i
        lib.joint_exp_mm_probe_slots.argtypes = [i, i]
        lib.joint_exp_mm_probe_slots.restype = i
        lib.joint_exp_fwd_v8.argtypes = [p, p, p, p] + [i] * 7 + [p]
        lib.joint_exp_fwd_v8.restype = i
        lib.joint_exp_fwd_v8_mma.argtypes = [p] * 6 + [i] * 8 + [p]
        lib.joint_exp_fwd_v8_mma.restype = i
        lib._typed = True
    return lib


def _tma_lib():
    lib = _build.library("joint_exp_tma")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for v in ("v3", "v4", "v5"):
            fn = getattr(lib, f"joint_exp_fwd_{v}_tma")
            fn.argtypes = [p] * 6 + [i] * 8 + [p]
            fn.restype = i
        lib.joint_exp_fwd_v6_tma.argtypes = [p] * 6 + [i] * 9 + [p]
        lib.joint_exp_fwd_v6_tma.restype = i
        lib._typed = True
    return lib


def _pipe_lib():
    lib = _build.library("joint_exp_pipe")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for v in ("v3", "v4", "v5"):
            fn = getattr(lib, f"joint_exp_fwd_{v}")
            fn.argtypes = [p, p, p, p] + [i] * 7 + [p]
            fn.restype = i
        lib.joint_exp_fwd_v6.argtypes = [p, p, p, p] + [i] * 8 + [p]
        lib.joint_exp_fwd_v6.restype = i
        lib._typed = True
    return lib


def _bwd_lib():
    lib = _build.library("joint_exp_bwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.joint_exp_dgrad_v8.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.joint_exp_dgrad_v8.restype = i
        lib.joint_exp_dgrad_fused_v7.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.joint_exp_dgrad_fused_v7.restype = i
        lib._typed = True
    return lib


def _on_cuda(name, *xs):
    """False for tensors all on the CPU (the plain version's case), True
    for tensors all on one CUDA device; raises for anything else."""
    if all(x.device.type == "cpu" for x in xs):
        return False
    if xs[0].device.type != "cuda" or any(x.device != xs[0].device
                                          for x in xs):
        raise ValueError(f"{name}: inputs on "
                         f"{', '.join(str(x.device) for x in xs)}")
    return True


def _as_input(name, x, shape=None, to=torch.bfloat16):
    """x checked for the kernel and converted to ``to``."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
    if x.dim() != 4 or (shape is not None and tuple(x.shape) != shape):
        raise ValueError(f"{name}: expected shape {shape or '(n, k, h, w)'}, "
                         f"got {tuple(x.shape)}")
    return x.to(to)


def joint_fwd_v2(x1, x2, half_t, mode="full", rb=16):
    """X2: the (k, k, T, T) displacement joint of x1, x2 (n, k, h, w) with
    both inputs rounded to bf16 and f32 accumulation, or one of its
    ablations (``mode``), on K1's stack product: ``rb`` is the rows of a
    pass, as in X7's, and full and rank3 are X7's tensor-core launch."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    check_args(half_t, rb)
    if not _on_cuda("joint_fwd_v2", x1, x2):
        return joint_fwd_v2_plain(x1, x2, half_t, mode, rb)
    a = _as_input("x1", x1)
    b = _as_input("x2", x2, tuple(x1.shape))
    tk = x1.shape[1] * (2 * half_t + 1)
    chk = torch.empty((2 * tk,), device=x1.device, dtype=torch.int32)

    # X7's launch (plan, scratch, reduce) with the mode and the copies-only
    # checksum words added
    def entry(x1p, x2p, x1c, x2c, part, out, *dims_plan):
        *dims, per, splits, stream = dims_plan
        return _lib().joint_exp_fwd_v2(x1p, x2p, x1c, x2c, part,
                                       chk.data_ptr(), out, *dims,
                                       _MODE_IDS[mode], per, splits, stream)
    out = sj.launch_joint_fwd_mma(entry, a, b, half_t, rb, sj.K1_CHUNK_ROWS)
    LAUNCHES["joint_fwd_v2"] += 1
    return out


def _adjoint_bf16(name, g2d, tk):
    if g2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{g2d.dtype}")
    if tuple(g2d.shape) != (tk, tk):
        raise ValueError(f"{name}: expected shape {(tk, tk)}, got "
                         f"{tuple(g2d.shape)}")
    return g2d.to(torch.bfloat16).contiguous()


def _split_k_fwd(name, entry, x1, x2, half_t, rb, *flags,
                 to=torch.bfloat16):
    """Launches a split-K joint kernel (X7, X3-X6) on x1, x2 converted to
    ``to``: the n*h rows cut into chunks of a multiple of ``rb`` rows, the
    partials, their ordered reduce into (k, k, T, T)."""
    a = _as_input("x1", x1, to=to)
    b = _as_input("x2", x2, tuple(x1.shape), to=to)
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    tk = k * t
    splits, per = _split(n * h, (-(-tk // _TILE)) ** 2, rb)
    part = torch.empty((splits, tk, tk), device=x1.device)
    out = torch.empty((k, k, t, t), device=x1.device)
    err = entry(a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(),
                n, k, h, w, half_t, *flags, splits, per, _stream(x1.device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _tma_fwd(name, entry, x1, x2, half_t, rb, to=torch.bfloat16):
    """Launches a TMA-fed tensor-core form (X3-X6; csrc/joint_exp_tma.cu)
    on x1, x2 converted to ``to``: K1's layout pass, the stack product over
    X7's plan in passes of ``rb`` rows, the ordered reduce
    (``seg_joint.launch_joint_fwd_mma``)."""
    a = _as_input("x1", x1, to=to)
    b = _as_input("x2", x2, tuple(x1.shape), to=to)
    out = sj.launch_joint_fwd_mma(entry, a, b, half_t, rb, sj.K1_CHUNK_ROWS)
    LAUNCHES[name] += 1
    return out


def joint_fwd_v8(x1, x2, half_t, rb=16, form=None):
    """X7: the (k, k, T, T) displacement joint of x1, x2 (n, k, h, w) with
    both inputs rounded to bf16 and f32 accumulation, on K1's kernels, in
    the form ``form`` (one of ``seg_joint.K1_FORMS``; by default K1's
    choice, ``seg_joint.k1_form``). In the tensor-core form ``rb`` is the
    (n, y) rows of one image a block stages per pass, as on the TPU; a pass
    of more than 16 rows does not fit a block beside its x2 window, so the
    kernel stages it in slabs of 16 rows x 64 pixels, and a split-K chunk
    is whole passes (about ``seg_joint.K1_CHUNK_ROWS`` rows), so at h a
    multiple of rb, rb 16, 32 and 64 give K1's bits. In the CUDA-core form
    ``rb`` is the (n, y) row quantum of a split-K chunk."""
    if form is not None and form not in sj.K1_FORMS:
        raise ValueError(f"form {form!r}: expected one of {sj.K1_FORMS}")
    _check_shift(half_t, rb)
    if not _on_cuda("joint_fwd_v8", x1, x2):
        return joint_fwd_v8_plain(x1, x2, half_t, rb)
    if (form or sj.k1_form(x1.shape[1], half_t)) == "cuda-core":
        return _split_k_fwd("joint_fwd_v8", _lib().joint_exp_fwd_v8, x1, x2,
                            half_t, rb)
    a = _as_input("x1", x1)
    b = _as_input("x2", x2, tuple(x1.shape))
    out = sj.launch_joint_fwd_mma(_lib().joint_exp_fwd_v8_mma, a, b, half_t,
                                  rb, sj.K1_CHUNK_ROWS)
    LAUNCHES["joint_fwd_v8"] += 1
    return out


def joint_fwd_v3(x1, x2, half_t, rb=16, flat=True, form=None):
    """X3: X7's joint with the next stage fetched into the other slot of a
    shared-memory double buffer, indexed by parity, while the current one
    is multiplied, in the form ``form`` (one of ``X_FORMS``; by default
    ``seg_joint.k1_form``'s). ``flat`` names the TPU's stack layout, one
    launch here.
    Tensor cores (csrc/joint_exp_tma.cu): K1's stack product over X7's plan
    (``rb`` the rows of a pass), each slab brought by TMA into a slot whose
    mbarrier phase is the slab's parity; it equals X7's tensor-core form
    bit for bit. CUDA cores (csrc/joint_exp_pipe.cu): ``rb`` is the row
    quantum of a chunk, and it equals X7's CUDA-core form bit for bit."""
    form = form or sj.k1_form(x1.shape[1], half_t)
    _check_form(form)
    _check_shift(half_t, rb)
    if not _on_cuda("joint_fwd_v3", x1, x2):
        return joint_fwd_v3_plain(x1, x2, half_t, rb, flat)
    if form == "cuda-core":
        return _split_k_fwd("joint_fwd_v3", _pipe_lib().joint_exp_fwd_v3, x1,
                            x2, half_t, rb)
    return _tma_fwd("joint_fwd_v3", _tma_lib().joint_exp_fwd_v3_tma, x1, x2,
                    half_t, rb)


def joint_fwd_v4(x1, x2, half_t, rb=16, form=None):
    """X4: X3 with two separately declared slots chosen by a branch on the
    parity, in the form ``form`` (one of ``X_FORMS``; by default
    ``seg_joint.k1_form``'s).
    Tensor cores (csrc/joint_exp_tma.cu): X3's walk over X7's plan (``rb``
    the rows of a pass), the slot picked by a block-uniform branch on the
    slab's parity, each slab brought by TMA; the TPU's staging of each
    stage's product in a second accumulator is not kept (the TMA fills a
    slot before it is read), so it equals X3's and X7's tensor-core forms
    bit for bit. CUDA cores (csrc/joint_exp_pipe.cu): each stage's product
    staged in a second accumulator and added; ``rb`` is the row quantum of
    a chunk."""
    form = form or sj.k1_form(x1.shape[1], half_t)
    _check_form(form)
    _check_shift(half_t, rb)
    if not _on_cuda("joint_fwd_v4", x1, x2):
        return joint_fwd_v4_plain(x1, x2, half_t, rb)
    if form == "cuda-core":
        return _split_k_fwd("joint_fwd_v4", _pipe_lib().joint_exp_fwd_v4, x1,
                            x2, half_t, rb)
    return _tma_fwd("joint_fwd_v4", _tma_lib().joint_exp_fwd_v4_tma, x1, x2,
                    half_t, rb)


def joint_fwd_v5(x1, x2, half_t, rb=16, form=None):
    """X5: X3's joint with two stages an iteration in straight-line code
    from two static slots and an even stage count, in the form ``form``
    (one of ``X_FORMS``; by default ``seg_joint.k1_form``'s).
    Tensor cores (csrc/joint_exp_tma.cu): K1's stack product over X7's plan
    (``rb`` the rows of a pass), the even slab of an iteration from slot 0
    and the odd one from slot 1, both brought by TMA; the absent odd slab
    of an odd count is skipped. It equals X7's tensor-core form bit for
    bit. CUDA cores (csrc/joint_exp_pipe.cu): an odd stage count padded
    with an all-zero stage and a zeroed odd slot priming the pipeline;
    ``rb`` is the row quantum of a chunk, and it equals X7's CUDA-core form
    bit for bit."""
    form = form or sj.k1_form(x1.shape[1], half_t)
    _check_form(form)
    _check_shift(half_t, rb)
    if not _on_cuda("joint_fwd_v5", x1, x2):
        return joint_fwd_v5_plain(x1, x2, half_t, rb)
    if form == "cuda-core":
        return _split_k_fwd("joint_fwd_v5", _pipe_lib().joint_exp_fwd_v5, x1,
                            x2, half_t, rb)
    return _tma_fwd("joint_fwd_v5", _tma_lib().joint_exp_fwd_v5_tma, x1, x2,
                    half_t, rb)


def joint_fwd_v6(x1, x2, half_t, roll_build=False, form=None):
    """X6: X5's pipeline on f32 inputs, rounded to bf16 in the kernels
    (bf16 inputs are widened to f32 first, exactly); rb is fixed at 16. In
    the form ``form`` (one of ``X_FORMS``; by default
    ``seg_joint.k1_form``'s). Tensor cores: K1's layout pass on the f32
    inputs, then X5's kernel, so it equals X5 on inputs the wrapper
    rounds; ``roll_build`` launches the instantiation in which each warp
    rolls the A fragment of the M tile's first shift by its own shift in
    registers (lane shuffles and byte permutes). CUDA cores: each
    column-shifted A row built from the one before by a lane shuffle. In
    either form ``roll_build`` gives the same result bit for bit."""
    form = form or sj.k1_form(x1.shape[1], half_t)
    _check_form(form)
    _check_lanes(half_t)
    if not _on_cuda("joint_fwd_v6", x1, x2):
        return joint_fwd_v6_plain(x1, x2, half_t, roll_build)
    if form == "cuda-core":
        return _split_k_fwd("joint_fwd_v6", _pipe_lib().joint_exp_fwd_v6, x1,
                            x2, half_t, _V6_RB, int(bool(roll_build)),
                            to=torch.float32)

    def entry(*args):
        *args, stream = args
        return _tma_lib().joint_exp_fwd_v6_tma(*args, int(bool(roll_build)),
                                               stream)
    return _tma_fwd("joint_fwd_v6", entry, x1, x2, half_t, _V6_RB,
                    to=torch.float32)


def dgrad_v8(g2d, other, half_t, rb=16):
    """X8: the gradient for the column-shifted operand with the adjoint
    ``g2d`` (kT, kT) and ``other`` (n, k, h, w) rounded to bf16, f32
    accumulation, in the unpadded frame (``seg_joint.dgrad_plain``'s
    contract); ``rb`` is the tile rows of a block. On the card the products
    run on the tensor cores over the operands of ``dgrad_v8_operands``."""
    check_dgrad_v8(other.shape[1], half_t, rb)
    if not _on_cuda("dgrad_v8", g2d, other):
        return dgrad_v8_plain(g2d, other, half_t)
    o = _as_input("other", other)
    n, k, h, w = other.shape
    g = _adjoint_bf16("g2d", g2d, k * (2 * half_t + 1))
    gc, oc = dgrad_v8_operands(g, o, half_t)
    dx = torch.empty((n, k, h, w), device=other.device)
    err = _bwd_lib().joint_exp_dgrad_v8(
        gc.data_ptr(), oc.data_ptr(), dx.data_ptr(), n, k, h, w, half_t, rb,
        dgrad_v8_slab(k, half_t), _stream(other.device))
    if err != 0:
        raise RuntimeError(f"dgrad_v8 launch failed: CUDA error {err}")
    LAUNCHES["dgrad_v8"] += 1
    return dx


def bwd_v8(g, x1, x2, half_t, rb=16):
    """dx1, dx2 of the joint for the cotangent g (k, k, T, T): X8 on the two
    reordered adjoints (the TPU tool's ``bwd_v8``)."""
    g2d, g2d_swap = sj.adjoints(g)
    return (dgrad_v8(g2d, x2, half_t, rb),
            dgrad_v8(g2d_swap, x1, half_t, rb))


def dgrad_fused_v7(g, x1, x2, half_t):
    """X9: (dx1, dx2) of the joint for the cotangent g (k, k, T, T) in one
    launch, with g, x1 and x2 rounded to bf16 and each per-displacement
    partial rounded to bf16 before the f32 sum over v. On the card it runs
    X8's implicit GEMM with v outermost, over the operands of
    ``dgrad_v8_operands`` (N = 16) for each output."""
    k = x1.shape[1]
    check_fused_v7(k, half_t)
    if not _on_cuda("dgrad_fused_v7", g, x1, x2):
        return dgrad_fused_v7_plain(g, x1, x2, half_t)
    a = _as_input("x1", x1)
    b = _as_input("x2", x2, tuple(x1.shape))
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    if tuple(g.shape) != (k, k, t, t):
        raise ValueError(f"g: expected shape {(k, k, t, t)}, got "
                         f"{tuple(g.shape)}")
    g2d, g2d_swap = (_adjoint_bf16("g", m, k * t) for m in sj.adjoints(g))
    gc1, oc1 = dgrad_v8_operands(g2d, b, half_t, _V9_COLS)       # dx1: x2
    gc2, oc2 = dgrad_v8_operands(g2d_swap, a, half_t, _V9_COLS)  # dx2: x1
    dx1 = torch.empty((n, k, h, w), device=x1.device)
    dx2 = torch.empty_like(dx1)
    err = _bwd_lib().joint_exp_dgrad_fused_v7(
        gc1.data_ptr(), oc1.data_ptr(), gc2.data_ptr(), oc2.data_ptr(),
        dx1.data_ptr(), dx2.data_ptr(), n, k, h, w, half_t, _V7_RB,
        fused_v7_slab(k, half_t), _stream(x1.device))
    if err != 0:
        raise RuntimeError(f"dgrad_fused_v7 launch failed: CUDA error {err}")
    LAUNCHES["dgrad_fused_v7"] += 1
    return dx1, dx2


def probe_passes(n, h, half_t, rb):
    """X1's passes of depth 8*rb: the TPU probe's n * (t_hi - t_lo) row tiles
    of rb * 128 contraction each."""
    t_lo, t_hi = row_window(h, half_t, rb)
    return n * (t_hi - t_lo) * (rb * _WL) // (_BQ * rb)


def probe_wgmmas(rb):
    """X1's wgmma k16 steps per pass of depth 8*rb."""
    return _BQ * rb // 16


def probe_tiles(tk):
    """X1's 64 x 160 output tiles over (kT, kT)."""
    return -(-tk // _PROBE_M) * -(-tk // _PROBE_N)


def probe_split(passes, tiles, slots):
    """(splits, per): X1's passes cut into chunks of ``per`` so that its
    tiles x splits blocks fill one wave of the ``slots`` blocks the card
    holds at once (``joint_exp_mm_probe_slots``): a second, partial wave
    would leave SMs idle at the end."""
    want = max(1, min(passes, slots // tiles))
    per = -(-passes // want)
    return -(-passes // per), per


def mm_probe(n, k, h, half_t, rb, form, device):
    """X1: X2's stack product alone, over tiles of bf16 ones filled at
    block start and with no input, for the TPU probe's count of products;
    on the card it runs on the tensor cores, with the B tile K-major
    ("mk-nk") or MN-major ("mk-kn"). Returns (kT, kT), every entry the count
    of terms issued."""
    check_probe(half_t, rb, form)
    device = torch.device(device)
    if device.type == "cpu":
        return mm_probe_plain(n, k, h, half_t, rb, device)
    if device.type != "cuda":
        raise ValueError(f"mm_probe: device {device}")
    tk = k * (2 * half_t + 1)
    kn = int(form == "mk-kn")
    lib = _lib()
    with torch.cuda.device(device):
        slots = lib.joint_exp_mm_probe_slots(rb, kn)
    if slots < 1:
        raise RuntimeError(f"mm_probe: no block fits at rb={rb} (CUDA "
                           f"error {-slots})")
    passes = probe_passes(n, h, half_t, rb)
    splits, per = probe_split(passes, probe_tiles(tk), slots)
    part = torch.empty((splits, tk, tk), device=device)
    out = torch.empty((tk, tk), device=device)
    err = lib.joint_exp_mm_probe(
        part.data_ptr(), out.data_ptr(), tk, rb, kn, passes, per, splits,
        _stream(device))
    if err != 0:
        raise RuntimeError(f"mm_probe launch failed: CUDA error {err}")
    LAUNCHES["mm_probe"] += 1
    return out
