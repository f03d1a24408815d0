"""Forward probes of the displacement-joint experiment tool: the CUDA
kernels X2 (joint forward with bf16 operands, and its ablations) and X1 (the
stack-product probe), with their plain PyTorch versions.

Replaces two kernels of ``tools/joint_kernel_exp.py``: X2 replaces
``_joint_kernel_v2`` (launched by ``joint_fwd_v2``), X1 ``_mm_probe_kernel``
(launched by ``mm_probe``). The kernels' source, with the note on what bounds
them on the H100, how their design answers it and the exact definition of
each mode, is ``iic_tpu_torch/csrc/joint_exp.cu``.

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

from iic_tpu_torch.ops.kernels import _build
from iic_tpu_torch.ops.kernels.seg_joint import displacement_joint_dense

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"joint_fwd_v2": 0, "mm_probe": 0}

MODES = ("full", "rank3", "mm-only", "copies-only", "aligned-copies")
FORMS = ("mk-nk", "mk-kn")
# csrc/joint_exp.cu Mode; "rank3" is the "full" launch on this card
_MODE_IDS = {"full": 0, "rank3": 0, "mm-only": 1, "copies-only": 2,
             "aligned-copies": 3}
_WL = 128        # the TPU tool's lane width: X1's row tiles are rb x 128
_TILE = 64       # output tile edge (csrc/joint_exp.cu TILE)
_BQ = 8          # image columns per shared-memory pass (BQ)
# Shared memory a block may use on the H100, less the kernel's 1.5 KB of
# static tables
_SMEM_LIMIT = 232448 - 1536
_TARGET_BLOCKS = 8 * 132  # blocks to put in flight: eight per SM


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def stage_bytes(rb, form="mk-nk"):
    """Dynamic shared memory of one block (csrc/joint_exp.cu stage_bytes):
    the A tile (64, 8*rb + 2) and the B tile, both bf16."""
    a = 2 * _TILE * (_BQ * rb + 2)
    return a + (2 * _BQ * rb * (_TILE + 2) if form == "mk-kn" else a)


def check_args(half_t, rb, form="mk-nk"):
    """The TPU tool's asserts (2*half_t <= 128 and 2*half_t <= 2*rb) and
    this card's limit: one pass of rb rows must fit a block's shared
    memory."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    if rb < 1 or not (2 * half_t <= _WL and 2 * half_t <= 2 * rb):
        raise ValueError(f"half_t={half_t}, rb={rb}: need rb >= 1, "
                         f"2*half_t <= {_WL} and 2*half_t <= 2*rb")
    if stage_bytes(rb, form) > _SMEM_LIMIT:
        raise ValueError(f"rb={rb}: a pass needs {stage_bytes(rb, form)} "
                         f"bytes of shared memory, over the {_SMEM_LIMIT} a "
                         f"block can use")


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

def _bf16_values(x):
    """x rounded to bf16 (nearest even, as the TPU tool's astype), in f32,
    or in f64 for f64 input (a float64 reference for the checks)."""
    return x.to(torch.bfloat16).to(torch.promote_types(x.dtype,
                                                       torch.float32))


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


def mm_only_terms(n, h, w, rb):
    """The contraction terms X2 ``mm-only`` issues per output entry: a
    pass per rb rows (the rows are cut into chunks of whole passes) and per
    8 columns, each of depth 8*rb."""
    return -(-n * h // rb) * -(-w // _BQ) * _BQ * rb


def joint_fwd_v2_plain(x1, x2, half_t, mode="full", rb=16):
    """Plain version of X2: the (k, k, T, T) joint of x1, x2 rounded to
    bf16, accumulated in f32 (f64 for f64 input), for ``mode`` (see the
    module docstring). Only ``mm-only`` depends on ``rb``: its entries are
    ``mm_only_terms``, exact in f32 up to 2^24."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    if mode == "copies-only":
        return copies_checksum(x1, x2, half_t)
    if mode == "mm-only":
        return torch.full((k, k, t, t), float(mm_only_terms(n, h, w, rb)),
                          device=x1.device)
    a, b = _bf16_values(x1), _bf16_values(x2)
    if mode == "aligned-copies":
        p0 = displacement_joint_dense(a, b, 0)
        return p0.expand(k, k, t, t).contiguous()
    return displacement_joint_dense(a, b, half_t)


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
        lib.joint_exp_fwd_v2.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
        lib.joint_exp_fwd_v2.restype = i
        lib.joint_exp_mm_probe.argtypes = [p, p] + [i] * 6 + [p]
        lib.joint_exp_mm_probe.restype = i
        lib._typed = True
    return lib


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _as_bf16(name, x, shape=None):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
    if x.dim() != 4 or (shape is not None and tuple(x.shape) != shape):
        raise ValueError(f"{name}: expected shape {shape or '(n, k, h, w)'}, "
                         f"got {tuple(x.shape)}")
    return x.to(torch.bfloat16)


def joint_fwd_v2(x1, x2, half_t, mode="full", rb=16):
    """X2: the (k, k, T, T) displacement joint of x1, x2 (n, k, h, w) with
    both inputs rounded to bf16 and f32 accumulation, or one of its
    ablations (``mode``). ``rb`` is the image rows a block stages per
    shared-memory pass."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    check_args(half_t, rb)
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return joint_fwd_v2_plain(x1, x2, half_t, mode, rb)
    if x1.device.type != "cuda" or x2.device != x1.device:
        raise ValueError(f"joint_fwd_v2: inputs on {x1.device} and "
                         f"{x2.device}")
    a = _as_bf16("x1", x1)
    b = _as_bf16("x2", x2, tuple(x1.shape))
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    tk = k * t
    splits, per = _split(n * h, (-(-tk // _TILE)) ** 2, rb)
    part = torch.empty((splits, tk, tk), device=x1.device)
    chk = torch.empty((2 * tk,), device=x1.device, dtype=torch.int32)
    out = torch.empty((k, k, t, t), device=x1.device)
    err = _lib().joint_exp_fwd_v2(
        a.data_ptr(), b.data_ptr(), part.data_ptr(), chk.data_ptr(),
        out.data_ptr(), n, k, h, w, half_t, rb, _MODE_IDS[mode], splits, per,
        _stream(x1.device))
    if err != 0:
        raise RuntimeError(f"joint_fwd_v2 launch failed: CUDA error {err}")
    LAUNCHES["joint_fwd_v2"] += 1
    return out


def probe_passes(n, h, half_t, rb):
    """X1's passes of depth 8*rb: the TPU probe's n * (t_hi - t_lo) row tiles
    of rb * 128 contraction each."""
    t_lo, t_hi = row_window(h, half_t, rb)
    return n * (t_hi - t_lo) * (rb * _WL) // (_BQ * rb)


def mm_probe(n, k, h, half_t, rb, form, device):
    """X1: X2's stack product alone, over tiles of bf16 ones filled at
    block start and with no input, for the TPU probe's count of products;
    ``form`` stages the B tile (N, K) ("mk-nk") or (K, N) ("mk-kn").
    Returns (kT, kT), every entry the count of terms issued."""
    check_args(half_t, rb, form)
    device = torch.device(device)
    if device.type == "cpu":
        return mm_probe_plain(n, k, h, half_t, rb, device)
    if device.type != "cuda":
        raise ValueError(f"mm_probe: device {device}")
    tk = k * (2 * half_t + 1)
    passes = probe_passes(n, h, half_t, rb)
    splits, per = _split(passes, (-(-tk // _TILE)) ** 2)
    part = torch.empty((splits, tk, tk), device=device)
    out = torch.empty((tk, tk), device=device)
    err = _lib().joint_exp_mm_probe(
        part.data_ptr(), out.data_ptr(), tk, rb, int(form == "mk-kn"),
        passes, per, splits, _stream(device))
    if err != 0:
        raise RuntimeError(f"mm_probe launch failed: CUDA error {err}")
    LAUNCHES["mm_probe"] += 1
    return out
