"""The port's experiment-tool kernels X1 and X2 (iic_tpu_torch/ops/kernels/
joint_exp.py) and its tool (iic_tpu_torch/tools/joint_kernel_exp.py) against
the JAX package's ``tools/joint_kernel_exp.py``, whose Pallas kernels run in
interpret mode on the CPU. Inputs are made from a numpy seed and fed to
both. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py."""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iic_tpu_torch.ops.kernels import joint_exp as jx
from iic_tpu_torch.ops.kernels import seg_joint as sj
from iic_tpu_torch.tools import joint_kernel_exp as tool

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "joint_kernel_exp.py"
_spec = importlib.util.spec_from_file_location("jax_joint_kernel_exp", _TOOL)
jax_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_tool)

TINY = (2, 7, 16, 10)  # n, k, h, half_t


def _softmax_maps(rng, n, k, h, w):
    z = rng.standard_normal((n, k, h, w)).astype(np.float32)
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("mode,n,k,h,half_t", [
    ("full", *TINY), ("rank3", *TINY), ("full", 3, 4, 12, 3)])
def test_plain_v2_matches_jax_tool(mode, n, k, h, half_t):
    """Plain X2 vs the TPU tool's ``joint_fwd_v2`` (interpret mode). Both
    round x1 and x2 to bf16 with round-to-nearest-even, and a product of
    two bf16 values is exact in f32, so the two differ only in the f32
    summation order: atol 1e-5 * max |P| (measured 6e-7)."""
    rng = np.random.default_rng(n + 10 * k)
    x1, x2 = _softmax_maps(rng, n, k, h, h), _softmax_maps(rng, n, k, h, h)
    ref = np.asarray(jax_tool.joint_fwd_v2(jnp.asarray(x1), jnp.asarray(x2),
                                           half_t, mode=mode))
    got = jx.joint_fwd_v2(torch.from_numpy(x1), torch.from_numpy(x2), half_t,
                          mode=mode).numpy()
    t = 2 * half_t + 1
    assert got.shape == ref.shape == (k, k, t, t)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_plain_v2_is_the_joint_of_bf16_inputs():
    """Plain X2 ``full`` vs the f32 joint (plain K1): the bf16 rounding of
    the inputs, within the JAX package's kernel contract (rtol 5e-3, atol
    5e-3 * max; tests/test_pallas_kernels.py:84-96)."""
    rng = np.random.default_rng(4)
    x1, x2 = (torch.from_numpy(_softmax_maps(rng, 2, 5, 16, 16))
              for _ in range(2))
    got = jx.joint_fwd_v2_plain(x1, x2, 3).numpy()
    ref = sj.displacement_joint_dense(x1, x2, 3).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-3 * ref.max())
    assert np.abs(got - ref).max() > 0  # the rounding is there


# The TPU tool leaves these outputs to uninitialised scratch (mm-only,
# mm_probe: NaN in interpret mode) or to the TPU's tiling (copies-only adds
# one row of each stack, and fails to broadcast for kT < 128; aligned-copies
# builds at the 16-row tile offset). The port defines them; these tests hold
# its plain versions to those definitions.

def test_aligned_copies_is_the_zero_displacement_joint_broadcast():
    rng = np.random.default_rng(5)
    x1, x2 = (torch.from_numpy(_softmax_maps(rng, 2, 4, 12, 12))
              for _ in range(2))
    half_t = 3
    got = jx.joint_fwd_v2_plain(x1, x2, half_t, "aligned-copies").numpy()
    p0 = jx.joint_fwd_v2_plain(x1, x2, half_t, "full")[:, :, half_t, half_t]
    assert got.shape == (4, 4, 7, 7)
    for u in range(7):
        for v in range(7):
            np.testing.assert_allclose(got[:, :, u, v], p0.numpy(),
                                       rtol=1e-6)


@pytest.mark.parametrize("n,k,h,w,half_t", [(2, 3, 6, 7, 2), (1, 2, 5, 4, 4)])
def test_copies_only_is_the_bit_checksum(n, k, h, w, half_t):
    """copies-only against its definition written as loops: (S_A[v,i] +
    S_B[u,j]) mod 2^32 of the bf16 bit patterns; integers, so exact."""
    rng = np.random.default_rng(6)
    x1 = torch.from_numpy(rng.standard_normal((n, k, h, w)).astype(np.float32))
    x2 = torch.from_numpy(rng.random((n, k, h, w)).astype(np.float32))
    b1, b2 = (x.to(torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
              & 0xFFFF for x in (x1, x2))
    t = 2 * half_t + 1
    s_a = np.zeros((t, k), np.int64)
    s_b = np.zeros((t, k), np.int64)
    for d in range(t):
        for q in range(w):
            col = q + d - half_t
            if 0 <= col < w:
                s_a[d] += b1[:, :, :, col].sum(axis=(0, 2))
        for y in range(h):
            row = y + half_t - d
            if 0 <= row < h:
                s_b[d] += b2[:, :, row, :].sum(axis=(0, 2))
    want = np.zeros((k, k, t, t), np.float32)
    for i in range(k):
        for j in range(k):
            for u in range(t):
                for v in range(t):
                    want[i, j, u, v] = float((s_a[v, i] + s_b[u, j]) % 2 ** 32)
    got = jx.joint_fwd_v2(x1, x2, half_t, "copies-only", rb=half_t + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mm_only_and_mm_probe_count_the_terms():
    """Both multiply tiles of bf16 ones: every entry is the count of
    contraction terms issued. mm-only: rows x 16-pixel k16 steps x 16 over
    K1's slabs, whatever rb; the probe: the TPU probe's n * (t_hi - t_lo)
    tiles of rb * 128."""
    x = torch.rand(2, 3, 8, 8)
    for rb in (3, 5):
        p = jx.joint_fwd_v2(x, x, 2, "mm-only", rb=rb)
        assert p.shape == (3, 3, 5, 5)
        assert torch.all(p == 2 * 8 * 1 * 16)  # 16 rows, one k16 step each
    assert jx.mm_only_terms(120, 128, 128) == 120 * 128 * 8 * 16
    assert jx.mm_only_terms(1, 10, 9) == 10 * 1 * 16
    for form in jx.FORMS:
        out = jx.mm_probe(2, 7, 16, 10, 16, form, "cpu")
        assert out.shape == (147, 147) and out.dtype == torch.float32
        assert torch.all(out == 2 * 2 * 16 * 128)  # row tiles (0, 2)
    assert jx.row_window(16, 10, 16) == (0, 2)
    assert jx.row_window(128, 10, 16) == (0, 9)
    assert jx.probe_passes(120, 128, 10, 16) * 8 * 16 == 120 * 9 * 16 * 128
    # 2,211,840 at the tool's default: under 2^24, so exact in f32
    assert float(jx.mm_probe_plain(120, 1, 128, 10, 16, "cpu")[0, 0]) \
        == 120 * 9 * 16 * 128 < 2 ** 24


@pytest.mark.parametrize("half_t,rb", [(10, 8), (65, 80), (3, 2)])
def test_wrappers_refuse_what_the_jax_tool_asserts(half_t, rb):
    """2*half_t <= 128 and 2*half_t <= 2*rb, as the TPU tool asserts."""
    x = np.ones((1, 2, 8, 8), np.float32)
    with pytest.raises(AssertionError):
        jax_tool.joint_fwd_v2(jnp.asarray(x), jnp.asarray(x), half_t, rb=rb)
    with pytest.raises(ValueError, match="2\\*half_t"):
        jx.joint_fwd_v2(torch.from_numpy(x), torch.from_numpy(x), half_t,
                        rb=rb)
    with pytest.raises(ValueError, match="2\\*half_t"):
        jx.mm_probe(1, 2, 8, half_t, rb, "mk-nk", "cpu")


def test_wrappers_refuse_what_shared_memory_cannot_hold():
    """X1: its (64 + 160) x 8*rb bf16 tiles and two 1 KB guards must fit
    a block's 227 KB: rb=64 does (231,424 bytes), rb=66 does not; and rb
    must be even. Refused before any launch, on every device. X2, on K1's
    stack product, stages slabs of 16 rows whatever rb: rb=128 is taken."""
    assert jx.probe_smem(16) == (64 + 160) * 128 * 2 + 2048 == 59392
    assert jx.probe_smem(64) == 231424 <= 232448 < jx.probe_smem(66)
    x = torch.rand(1, 2, 8, 8)
    assert jx.joint_fwd_v2(x, x, 2, rb=128).shape == (2, 2, 5, 5)
    with pytest.raises(ValueError, match="shared memory"):
        jx.mm_probe(1, 2, 8, 2, 128, "mk-kn", "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        jx.mm_probe(1, 2, 8, 2, 66, "mk-nk", "cpu")
    with pytest.raises(ValueError, match="even"):
        jx.mm_probe(1, 2, 8, 2, 17, "mk-nk", "cpu")
    with pytest.raises(ValueError, match="mode"):
        jx.joint_fwd_v2(x, x, 2, mode="v3")
    with pytest.raises(ValueError, match="form"):
        jx.mm_probe(1, 2, 8, 2, 16, "nk-mk", "cpu")
    with pytest.raises(ValueError):
        jx.joint_fwd_v2(x, x.to("meta"), 2)


@pytest.mark.parametrize("n,k,h,half_t,rb", [
    (120, 15, 128, 10, 16), (120, 15, 128, 10, 32), (120, 15, 128, 10, 64),
    (120, 3, 128, 10, 16), (2, 7, 16, 10, 16), (1, 3, 20, 4, 64)])
def test_x1_issue_arithmetic(n, k, h, half_t, rb):
    """X1's launch plan issues exactly the count its plain version states:
    the passes cut into ``splits`` chunks (the last may be shorter), each
    pass rb/2 wgmma k16 steps of depth 16, so wgmmas x 16 summed over the
    splits is every entry's count. The blocks, 64 x 160 tiles x splits,
    fill one wave of the card's slots: on the H100, 132 SMs x the blocks
    its 228 KB of shared memory admit at 1 KB reserved each (the tool's
    default: 10 tiles x 39 splits on 3 x 132 slots)."""
    tk = k * (2 * half_t + 1)
    passes = jx.probe_passes(n, h, half_t, rb)
    slots = 132 * (233472 // (jx.probe_smem(rb) + 1024))
    splits, per = jx.probe_split(passes, jx.probe_tiles(tk), slots)
    chunks = [min(per, passes - s * per) for s in range(splits)]
    assert min(chunks) >= 1 and sum(chunks) == passes
    wgmmas = [c * jx.probe_wgmmas(rb) for c in chunks]
    terms = float(jx.mm_probe_plain(n, k, h, half_t, rb, "cpu")[0, 0])
    assert sum(wgmmas) * 16 == terms
    assert max(wgmmas) * 16 * splits >= terms > (max(wgmmas) * 16
                                                 * (splits - 1))
    assert jx.probe_tiles(tk) * splits <= max(slots, jx.probe_tiles(tk))
    if (n, k, h, half_t, rb) == (120, 15, 128, 10, 16):
        assert (jx.probe_tiles(tk), splits, per, slots) == (10, 39, 444, 396)
        assert terms == 2211840


def test_cpu_wrappers_use_plain_and_count_no_launch():
    jx.reset_launch_counts()
    x = torch.rand(2, 3, 8, 8)
    for mode in jx.MODES:
        jx.joint_fwd_v2(x, x, 2, mode=mode)
    jx.mm_probe(2, 3, 8, 2, 16, "mk-kn", torch.device("cpu"))
    assert set(jx.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("run,variants", [(None, 8), ("ablate", 12),
                                          ("mmprobe", 4)])
def test_tool_runs_on_cpu(capsys, run, variants):
    """The port's tool end to end at a tiny size on the plain versions:
    every variant reports, none FAILED, every time and error is finite; the
    bf16 variants are within bf16 rounding of the float64 reference, the
    f32 ones within f32 rounding, and the exact ablations are exact."""
    argv = ([run] if run else []) + [str(a) for a in TINY]
    records = tool.main(argv, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("joint_kernel_exp ") and out[0].endswith("cpu")
    assert len(out) == 1 + len(records) == 1 + variants, out
    for rec, line in zip(records, out[1:]):
        assert rec["failed"] is None and line.startswith(rec["name"]), line
        assert math.isfinite(rec["ms"]) and rec["errs"], rec
        for label, err in rec["errs"].items():
            assert math.isfinite(err), rec
            if label == "max |P - plain|":
                assert err == 0.0, rec
            elif "bf16" in rec["name"] or "full" in rec["name"] \
                    or "rank3" in rec["name"]:
                assert err < 1e-2, rec  # bf16 rounding (about 5e-4)
            else:
                assert err < 1e-5, rec  # f32 rounding


def test_tool_bwd_conv_is_the_joint_vjp():
    """The tool's E1 conv backward (f32) vs autograd of the plain joint:
    rtol 1e-4, atol 1e-5 * max (summation order)."""
    rng = np.random.default_rng(8)
    half_t = 2
    x1, x2 = (torch.from_numpy(_softmax_maps(rng, 2, 3, 10, 10))
              .requires_grad_() for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((3, 3, 5, 5)).astype(np.float32))
    ref = torch.autograd.grad((sj.displacement_joint_dense(x1, x2, half_t)
                               * g).sum(), (x1, x2))
    got = tool.bwd_conv(x1.detach(), x2.detach(), g, half_t)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


# ------------------------------------- X2's tensor-core form, restated

def k1_slabs(n, h, w, rb, chunk_rows=sj.K1_CHUNK_ROWS, half_t=0, k=1):
    """K1's slab walk (csrc/joint_fwd_common.cuh jf_next) for every chunk
    of ``sj.k1_plan``: yields (chunk, image, first row, rows, first pixel,
    k16 steps), passes of rb rows of one image cut into slabs of 16 rows x
    64 pixels, a pass's row slabs before the next pass."""
    per, splits = sj.k1_plan(n, k, h, half_t, rb, chunk_rows)
    pph = -(-h // rb)
    passes = n * pph
    assert (splits - 1) * per < passes <= splits * per
    for z in range(splits):
        for p in range(z * per, min(z * per + per, passes)):
            img, yb = divmod(p, pph)
            for wy in range(yb * rb, min(yb * rb + rb, h), sj._JF_ROWS):
                rows = min(sj._JF_ROWS, yb * rb + rb - wy, h - wy)
                for q0 in range(0, w, sj._JF_PIX):
                    yield z, img, wy, rows, q0, -(-min(sj._JF_PIX, w - q0)
                                                   // 16)


@pytest.mark.parametrize("n,h,w,rb", [(120, 128, 128, 16), (120, 128, 128, 64),
                                      (1, 10, 9, 4), (2, 20, 70, 16),
                                      (3, 33, 130, 32)])
def test_mm_only_terms_follow_k1s_slab_walk(n, h, w, rb):
    """mm-only's count is rows x k16 steps x 16 summed over K1's slab walk,
    which covers every row once whatever rb. At the tool's default it is
    1,966,080, under 2^24 (exact in f32)."""
    walk = sum(rows * steps * 16
               for *_, rows, _, steps in k1_slabs(n, h, w, rb))
    assert jx.mm_only_terms(n, h, w) == walk
    if (n, h, w) == (120, 128, 128):
        assert walk == 1966080 < 2 ** 24


def _bits64(x):
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _x2_copies_restated(x1, x2, half_t, rb):
    """X2 copies-only (csrc/joint_exp.cu copies_only_kernel) restated from what its blocks stage: for each block (N tile,
    M tile, chunk) and each slab of ``k1_slabs``, the x1 rows at pixels
    q0 + v0 - h .. + 66 and the window of rows + 20 x2 rows from wy - h +
    up0, both channels-last (``sj.channels_last_chunks``), zero outside the
    frame; S_A of shift v0 + s from pixels q + s of the rows (blocks of the
    first N tile), S_B of shift u' from the window's row sums over rows
    u' .. u' + rows - 1 (blocks of the first M tile), pixels q past w
    masked; all in int64 modulo 2^32."""
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    tk = k * t
    b1 = _bits64(sj.channels_last_chunks(x1))  # (n, chunks, h, w, 16)
    b2 = _bits64(sj.channels_last_chunks(x2))
    chunks = b1.shape[1]
    m_tiles, n_tiles = -(-t // sj._JF_V), -(-t // sj._JF_U)
    chk = torch.zeros(2 * tk, dtype=torch.int64)
    slabs = list(k1_slabs(n, h, w, rb, half_t=half_t, k=k))
    for bx in range(chunks * n_tiles):
        jc, up0 = bx // n_tiles, (bx % n_tiles) * sj._JF_U
        for by in range(chunks * m_tiles):
            ic, v0 = by // m_tiles, (by % m_tiles) * sj._JF_V
            s_a = torch.zeros(sj._JF_V, 16, dtype=torch.int64)
            s_b = torch.zeros(sj._JF_U, 16, dtype=torch.int64)
            for _, img, wy, rows, q0, _ in slabs:
                qmax = min(sj._JF_PIX, w - q0)
                if bx == 0:
                    xx = q0 + v0 - half_t + torch.arange(sj._JF_A_PIX - 1)
                    ok = ((xx >= 0) & (xx < w))[None, :, None]
                    rows1 = torch.where(
                        ok, b1[img, ic, wy:wy + rows][:, xx.clamp(0, w - 1)],
                        0)  # (rows, 67, 16)
                    for sh in range(sj._JF_V):
                        s_a[sh] += rows1[:, sh:sh + qmax].sum(dim=(0, 1))
                if by == 0:
                    yy = wy - half_t + up0 + torch.arange(rows + sj._JF_U - 1)
                    ok = ((yy >= 0) & (yy < h))[:, None, None]
                    win = torch.where(
                        ok, b2[img, jc][yy.clamp(0, h - 1), q0:q0 + qmax],
                        0)
                    row_sums = win.sum(dim=1)  # (rows + 20, 16)
                    for up in range(sj._JF_U):
                        s_b[up] += row_sums[up:up + rows].sum(dim=0)
            for sh in range(sj._JF_V):
                for c in range(16):
                    v, i = v0 + sh, ic * 16 + c
                    if bx == 0 and v < t and i < k:
                        chk[v * k + i] += s_a[sh, c]
            for up in range(sj._JF_U):
                for c in range(16):
                    u, j = t - 1 - (up0 + up), jc * 16 + c
                    if by == 0 and u >= 0 and j < k:
                        chk[tk + u * k + j] += s_b[up, c]
    chk %= 2 ** 32
    e = torch.arange(tk * tk)
    total = (chk[e // tk] + chk[tk + e % tk]) % 2 ** 32
    return (total.to(torch.float64).to(torch.float32)
            .reshape(t, k, t, k).permute(1, 3, 2, 0))


@pytest.mark.parametrize("n,k,h,w,half_t,rb", [
    (2, 5, 20, 70, 1, 16), (1, 17, 9, 20, 10, 16), (2, 3, 18, 33, 10, 32),
    (1, 4, 12, 8, 11, 16)])
def test_x2_mma_copies_only_restatement(n, k, h, w, half_t, rb):
    """X2 copies-only, restated from its slab walk, row
    sums and range sums over the staged layouts, equals the order-free
    checksum that defines the mode (``copies_checksum``) exactly: two
    channel chunks (k=17), two N tiles (half_t 11), ragged rows, columns
    and slabs, rb 16 and 32."""
    rng = np.random.default_rng(n + k + h + w)
    x1 = torch.from_numpy(rng.standard_normal((n, k, h, w)).astype(np.float32))
    x2 = torch.from_numpy(rng.random((n, k, h, w)).astype(np.float32))
    got = _x2_copies_restated(x1, x2, half_t, rb)
    assert torch.equal(got, jx.copies_checksum(x1, x2, half_t))


def test_x3_form_argument_and_x2_x3_limits():
    """X3 takes ``form`` in X_FORMS and refuses anything else on every
    device; its default is K1's choice (the CUDA-core pipeline at k <= 4).
    X2 has one form, K1's stack product. Both keep the
    TPU tool's asserts and add no rb limit of their own on the tensor
    cores (slabs of 16 rows)."""
    assert jx.X_FORMS == ("wgmma", "cuda-core")
    x = torch.rand(1, 2, 8, 8)
    with pytest.raises(ValueError, match="form"):
        jx.joint_fwd_v3(x, x, 2, rb=16, form="cudnn")
    for fn, kw in [(jx.joint_fwd_v2, {})] + [
            (jx.joint_fwd_v3, {"form": f}) for f in jx.X_FORMS]:
        with pytest.raises(ValueError, match="2\\*half_t"):
            fn(x, x, 10, rb=8, **kw)
        with pytest.raises(ValueError, match="2\\*half_t"):
            fn(x, x, 65, rb=80, **kw)
    jx.check_args(10, 128)
    assert jx.joint_fwd_v3(x, x, 2, rb=128, form="wgmma").shape == (2, 2, 5,
                                                                     5)


def test_cpu_wrappers_take_plain_in_every_form():
    """On CPU tensors X2 (every mode) and X3 (either form) return their
    plain versions and count no launch."""
    jx.reset_launch_counts()
    rng = np.random.default_rng(3)
    x1, x2 = (torch.from_numpy(_softmax_maps(rng, 2, 5, 12, 20))
              for _ in range(2))
    for mode in jx.MODES:
        assert torch.equal(jx.joint_fwd_v2(x1, x2, 3, mode, rb=8),
                           jx.joint_fwd_v2_plain(x1, x2, 3, mode, 8))
    for form in jx.X_FORMS:
        assert torch.equal(jx.joint_fwd_v3(x1, x2, 3, 8, form=form),
                           jx.joint_fwd_v3_plain(x1, x2, 3, 8))
    assert set(jx.LAUNCHES.values()) == {0}
