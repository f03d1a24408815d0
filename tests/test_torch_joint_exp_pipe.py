"""The port's pipelined experiment-tool kernels X3-X6 (``joint_fwd_v3`` ...
``joint_fwd_v6`` in iic_tpu_torch/ops/kernels/joint_exp.py), as their plain
versions on the CPU, and the port's ``v3``, ``v4``, ``v5``, ``v6`` and
``kpad`` tool runs, against the JAX package's ``tools/joint_kernel_exp.py``,
whose Pallas kernels run in interpret mode on the CPU. Inputs are
numpy-seeded softmax maps fed to both. The CUDA kernels themselves are
tested on the card by tests/test_torch_cuda.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iic_tpu_torch.ops.kernels import joint_exp as jx
from iic_tpu_torch.ops.kernels import seg_joint as sj
from iic_tpu_torch.tools import joint_kernel_exp as tool
from test_torch_joint_exp import _softmax_maps, jax_tool, k1_slabs

SIZES = [(2, 7, 16, 10), (2, 5, 16, 3)]  # n, k, h, half_t

# (port function, JAX function, keyword arguments, size): each rb and flat
# of v3 once, v4, v5 and v6 at both sizes; a dozen interpret-mode calls
CASES = [
    ("joint_fwd_v3", {"rb": 16, "flat": True}, SIZES[0]),
    ("joint_fwd_v3", {"rb": 16, "flat": False}, SIZES[1]),
    ("joint_fwd_v3", {"rb": 32, "flat": True}, SIZES[1]),
    ("joint_fwd_v3", {"rb": 32, "flat": False}, SIZES[0]),
    ("joint_fwd_v4", {}, SIZES[0]),
    ("joint_fwd_v4", {"rb": 8}, SIZES[1]),
    ("joint_fwd_v5", {}, SIZES[0]),
    ("joint_fwd_v5", {"rb": 4}, SIZES[1]),
    ("joint_fwd_v6", {"roll_build": False}, SIZES[0]),
    ("joint_fwd_v6", {"roll_build": False}, SIZES[1]),
]


def _inputs(n, k, h, half_t):
    rng = np.random.default_rng(10 * k + half_t)
    return _softmax_maps(rng, n, k, h, h), _softmax_maps(rng, n, k, h, h)


@pytest.mark.parametrize("name,kwargs,size", CASES,
                         ids=[f"{n}-{kw}-{s}" for n, kw, s in CASES])
def test_plain_pipelined_fwd_matches_jax_tool(name, kwargs, size):
    """Plain X3-X6 vs the TPU tool's ``joint_fwd_v3`` ... ``_v6``: all
    round x1 and x2 to bf16 (nearest even) and sum exact f32 products, in
    another order: atol 1e-5 * max |P| (measured up to 1.6e-7)."""
    n, k, h, half_t = size
    x1, x2 = _inputs(*size)
    ref = np.asarray(getattr(jax_tool, name)(jnp.asarray(x1), jnp.asarray(x2),
                                             half_t, **kwargs))
    got = getattr(jx, name)(torch.from_numpy(x1), torch.from_numpy(x2),
                            half_t, **kwargs).numpy()
    t = 2 * half_t + 1
    assert got.shape == ref.shape == (k, k, t, t)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["joint_fwd_v3", "joint_fwd_v4",
                                  "joint_fwd_v5"])
@pytest.mark.parametrize("half_t,rb", [(10, 8), (65, 80), (3, 2)])
def test_wrappers_refuse_what_the_jax_tool_asserts(name, half_t, rb):
    """X3, X4, X5: 2*half_t <= 128 and 2*half_t <= 2*rb, as the TPU tool
    asserts (:335, :463, :595)."""
    x = np.ones((1, 2, 8, 8), np.float32)
    with pytest.raises(AssertionError):
        getattr(jax_tool, name)(jnp.asarray(x), jnp.asarray(x), half_t,
                                rb=rb)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="2\\*half_t"):
        getattr(jx, name)(xt, xt, half_t, rb=rb)


def test_v6_refuses_only_what_the_jax_tool_asserts():
    """X6's rb is fixed at 16 and the TPU tool asserts only 2*half_t <= 128
    (:883): half_t=65 is refused by both, and half_t=20, which X5 refuses
    at rb=16, runs."""
    x = np.ones((1, 2, 8, 8), np.float32)
    with pytest.raises(AssertionError):
        jax_tool.joint_fwd_v6(jnp.asarray(x), jnp.asarray(x), 65)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="2\\*half_t <= 128"):
        jx.joint_fwd_v6(xt, xt, 65)
    assert jx.joint_fwd_v6(xt, xt, 20).shape == (2, 2, 41, 41)
    with pytest.raises(ValueError, match="2\\*half_t"):
        jx.joint_fwd_v5(xt, xt, 20)


def test_plain_versions_are_the_bf16_joint():
    """Every plain version of X3-X6 is X2 ``full``'s plain version, at any
    rb, flat and roll_build."""
    x1, x2 = (torch.from_numpy(a) for a in _inputs(*SIZES[1]))
    ref = jx.joint_fwd_v2_plain(x1, x2, 3)
    for got in (jx.joint_fwd_v3_plain(x1, x2, 3, 32, False),
                jx.joint_fwd_v4_plain(x1, x2, 3, 8),
                jx.joint_fwd_v5_plain(x1, x2, 3, 4),
                jx.joint_fwd_v6_plain(x1, x2, 3, True)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("fn", [jx.joint_fwd_v5, jx.joint_fwd_v2],
                         ids=["v5", "v2"])
def test_kpad_sliced_equals_unpadded(fn):
    """The kpad run's padding: channels k..15 are zero, so the joint of the
    padded maps sliced back to k equals the joint of the maps themselves
    (the channel pairs do not mix; atol 1e-6 * max for the summation
    order); k over 16 is refused."""
    x1, x2 = (torch.from_numpy(a) for a in _inputs(*SIZES[1]))
    got = tool.kpad16(x1, x2, 3, fn)
    ref = fn(x1, x2, 3)
    assert got.shape == ref.shape == (5, 5, 7, 7)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-6 * float(ref.abs().max()))
    wide = torch.rand(1, 17, 8, 8)
    with pytest.raises(ValueError, match="16"):
        tool.kpad16(wide, wide, 1, fn)


def test_cpu_wrappers_use_plain_and_count_no_launch():
    jx.reset_launch_counts()
    x = torch.rand(2, 3, 8, 8)
    jx.joint_fwd_v3(x, x, 2, 4, False)
    jx.joint_fwd_v4(x, x, 2)
    jx.joint_fwd_v5(x, x, 2, 2)
    jx.joint_fwd_v6(x, x, 2, True)
    assert set(jx.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("run,variants", [("v3", 5), ("v4", 1), ("v5", 1),
                                          ("v6", 2), ("kpad", 2)])
def test_tool_pipelined_runs_on_cpu(capsys, run, variants):
    """The port's ``v3``, ``v4``, ``v5``, ``v6`` and ``kpad`` runs end to
    end at a tiny size on the plain versions: every variant reports, none
    FAILED (``v6`` with roll_build=True included), every time and error is
    finite; the bf16 variants are within bf16 rounding of the float64
    reference, K1 (v3's E0) within f32 rounding."""
    records = tool.main([run, *map(str, SIZES[1])], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith(f"joint_kernel_exp {run}: ") \
        and out[0].endswith("cpu")
    assert len(out) == 1 + len(records) == 1 + variants, out
    for rec, line in zip(records, out[1:]):
        assert rec["failed"] is None and line.startswith(rec["name"]), line
        assert "FAILED" not in line
        assert math.isfinite(rec["ms"]) and rec["errs"], rec
        (err,) = rec["errs"].values()
        assert math.isfinite(err), rec
        if rec["name"].startswith("E0"):
            assert err < 1e-5, rec  # f32 rounding
        else:
            assert err < 1e-2, rec  # bf16 rounding (about 6e-4)


def _tma_box(xv, c0, c1, c2, c3, box):
    """What a TMA load of ``box`` (channels, pixels, rows, 1) at
    coordinates (c0, c1, c2, c3) of the 4-D tensor map over ``xv`` (n
    chunks, h, w, 16) lands in shared memory: [row][pixel][channel], every
    element whose coordinate lies before or past the tensor zero."""
    chans, pix, rows, _ = box
    z, h, w, ch = xv.shape
    r = (c2 + torch.arange(rows))[:, None, None]
    p = (c1 + torch.arange(pix))[None, :, None]
    c = (c0 + torch.arange(chans))[None, None, :]
    ok = (r >= 0) & (r < h) & (p >= 0) & (p < w) & (c < ch) & (0 <= c3 < z)
    vals = xv[min(max(c3, 0), z - 1), r.clamp(0, h - 1), p.clamp(0, w - 1),
              c.clamp(0, ch - 1)]
    return torch.where(ok, vals, torch.zeros(()))


def _x3_tma_restated(x1, x2, half_t, rb=16, chunk_rows=sj.K1_CHUNK_ROWS):
    """X3's tensor-core form (csrc/joint_exp_tma.cu) restated in plain
    PyTorch from the boxes its TMA loads bring: for each block (N tile, M
    tile, chunk of ``sj.k1_plan``) and each slab of K1's walk, a slot built
    from the four boxes of ``jx.X3_BOX_B`` (x2 window at (q0, wy - h +
    up0)) and ``jx.X3_BOX_A`` (x1 rows at (q0 + v0 - h, wy)), each channel
    half at channel 0 or 8, over the tensor maps (16, w, h, n chunks) of
    the channels-last chunks, zero outside; A gathered at the ldmatrix.trans
    addresses of the [half][row][68 pixels][8] rows, B at the core matrices
    of warpgroup g's descriptor (start: half g's window, row r; LBO 128
    bytes along K, SBO one window row along N), one (64 x 16) @ (16 x 168)
    product per warpgroup, row and k16 step; column 8 c + jj of warpgroup g
    stored at u' = up0 + c, j = 16 jc + 8 g + jj, u = T - 1 - u'; the
    partials added in chunk order."""
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    tk = k * t
    nv, nu, cm = sj._JF_V, sj._JF_U, sj._JF_CM
    x1v = sj.channels_last_chunks(x1).float().flatten(0, 1)
    x2v = sj.channels_last_chunks(x2).float().flatten(0, 1)
    chunks = -(-k // sj._JF_CH)
    m_tiles, n_tiles = -(-t // nv), -(-t // nu)
    per, splits = sj.k1_plan(n, k, h, half_t, rb, chunk_rows)
    buf_bytes = jx._XT_A_OFF + 2 * jx._XT_A_HALF
    assert buf_bytes == sj._JF_SMEM  # K1's buffer, rearranged

    # byte offsets of A[16 warp + c][kk] from a row's start, and of
    # B[kq][col] from a warpgroup's descriptor start
    warp, c16, kk = torch.meshgrid(torch.arange(nv), torch.arange(16),
                                   torch.arange(16), indexing="ij")
    a_off = ((c16 // 8) * jx._XT_A_HALF + (warp + kk % 8 + 8 * (kk // 8)) * 16
             + 2 * (c16 % 8)).reshape(64, 16)
    kq, col = torch.meshgrid(torch.arange(16), torch.arange(8 * cm),
                             indexing="ij")
    row_b = sj._JF_PIX * 16  # one window row of one half: also the SBO
    b_off = (col // 8) * row_b + (kq // 8) * 128 + (kq % 8) * 16 \
        + 2 * (col % 8)

    part = torch.zeros(splits, tk, tk)
    slabs = list(k1_slabs(n, h, w, rb, chunk_rows, half_t, k))
    for bx in range(chunks * n_tiles):
        jc, up0 = bx // n_tiles, (bx % n_tiles) * nu
        for by in range(chunks * m_tiles):
            ic, v0 = by // m_tiles, (by % m_tiles) * nv
            acc = torch.zeros(splits, 2, 64, 8 * cm)
            for z, img, wy, rows, q0, steps in slabs:
                slot = torch.zeros(buf_bytes // 2)
                for c in range(2):
                    win = _tma_box(x2v, 8 * c, q0, wy - half_t + up0,
                                   img * chunks + jc, jx.X3_BOX_B)
                    o = c * jx._XT_WIN // 2
                    slot[o:o + win.numel()] = win.flatten()
                    a = _tma_box(x1v, 8 * c, q0 + v0 - half_t, wy,
                                 img * chunks + ic, jx.X3_BOX_A)
                    o = (jx._XT_A_OFF + c * jx._XT_A_HALF) // 2
                    slot[o:o + a.numel()] = a.flatten()
                for ry in range(rows):
                    for st in range(steps):
                        a = slot[(jx._XT_A_OFF + ry * jx._XT_A_ROW + 256 * st
                                  + a_off) // 2]
                        for g in range(2):
                            b = slot[(g * jx._XT_WIN + ry * row_b + 256 * st
                                      + b_off) // 2]
                            acc[z, g] += a @ b
            m_loc, col2 = torch.meshgrid(torch.arange(64),
                                         torch.arange(8 * cm), indexing="ij")
            for g in range(2):
                v, i = v0 + m_loc // 16, ic * 16 + m_loc % 16
                u = t - 1 - (up0 + col2 // 8)
                j = jc * 16 + 8 * g + col2 % 8
                ok = (v < t) & (u >= 0) & (i < k) & (j < k)
                for z in range(splits):
                    part[z][(v * k + i)[ok], (u * k + j)[ok]] = acc[z, g][ok]
    out = part[0].clone()
    for z in range(1, splits):
        out += part[z]
    return out.reshape(t, k, t, k).permute(1, 3, 2, 0)


@pytest.mark.parametrize("n,k,h,w,half_t,rb,chunk_rows", [
    (2, 5, 20, 70, 1, 16, 128), (1, 17, 9, 20, 10, 16, 128),
    (2, 5, 18, 33, 10, 32, 16), (1, 17, 12, 66, 1, 16, 16)])
def test_x3_tma_restatement_matches_jax_v3(n, k, h, w, half_t, rb,
                                           chunk_rows):
    """X3's tensor-core form restated over its TMA boxes and shared-memory
    layout (the [half][row][pixel][8] window, the (half, u') N order, the
    zero fill of boxes before and past the frame, the column map back to
    (u', j)) vs the TPU tool's ``joint_fwd_v3`` (interpret mode): the same
    bf16 operands and exact products, f32 sums in another order: atol
    1e-5 * max. Ragged h and w (not multiples of 16 and 64), k = 5 and 17
    (two channel chunks), half_t 1 and 10, rb 16 and 32, one and several
    chunks."""
    rng = np.random.default_rng(7 * k + w)
    x1, x2 = (_softmax_maps(rng, n, k, h, w) for _ in range(2))
    ref = np.asarray(jax_tool.joint_fwd_v3(jnp.asarray(x1), jnp.asarray(x2),
                                           half_t, rb=rb))
    got = _x3_tma_restated(torch.from_numpy(x1), torch.from_numpy(x2),
                           half_t, rb, chunk_rows).numpy()
    t = 2 * half_t + 1
    assert got.shape == ref.shape == (k, k, t, t)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_x3_tma_boxes_fill_a_slot():
    """The four boxes of a slab fill one slot of K1's 108,544 bytes, each
    destination 128-byte aligned; a box's innermost extent is 16 bytes (a
    channel half), as the unswizzled TMA needs, and no box dimension passes
    256."""
    bytes_b = 2 * np.prod(jx.X3_BOX_B)
    bytes_a = 2 * np.prod(jx.X3_BOX_A)
    assert bytes_b == jx._XT_WIN == 36864 and bytes_a == jx._XT_A_HALF
    assert 2 * (bytes_a + bytes_b) == sj._JF_SMEM == 108544
    for off in (0, jx._XT_WIN, jx._XT_A_OFF, jx._XT_A_OFF + jx._XT_A_HALF):
        assert off % 128 == 0
    assert 2 * jx.X3_BOX_A[0] == 2 * jx.X3_BOX_B[0] == 16
    assert max(jx.X3_BOX_A + jx.X3_BOX_B) <= 256
