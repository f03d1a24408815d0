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


def _single_walk(rows):
    """X3's tensor-core loop (csrc/joint_exp_tma.cu joint_fwd_tma_kernel)
    over one chunk's slabs of ``rows`` rows each, as the steps thread 0
    meets: ("load", slot, slab), ("wait_full", slot, parity), ("row", slot,
    slab, row), ("wait_empty", slot, parity), ("arrive", slot). Slab i
    uses slot i % 2 at parity (i // 2) % 2; its first row triggers the
    load of slab i + 1, after slab i - 1 has left that slot."""
    ev = [("load", 0, 0)] if rows else []
    for i, nr in enumerate(rows):
        slot = i & 1
        ev.append(("wait_full", slot, (i >> 1) & 1))
        for ry in range(nr):
            ev.append(("row", slot, i, ry))
            if ry == 0 and i + 1 < len(rows):
                if i > 0:
                    ev.append(("wait_empty", slot ^ 1, ((i - 1) >> 1) & 1))
                ev.append(("load", slot ^ 1, i + 1))
        ev.append(("arrive", slot))
    return ev


def _branch_walk(rows):
    """X4's tensor-core loop (joint_fwd_tma_branch_kernel) in the same
    steps: X3's prologue and phases, with the slot picked by a branch on
    the slab's parity. The even branch waits on full[0] at parity (i // 2)
    % 2 and, from slab 2 on, refills slot 1 once slab i - 1 has left it
    (parity ((i - 1) // 2) % 2, the other of the two); the odd branch waits
    on full[1] and refills slot 0 once slab i - 1 has (the same parity)."""
    ev = [("load", 0, 0)] if rows else []
    for i, nr in enumerate(rows):
        par = (i >> 1) & 1
        slot = i & 1  # the branch taken: its slot and barriers are fixed
        ev.append(("wait_full", slot, par))
        for ry in range(nr):
            ev.append(("row", slot, i, ry))
            if ry == 0 and i + 1 < len(rows):
                if slot == 0 and i > 0:
                    ev.append(("wait_empty", 1, par ^ 1))
                elif slot == 1:
                    ev.append(("wait_empty", 0, par))
                ev.append(("load", slot ^ 1, i + 1))
        ev.append(("arrive", slot))
    return ev


def _pair_walk(rows):
    """X5's tensor-core loop (joint_fwd_tma_pair_kernel) in the same
    steps: the prologue loads slabs 0 and 1; iteration m takes slab 2m from
    slot 0 and slab 2m + 1 from slot 1, both at parity m % 2, and skips the
    odd slab where the count is odd. Slab 2m's first row loads slab 2m + 1
    into slot 1 (from m = 1 on, after slab 2m - 1), slab 2m + 1's first row
    slab 2m + 2 into slot 0 (after slab 2m)."""
    n = len(rows)
    ev = [("load", sl, sl) for sl in range(min(n, 2))]
    for m in range((n + 1) // 2):
        par = m & 1
        for sl in range(2):
            i = 2 * m + sl
            if i >= n:
                break
            ev.append(("wait_full", sl, par))
            for ry in range(rows[i]):
                ev.append(("row", sl, i, ry))
                if ry == 0 and sl == 0 and m > 0 and i + 1 < n:
                    ev += [("wait_empty", 1, par ^ 1), ("load", 1, i + 1)]
                if ry == 0 and sl == 1 and i + 1 < n:
                    ev += [("wait_empty", 0, par), ("load", 0, i + 1)]
            ev.append(("arrive", sl))
    return ev


def _barrier_model(ev, n):
    """Runs a walk's steps against two slots' mbarriers, each load
    completing as it is issued and every arrival of a slab at once:
    yields the loads and rows, and fails where the kernel would hang (a
    wait on a phase that has not completed), read a slot before its slab
    landed or after it was overwritten, overwrite a slab still to be
    read, or end with a load in flight or a slab not multiplied once, in
    order."""
    full, empty, loads = [0, 0], [0, 0], [0, 0]
    content, ready = [None, None], [False, False]
    done = []
    for e in ev:
        op, sl = e[0], e[1]
        if op == "load":
            assert empty[sl] == loads[sl], f"slot {sl} overwritten early"
            content[sl] = e[2]
            loads[sl] += 1
            full[sl] += 1
            yield e
        elif op == "wait_full":
            # passes only on the phase just completed: the latest load
            assert full[sl] == empty[sl] + 1 and (full[sl] - 1) & 1 == e[2], \
                f"wait on full[{sl}] parity {e[2]} at {full[sl]} phases"
            ready[sl] = True
        elif op == "row":
            assert ready[sl] and content[sl] == e[2], e
            if e[3] == 0:
                done.append(e[2])
            yield e
        elif op == "wait_empty":
            assert empty[sl] == loads[sl] and (empty[sl] - 1) & 1 == e[2], \
                f"wait on empty[{sl}] parity {e[2]} at {empty[sl]} phases"
        else:
            empty[sl] += 1
            ready[sl] = False
    assert loads == empty and done == list(range(n)), (loads, empty, done)


@pytest.mark.parametrize("slabs", range(8))
def test_tma_walks_keep_their_mbarrier_phases(slabs):
    """X3's, X4's and X5's loops over 0-7 slabs a chunk (ragged rows):
    every wait finds its phase completed, no slot is read before its slab
    lands or overwritten before it is read, every slab is multiplied once
    and in order, and no load is left in flight; X4 and X5 multiply X3's
    rows in X3's order (so the same sums), and X4's branches take X3's
    steps exactly."""
    rows = [16 - 5 * (i % 3) for i in range(slabs)]
    got = {}
    for name, walk in (("x3", _single_walk), ("x4", _branch_walk),
                       ("x5", _pair_walk)):
        got[name] = [e[2:] for e in _barrier_model(walk(rows), slabs)
                     if e[0] == "row"]
    assert got["x5"] == got["x4"] == got["x3"] == [
        (i, r) for i in range(slabs) for r in range(rows[i])]
    assert _branch_walk(rows) == _single_walk(rows)


_LANE = torch.arange(32)


def _a_lanes(shift):
    """Byte offset, from an x1 row of a slot, of lane l's ldmatrix.trans
    row: pixel shift + (l & 7) + 8 (l >> 4), channel half (l >> 3) & 1."""
    return (jx._XT_A_OFF + ((_LANE >> 3) & 1) * jx._XT_A_HALF
            + (shift + (_LANE & 7) + 8 * (_LANE >> 4)) * 16)


def _tail_lanes():
    """roll_build's tail: pixel 64 + (l & 3) of channel half (l >> 3) & 1
    (lanes 0-15 address ldmatrix.x2's two matrices)."""
    return (jx._XT_A_OFF + ((_LANE >> 3) & 1) * jx._XT_A_HALF
            + (sj._JF_PIX + (_LANE & 3)) * 16)


def _ldmatrix_trans(bits, addr, m=4):
    """ldmatrix.x{m}.trans over a slot's bf16 bit patterns ``bits``, lane l
    of matrix i = l // 8 giving row l % 8's byte address addr[..., l]:
    lane t receives stored rows 2 (t % 4) and + 1 at column t // 4, the
    first in the low half. Returns (..., 32, m) registers."""
    rows = bits[addr[..., :8 * m, None] // 2 + torch.arange(8)]
    rows = rows.unflatten(-2, (m, 8))  # [..., matrix, row, column]
    q, col = _LANE % 4, _LANE // 4
    return (rows[..., 2 * q, col] | rows[..., 2 * q + 1, col] << 16
            ).transpose(-1, -2)


def _roll(f, g, w):
    """xt_roll: warp w's A registers from the v0 fragment f (..., 32, 4)
    of a k16 step and g (..., 32, 2), the first two registers of the next
    pixels' fragment. Lane q of a quad reads pixel pair q + w // 2 + d (d =
    0, 1) from lane (q + w // 2 + d) % 4, which sends the register after
    its own (f[c] -> f[c + 2] -> g[c]) when its q < w // 2 + d; an odd w
    then keeps the first pair's high pixel and the second's low one
    (prmt)."""
    w = torch.as_tensor(w)[..., None]
    q = _LANE & 3
    shape = torch.broadcast_shapes(f.shape[:-1], (q + w).shape)
    f, g = f.expand(*shape, 4), g.expand(*shape, 2)

    def pair(d):
        src = ((_LANE & -4) | ((q + (w >> 1) + d) & 3)).expand(shape)
        nxt = q < (w >> 1) + d  # the sender's choice, for its one reader
        lo, hi = [], []
        for c in range(2):
            lo.append(torch.gather(torch.where(nxt, f[..., c + 2],
                                               f[..., c]), -1, src))
            hi.append(torch.gather(torch.where(nxt, g[..., c],
                                               f[..., c + 2]), -1, src))
        return lo + hi  # registers 0-3: (lo, half 0), (lo, half 1), (hi, ...)
    first, second = pair(0), pair(1)
    odd = (w & 1).bool()
    return torch.stack([torch.where(odd, (a >> 16) | ((b & 0xFFFF) << 16), a)
                        for a, b in zip(first, second)], -1)


def _row_fragments(bits, row, roll):
    """The A registers (4 steps, 4 warps, 32 lanes, 4) of slot row ``row``:
    ldmatrix.trans at each warp's shift, or (roll) v0's fragments rolled
    by each warp's shift, the last step patched from the tail."""
    base = row * jx._XT_A_ROW + 256 * torch.arange(sj._JF_PIX // 16)
    if not roll:
        lanes = torch.stack([_a_lanes(v) for v in range(sj._JF_V)])
        return _ldmatrix_trans(bits, base[:, None, None] + lanes)
    f = _ldmatrix_trans(bits, base[:, None] + _a_lanes(0))  # (4, 32, 4)
    tail = _ldmatrix_trans(bits, row * jx._XT_A_ROW + _tail_lanes(), 2)
    g = torch.cat([f[1:, :, :2], tail[None]])                # (4, 32, 2)
    return _roll(f[:, None], g[:, None], torch.arange(4))


# A register (warp w, lane l, register r, half e) -> A[16 w + l / 4 +
# 8 (r & 1)][2 (l % 4) + 8 (r >> 1) + e] (hopper_mma.cuh)
_W, _L, _R, _E = torch.meshgrid(torch.arange(4), _LANE, torch.arange(4),
                                torch.arange(2), indexing="ij")
_A_ROWS = 16 * _W + _L // 4 + 8 * (_R & 1)
_A_COLS = 2 * (_L % 4) + 8 * (_R >> 1) + _E


def _fragments_to_a(regs):
    """(..., 4, 32, 4) registers -> (..., 64, 16) f32 A tiles."""
    halves = torch.stack([regs & 0xFFFF, regs >> 16], -1)
    a = torch.zeros(*regs.shape[:-3], 64, 16, dtype=torch.int64)
    a[..., _A_ROWS, _A_COLS] = halves
    return a.to(torch.int16).view(torch.bfloat16).float()


def _tma_restated(x1, x2, half_t, rb=16, chunk_rows=sj.K1_CHUNK_ROWS,
                  walk=_single_walk, roll=False):
    """The tensor-core forms of X3 (``walk`` ``_single_walk``), X4
    (``_branch_walk``) and X5 / X6 (``_pair_walk``; csrc/joint_exp_tma.cu)
    restated in plain PyTorch from the boxes their TMA loads bring: for
    each block (N tile, M tile, chunk of ``sj.k1_plan``), K1's slab walk as
    the kernel's loop runs it (``walk``, through ``_barrier_model``), each
    load a slot built from the four boxes of ``jx.X3_BOX_B`` (x2 window at
    (q0, wy - h + up0)) and ``jx.X3_BOX_A`` (x1 rows at (q0 + v0 - h,
    wy)), each channel half at channel 0 or 8, over the tensor maps (16, w,
    h, n chunks) of the channels-last chunks (X6: of the f32 inputs,
    rounded by the layout pass), zero outside; A from the registers
    ldmatrix.trans fills at the [half][row][68 pixels][8] rows (``roll``:
    X6's roll_build, v0's registers rolled by each warp's shift, checked
    equal to the plain registers), B at the core matrices of warpgroup g's
    descriptor (start: half g's window, row r; LBO 128 bytes along K, SBO
    one window row along N), one (64 x 16) @ (16 x 168) product per
    warpgroup, row and k16 step; column 8 c + jj of warpgroup g stored at
    u' = up0 + c, j = 16 jc + 8 g + jj, u = T - 1 - u'; the partials added
    in chunk order."""
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    tk = k * t
    nu, cm = sj._JF_U, sj._JF_CM
    x1v = sj.channels_last_chunks(x1).float().flatten(0, 1)
    x2v = sj.channels_last_chunks(x2).float().flatten(0, 1)
    chunks = -(-k // sj._JF_CH)
    m_tiles, n_tiles = -(-t // sj._JF_V), -(-t // nu)
    per, splits = sj.k1_plan(n, k, h, half_t, rb, chunk_rows)
    buf_bytes = jx._XT_A_OFF + 2 * jx._XT_A_HALF
    assert buf_bytes == sj._JF_SMEM  # K1's buffer, rearranged

    # byte offsets of B[kq][col] from a warpgroup's descriptor start
    kq, col = torch.meshgrid(torch.arange(16), torch.arange(8 * cm),
                             indexing="ij")
    row_b = sj._JF_PIX * 16  # one window row of one half: also the SBO
    b_off = (col // 8) * row_b + (kq // 8) * 128 + (kq % 8) * 16 \
        + 2 * (col % 8)

    part = torch.zeros(splits, tk, tk)
    by_chunk = [[] for _ in range(splits)]
    for slab in k1_slabs(n, h, w, rb, chunk_rows, half_t, k):
        by_chunk[slab[0]].append(slab[1:])
    for bx in range(chunks * n_tiles):
        jc, up0 = bx // n_tiles, (bx % n_tiles) * nu
        for by in range(chunks * m_tiles):
            ic, v0 = by // m_tiles, (by % m_tiles) * sj._JF_V
            acc = torch.zeros(splits, 2, 64, 8 * cm)
            for z, slabs in enumerate(by_chunk):
                slots = [None, None]
                rows = [sl[2] for sl in slabs]
                for ev in _barrier_model(walk(rows), len(slabs)):
                    img, wy, _, q0, steps = slabs[ev[2]]
                    if ev[0] == "load":
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
                        bits = (slot.to(torch.bfloat16).view(torch.int16)
                                .to(torch.int64) & 0xFFFF)
                        slots[ev[1]] = (slot, bits)
                        continue
                    slot, bits = slots[ev[1]]
                    ry = ev[3]
                    regs = _row_fragments(bits, ry, roll)
                    if roll:
                        assert torch.equal(regs,
                                           _row_fragments(bits, ry, False))
                    a_tiles = _fragments_to_a(regs)
                    for st in range(steps):
                        for g in range(2):
                            b = slot[(g * jx._XT_WIN + ry * row_b + 256 * st
                                      + b_off) // 2]
                            acc[z, g] += a_tiles[st] @ b
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


def _x3_tma_restated(x1, x2, half_t, rb=16, chunk_rows=sj.K1_CHUNK_ROWS):
    """X3's tensor-core form restated (``_tma_restated``, X3's walk)."""
    return _tma_restated(x1, x2, half_t, rb, chunk_rows)


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


# X3's restatement shapes, and one whose chunks walk 3 and 1 slabs (the
# second from the middle of an image), at ragged h and w
X5_SHAPES = [(2, 5, 20, 70, 1, 16, 128), (1, 17, 9, 20, 10, 16, 128),
             (2, 5, 18, 33, 10, 32, 16), (1, 17, 12, 66, 1, 16, 16),
             (2, 5, 20, 40, 3, 16, 48)]


def test_x5_shapes_walk_odd_and_even_slab_counts():
    """The X5 shapes give chunks of 1, 2, 3 and 8 slabs, one chunk starting
    in the middle of an image."""
    counts, mid = set(), False
    for n, k, h, w, half_t, rb, chunk_rows in X5_SHAPES:
        slabs = list(k1_slabs(n, h, w, rb, chunk_rows, half_t, k))
        firsts = {}
        for z, img, wy, *_ in slabs:
            firsts.setdefault(z, wy)
        counts |= {sum(s[0] == z for s in slabs) for z in firsts}
        mid |= any(wy > 0 for wy in firsts.values())
    assert {1, 2, 3, 8} <= counts and mid


@pytest.mark.parametrize("n,k,h,w,half_t,rb,chunk_rows", X5_SHAPES)
def test_x5_tma_restatement_matches_jax_v5(n, k, h, w, half_t, rb,
                                           chunk_rows):
    """X5's tensor-core form restated (``_tma_restated`` over X5's walk:
    two slabs an iteration from static slots, the absent odd slab skipped)
    vs the TPU tool's ``joint_fwd_v5`` (interpret mode): atol 1e-5 * max.
    It also equals X3's restatement bit for bit: the same products in the
    same order, as on the card."""
    rng = np.random.default_rng(7 * k + w)
    x1, x2 = (_softmax_maps(rng, n, k, h, w) for _ in range(2))
    ref = np.asarray(jax_tool.joint_fwd_v5(jnp.asarray(x1), jnp.asarray(x2),
                                           half_t, rb=rb))
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    got = _tma_restated(t1, t2, half_t, rb, chunk_rows, walk=_pair_walk)
    t = 2 * half_t + 1
    assert got.shape == ref.shape == (k, k, t, t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert torch.equal(got, _x3_tma_restated(t1, t2, half_t, rb, chunk_rows))


@pytest.mark.parametrize("n,k,h,w,half_t,rb,chunk_rows", X5_SHAPES)
def test_x4_tma_restatement_matches_jax_v4(n, k, h, w, half_t, rb,
                                           chunk_rows):
    """X4's tensor-core form restated (``_tma_restated`` over X4's walk:
    one slab an iteration, the slot picked by a branch on its parity) vs
    the TPU tool's ``joint_fwd_v4`` (interpret mode): atol 1e-5 * max, at
    chunks of 1, 2, 3 and 8 slabs. It also equals X3's restatement bit for
    bit: the same products in the same order, as on the card."""
    rng = np.random.default_rng(3 * k + w)
    x1, x2 = (_softmax_maps(rng, n, k, h, w) for _ in range(2))
    ref = np.asarray(jax_tool.joint_fwd_v4(jnp.asarray(x1), jnp.asarray(x2),
                                           half_t, rb=rb))
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    got = _tma_restated(t1, t2, half_t, rb, chunk_rows, walk=_branch_walk)
    t = 2 * half_t + 1
    assert got.shape == ref.shape == (k, k, t, t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert torch.equal(got, _x3_tma_restated(t1, t2, half_t, rb, chunk_rows))


# X6's rb is 16: one slab a chunk, two with one starting mid-image, and
# ragged ones
X6_SHAPES = [(1, 17, 9, 20, 10, 128), (2, 5, 20, 40, 3, 48),
             (1, 5, 12, 66, 1, 16)]


@pytest.mark.parametrize("n,k,h,w,half_t,chunk_rows", X6_SHAPES)
def test_x6_tma_restatement_matches_jax_v6(n, k, h, w, half_t, chunk_rows):
    """X6's tensor-core form restated: K1's layout pass on the f32 inputs
    (``channels_last_chunks``: bf16, nearest even), then X5's walk, vs the
    TPU tool's ``joint_fwd_v6(roll_build=False)`` (interpret mode): atol
    1e-5 * max."""
    rng = np.random.default_rng(5 * k + w)
    x1, x2 = (_softmax_maps(rng, n, k, h, w) for _ in range(2))
    ref = np.asarray(jax_tool.joint_fwd_v6(jnp.asarray(x1), jnp.asarray(x2),
                                           half_t, roll_build=False))
    got = _tma_restated(torch.from_numpy(x1), torch.from_numpy(x2), half_t,
                        16, chunk_rows, walk=_pair_walk).numpy()
    t = 2 * half_t + 1
    assert got.shape == ref.shape == (k, k, t, t)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n,k,h,w,half_t,chunk_rows", X6_SHAPES)
def test_x6_roll_restatement_equals_plain_fragments(n, k, h, w, half_t,
                                                    chunk_rows):
    """X6's roll_build restated: every warp's A registers rolled from v0's
    (quad shuffles of this step's registers and the next step's or the
    tail's, prmt for odd shifts) equal, register for register
    (``torch.equal``, inside ``_tma_restated``), those ldmatrix.trans reads
    at the warp's own shift, at every row and step of every slab of every
    block; so the joint equals roll_build=False bit for bit. (The TPU
    tool's roll_build raises under this JAX, so the restatement is held to
    roll_build=False.)"""
    rng = np.random.default_rng(5 * k + w)
    x1, x2 = (torch.from_numpy(_softmax_maps(rng, n, k, h, w))
              for _ in range(2))
    rolled = _tma_restated(x1, x2, half_t, 16, chunk_rows, walk=_pair_walk,
                           roll=True)
    assert torch.equal(rolled, _tma_restated(x1, x2, half_t, 16, chunk_rows,
                                             walk=_pair_walk))


def test_roll_covers_every_shift_and_the_tail():
    """The roll on a slot of distinct bit patterns: warp w's registers are
    ldmatrix.trans's at shift w for w = 0-3 at every step, the last step's
    pixels 64-66 coming from the tail; a roll that drops the tail patch or
    takes the low pixel for an odd shift differs."""
    bits = torch.arange(sj._JF_SMEM // 2, dtype=torch.int64) % 65521
    for row in (0, 15):
        rolled = _row_fragments(bits, row, True)
        plain = _row_fragments(bits, row, False)
        assert torch.equal(rolled, plain)
        # a warp's registers of a step hold 256 distinct elements
        assert all(len(torch.unique(plain[st, w])) == 128
                   for st in range(4) for w in range(4))
    base = 256 * torch.arange(4)
    f = _ldmatrix_trans(bits, base[:, None] + _a_lanes(0))
    no_tail = torch.cat([f[1:, :, :2], torch.zeros(1, 32, 2,
                                                   dtype=torch.int64)])
    assert not torch.equal(_roll(f[:, None], no_tail[:, None],
                                 torch.arange(4)), plain)
    even_only = _roll(f[:, None], no_tail[:, None], torch.arange(4) & 2)
    assert not torch.equal(even_only[:, 1::2], plain[:, 1::2])


@pytest.mark.parametrize("name,kw", [("joint_fwd_v4", {"rb": 16}),
                                     ("joint_fwd_v5", {"rb": 16}),
                                     ("joint_fwd_v6", {"roll_build": True}),
                                     ("joint_fwd_v6", {})])
def test_x5_x6_form_argument(name, kw):
    """X4, X5 and X6 take ``form`` in X_FORMS, as X3 does, and refuse anything
    else on every device; on CPU tensors every form returns the plain
    version and counts no launch; the TPU tool's asserts hold in both
    forms."""
    fn = getattr(jx, name)
    x = torch.rand(1, 2, 8, 8)
    with pytest.raises(ValueError, match="form"):
        fn(x, x, 2, form="cudnn", **kw)
    jx.reset_launch_counts()
    for form in jx.X_FORMS:
        assert torch.equal(fn(x, x, 2, form=form, **kw),
                           jx.joint_fwd_v2_plain(x, x, 2))
        with pytest.raises(ValueError, match="2\\*half_t"):
            fn(x, x, 65, form=form, **kw)
    assert set(jx.LAUNCHES.values()) == {0}
