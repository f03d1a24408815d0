"""The port's experiment-tool kernels X7 (bf16 joint forward on K1's
kernel), X8 (bf16 input gradient) and X9 (fused dx1 + dx2 with each
per-displacement partial rounded to bf16), as their plain versions on the
CPU, and the port's ``v8`` and ``v7`` tool runs, against the JAX package's
``tools/joint_kernel_exp.py``, whose Pallas kernels run in interpret mode
on the CPU. Inputs are numpy-seeded softmax maps fed to both. The CUDA
kernels themselves are tested on the card by tests/test_torch_cuda.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iic_tpu_torch.ops.kernels import joint_exp as jx
from iic_tpu_torch.ops.kernels import seg_joint as sj
from iic_tpu_torch.tools import joint_kernel_exp as tool
from test_torch_joint_exp import _softmax_maps, jax_tool

SIZES = [(2, 5, 16, 3), (2, 7, 16, 10)]  # n, k, h, half_t
# (size, rb) with half_t <= rb, as the TPU tool asserts
V8_CASES = [(SIZES[0], 4), (SIZES[0], 8), (SIZES[0], 16), (SIZES[1], 16)]
# X9 against v7: mean |d| / mean |ref| and max |d| / max |ref|
V7_MEAN, V7_MAX = 1e-5, 2e-3


def _inputs(n, k, h, half_t, seed=0):
    rng = np.random.default_rng(seed + 10 * k + half_t)
    x1, x2 = _softmax_maps(rng, n, k, h, h), _softmax_maps(rng, n, k, h, h)
    t = 2 * half_t + 1
    g = rng.standard_normal((k, k, t, t)).astype(np.float32)
    return x1, x2, g


def _mean_max(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.abs(got - ref)
    return d.mean() / np.abs(ref).mean(), d.max() / np.abs(ref).max()


@pytest.mark.parametrize("size,rb", V8_CASES)
def test_plain_v8_fwd_matches_jax_tool(size, rb):
    """Plain X7 vs the TPU tool's ``joint_fwd_v8``: both round x1 and x2 to
    bf16 and sum exact f32 products, only in another order: atol
    1e-5 * max |P| (measured 6.5e-7)."""
    n, k, h, half_t = size
    x1, x2, _ = _inputs(*size)
    ref = np.asarray(jax_tool.joint_fwd_v8(jnp.asarray(x1), jnp.asarray(x2),
                                           half_t, rb=rb))
    got = jx.joint_fwd_v8(torch.from_numpy(x1), torch.from_numpy(x2), half_t,
                          rb).numpy()
    t = 2 * half_t + 1
    assert got.shape == ref.shape == (k, k, t, t)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("size,rb", V8_CASES)
def test_plain_v8_bwd_matches_jax_tool(size, rb):
    """The plain X8 pair (``bwd_v8`` on the CPU) vs the TPU tool's
    ``bwd_v8``: the same bf16 adjoint and inputs, f32 sums in another
    order: atol 1e-5 * max |dx| (measured 9e-7)."""
    n, k, h, half_t = size
    x1, x2, g = _inputs(*size)
    refs = jax_tool.bwd_v8(jnp.asarray(g), jnp.asarray(x1), jnp.asarray(x2),
                           half_t, rb=rb)
    gots = jx.bwd_v8(*map(torch.from_numpy, (g, x1, x2)), half_t, rb)
    for got, ref in zip(gots, refs):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (n, k, h, h)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module", params=SIZES, ids=str)
def v7_case(request):
    """Inputs and the TPU tool's ``dgrad_fused_v7`` (dx1, dx2) at one
    size, computed once for the tests that hold against it."""
    n, k, h, half_t = request.param
    x1, x2, g = _inputs(*request.param, seed=1)
    ref = jax_tool.dgrad_fused_v7(jnp.asarray(g), jnp.asarray(x1),
                                  jnp.asarray(x2), half_t)
    return (x1, x2, g, half_t), tuple(np.asarray(r) for r in ref)


def test_plain_v7_matches_jax_tool(v7_case):
    """Plain X9 vs the TPU tool's v7, which rounds each per-displacement
    partial to bf16 before summing over v: the two sum the f32 partials in
    another order, so a partial on a rounding boundary may round the other
    way (one bf16 step): mean |d| / mean |ref| <= 1e-5 (measured 1.3e-6),
    max |d| <= 2e-3 max |ref| (measured 7.6e-4)."""
    (x1, x2, g, half_t), refs = v7_case
    gots = jx.dgrad_fused_v7(*map(torch.from_numpy, (g, x1, x2)), half_t)
    for got, ref in zip(gots, refs):
        assert got.shape == ref.shape
        mean, mx = _mean_max(got.numpy(), ref)
        assert mean <= V7_MEAN and mx <= V7_MAX, (mean, mx)


def test_unrounded_pair_fails_the_v7_criterion(v7_case):
    """The X8 pair, which does not round the partials, fails the mean
    criterion against v7 by two orders of magnitude (measured 1.7e-3): the
    criterion sees a lost rounding."""
    (x1, x2, g, half_t), refs = v7_case
    gots = jx.bwd_v8(*map(torch.from_numpy, (g, x1, x2)), half_t)
    for got, ref in zip(gots, refs):
        assert _mean_max(got.numpy(), ref)[0] > 10 * V7_MEAN


def test_plain_v7_is_its_definition():
    """Plain X9 in float64 against its definition written as loops: p_v =
    sum_{u,j} G[(v,i),(u,j)] other[j, y-u+h, x-v+h] (zero outside the
    frame), rounded to bf16 from float64, summed over v. The products of
    bf16 values and their few-term sums are exact in float64."""
    rng = np.random.default_rng(7)
    n, k, h, w, half_t = 1, 2, 5, 6, 2
    t = 2 * half_t + 1
    x1 = torch.from_numpy(rng.random((n, k, h, w)))
    x2 = torch.from_numpy(rng.random((n, k, h, w)))
    g = torch.from_numpy(rng.standard_normal((k, k, t, t)))

    def bf16(a):
        return torch.as_tensor(a).to(torch.bfloat16).double().numpy()

    def rounded_dgrad(g2d, other):
        G, o = bf16(g2d.double()), bf16(other)
        dx = np.zeros((n, k, h, w))
        for v in range(t):
            p = np.zeros((n, k, h, w))
            for i in range(k):
                for y in range(h):
                    for x in range(w):
                        for u in range(t):
                            for j in range(k):
                                yy, xx = y - u + half_t, x - v + half_t
                                if 0 <= yy < h and 0 <= xx < w:
                                    p[0, i, y, x] += (G[v * k + i, u * k + j]
                                                      * o[0, j, yy, xx])
            dx += bf16(p)
        return dx

    g2d, g2d_swap = sj.adjoints(g)
    got = jx.dgrad_fused_v7_plain(g, x1, x2, half_t)
    assert all(d.dtype == torch.float64 for d in got)
    for d, want in zip(got, (rounded_dgrad(g2d, x2),
                             rounded_dgrad(g2d_swap, x1))):
        np.testing.assert_allclose(d.numpy(), want, rtol=1e-12, atol=1e-15)
    unrounded = jx.dgrad_v8_plain(g2d.double(), x2, half_t).numpy()
    assert np.abs(got[0].numpy() - unrounded).max() > 0  # rounding is there


def test_bwd_v8_is_the_vjp_of_the_bf16_joint():
    """The plain X8 pair vs autograd of the plain joint of the bf16-rounded
    inputs for the bf16-rounded cotangent: rtol 1e-4, atol 1e-5 * max
    (summation order)."""
    rng = np.random.default_rng(8)
    half_t = 2
    x1, x2 = (torch.from_numpy(_softmax_maps(rng, 2, 3, 10, 10))
              .bfloat16().float().requires_grad_() for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((3, 3, 5, 5)).astype(np.float32))
    g = g.bfloat16().float()
    ref = torch.autograd.grad((sj.displacement_joint_dense(x1, x2, half_t)
                               * g).sum(), (x1, x2))
    got = jx.bwd_v8(g, x1.detach(), x2.detach(), half_t, 4)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("half_t,rb", [(10, 8), (65, 80), (3, 2)])
def test_wrappers_refuse_what_the_jax_tool_asserts(half_t, rb):
    """2*half_t <= 128 and 2*half_t <= 2*rb for X7 and X8, as the TPU
    tool's ``joint_fwd_v8`` and ``dgrad_v8`` assert; X9's rb is fixed, so it
    refuses only 2*half_t > 128, as ``dgrad_fused_v7`` does."""
    x = np.ones((1, 2, 8, 8), np.float32)
    t = 2 * half_t + 1
    g2d = np.ones((2 * t, 2 * t), np.float32)
    with pytest.raises(AssertionError):
        jax_tool.joint_fwd_v8(jnp.asarray(x), jnp.asarray(x), half_t, rb=rb)
    with pytest.raises(AssertionError):
        jax_tool.dgrad_v8(jnp.asarray(g2d), jnp.asarray(x), half_t, rb=rb)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="2\\*half_t"):
        jx.joint_fwd_v8(xt, xt, half_t, rb)
    with pytest.raises(ValueError, match="2\\*half_t"):
        jx.dgrad_v8(torch.from_numpy(g2d), xt, half_t, rb)
    if 2 * half_t > 128:
        g = np.ones((2, 2, t, t), np.float32)
        with pytest.raises(AssertionError):
            jax_tool.dgrad_fused_v7(jnp.asarray(g), jnp.asarray(x),
                                    jnp.asarray(x), half_t)
        with pytest.raises(ValueError, match="2\\*half_t"):
            jx.dgrad_fused_v7(torch.from_numpy(g), xt, xt, half_t)


def test_wrappers_refuse_what_the_card_cannot_hold():
    """X8's and X9's shared memory must fit a block's 227 KB (the
    arithmetic of csrc/dgrad_common.cuh and csrc/joint_exp_bwd.cu): X8's is
    the (8 + 2h) x (64 + 2h) channels-last patch of 32-byte pixels and two
    adjoint chunks of T tiles of 16 x N bf16, whatever rb; X9's the same
    with one whole patch per j chunk, or X8's slab where those do not fit.
    X8 takes any rb the TPU tool's asserts admit (a block walks its rb rows
    in windows of 8), and past the whole patch's limit its sliced plan keeps
    every h up to 64 in a block's memory; so does X9's, at every k."""
    assert jx.dgrad_v8_smem(15, 10) == 28 * 84 * 32 + 2 * 21 * 16 * 32
    assert jx.dgrad_v8_smem(15, 10) == 96768
    assert jx.dgrad_v8_smem(3, 10) == 28 * 84 * 32 + 2 * 21 * 8 * 32
    assert jx.dgrad_v8_smem(15, 0) == 8 * 16 * 68 * 4 + 2 * 16 * 32
    assert jx.fused_v7_smem(15, 10) == jx.dgrad_v8_smem(15, 10) == 96768
    assert jx.fused_v7_smem(17, 10) == 2 * 28 * 84 * 32 + 2 * 21 * 16 * 32
    x = torch.rand(1, 2, 8, 8)
    g2d = torch.rand(10, 10)
    ref = jx.dgrad_v8(g2d, x, 2, rb=16)
    for rb in (24, 3):
        assert torch.equal(jx.dgrad_v8(g2d, x, 2, rb=rb), ref)
    # k=64, h=10: four whole patches and the chunks would need 323 KB; X9
    # stages each (v, j chunk)'s 64 columns, all 28 patch rows at once
    assert jx.fused_v7_slab(64, 10) == 28
    assert jx.fused_v7_smem(64, 10) == 28 * 64 * 32 + 2 * 21 * 16 * 32
    wide = torch.rand(1, 64, 8, 8)
    got = jx.dgrad_fused_v7(torch.rand(64, 64, 21, 21), wide, wide, 10)
    assert [tuple(d.shape) for d in got] == [(1, 64, 8, 8)] * 2
    # k=64, h=64: the whole patch and the chunks would need 313 KB; slabs
    # of 49 rows x 64 pixels and the chunks take exactly 227 KB
    assert jx.dgrad_v8_slab(64, 64) == 49
    assert jx.dgrad_v8_smem(64, 64) == 49 * 64 * 32 + 2 * 129 * 16 * 32
    assert jx.dgrad_v8_smem(64, 64) == 232448
    assert jx.fused_v7_smem(64, 64) == 232448
    jx.check_dgrad_v8(64, 64, 64)
    jx.check_fused_v7(64, 64)
    with pytest.raises(ValueError):
        jx.dgrad_fused_v7(torch.rand(2, 2, 5, 5), x, x.to("meta"), 2)


@pytest.mark.parametrize("k,whole_up_to", [(3, 24), (8, 24), (9, 22),
                                           (15, 22), (17, 22)])
def test_x8_patch_plan_keeps_every_h(k, whole_up_to):
    """X8 stages the whole patch up to h = 22 at N=16 (k > 8) and h = 24 at
    N=8, and from the next h slabs of each v's 64 columns, as many rows as
    fit: every h the TPU tool admits (2h <= 128) fits a block's 227 KB, and
    the wrapper accepts it (run here on the plain version)."""
    n_cols = 8 if k <= 8 else 16
    for h in range(65):
        slab, smem = jx.dgrad_v8_slab(k, h), jx.dgrad_v8_smem(k, h)
        assert smem <= 232448
        if h <= whole_up_to:
            assert slab == 0
            assert smem == max((8 + 2 * h) * (64 + 2 * h) * 32,
                               8 * n_cols * 68 * 4) + 2 * (2 * h + 1) * (
                                   n_cols * 32)
        else:
            assert 1 <= slab <= 8 + 2 * h
            assert jx._v8_smem(n_cols, h, slab + 1) > 232448 or (
                slab == 8 + 2 * h)
    # the first h past the whole patch: its patch and chunks exceed 227 KB
    h = whole_up_to + 1
    assert ((8 + 2 * h) * (64 + 2 * h) * 32 + 2 * (2 * h + 1) * n_cols * 32
            > 232448)
    rng = np.random.default_rng(k)
    t = 2 * h + 1
    other = torch.from_numpy(rng.random((1, k, 6, 5)).astype(np.float32))
    g2d = torch.from_numpy(rng.standard_normal((k * t, k * t))
                           .astype(np.float32))
    got = jx.dgrad_v8(g2d, other, h, rb=h)
    ref = jx.dgrad_v8_plain(g2d, other, h)
    assert torch.equal(got, ref)


def _v8_gemm(g2d, other, half_t):
    """X8's index algebra restated in plain PyTorch from the operands in the
    layouts its kernel reads (``dgrad_v8_operands``): channels-last with j
    padded to 16, the adjoint in (i chunk, j chunk, v, u) tiles of 16 x N
    (N padded), decoded from wgmma's core-matrix layout, and one GEMM step
    (pixels x 16) @ (16 x N) per displacement (u, v) and chunk pair."""
    n, k, h, w = other.shape
    gc, oc = jx.dgrad_v8_operands(g2d, other, half_t)
    ic, jc, t = gc.shape[:3]
    n_cols = 8 * gc.shape[5]
    assert gc.shape == (ic, jc, t, t, 2, n_cols // 8, 8, 8)
    assert oc.shape == (n, jc, h, w, 16) and n_cols in (8, 16)
    # [ic, jc, v, u, jg, ig, ir, jr] -> B[ic, jc, v, u][j, i]
    b = (gc.float().permute(0, 1, 2, 3, 4, 7, 5, 6)
         .reshape(ic, jc, t, t, 16, n_cols))
    # A(u, v)[n, y, x, j] = other[n, j, y - u + h, x - v + h], zero outside
    op = torch.nn.functional.pad(oc.float(), (0, 0) + (half_t, half_t) * 2)
    dx = torch.zeros(n, ic * n_cols, h, w)
    d = 2 * half_t
    for c in range(ic):
        for j in range(jc):
            for v in range(t):
                for u in range(t):
                    a = op[:, j, d - u:d - u + h, d - v:d - v + w]
                    dx[:, c * n_cols:(c + 1) * n_cols] += (
                        (a.reshape(-1, 16) @ b[c, j, v, u])
                        .reshape(n, h, w, n_cols).permute(0, 3, 1, 2))
    return dx[:, :k]


@pytest.mark.parametrize("n,k,h,w,half_t", [
    (2, 3, 12, 70, 2), (1, 15, 10, 9, 0), (2, 15, 9, 66, 2),
    (1, 17, 8, 20, 1), (2, 7, 16, 16, 10)])
def test_v8_gemm_restatement(n, k, h, w, half_t):
    """The restated GEMM vs plain X8 and the TPU tool's ``dgrad_v8``
    (interpret mode): the same bf16 adjoint and input, exact products, f32
    sums in another order: atol 1e-5 * max |dx|. Covers N = 8 (k=3, 7) and
    16 (k=15), two chunks of i and j (k=17), half_t 0, 1, 2 and 10, and
    w not a multiple of 64."""
    rng = np.random.default_rng(n + k + w + half_t)
    t = 2 * half_t + 1
    other = rng.random((n, k, h, w)).astype(np.float32)
    g2d = rng.standard_normal((k * t, k * t)).astype(np.float32)
    got = _v8_gemm(torch.from_numpy(g2d), torch.from_numpy(other), half_t)
    refs = (jx.dgrad_v8_plain(torch.from_numpy(g2d), torch.from_numpy(other),
                              half_t).numpy(),
            np.asarray(jax_tool.dgrad_v8(jnp.asarray(g2d), jnp.asarray(other),
                                         half_t, rb=max(half_t, 1))))
    for ref in refs:
        assert ref.shape == got.shape == (n, k, h, w)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def _v9_order(g, x1, x2, half_t):
    """X9's loop order restated in plain PyTorch on the operands in X8's
    layouts (``seg_joint.dgrad_v8_operands``) for each output (dx1: the
    adjoint and x2; dx2: the swapped adjoint and x1): for each v, p_v sums
    one (pixels x 16) @ (16 x N) step per j chunk and then per u
    descending, in f32, and dx adds bf16(p_v) in v order. X9 takes N = 16
    at every k."""
    outs = []
    for g2d, other in zip(sj.adjoints(g), (x2, x1)):
        n, k, h, w = other.shape
        gc, oc = sj.dgrad_v8_operands(g2d, other, half_t, 16)
        ic, jc, t = gc.shape[:3]
        n_cols = 8 * gc.shape[5]
        b = (gc.float().permute(0, 1, 2, 3, 4, 7, 5, 6)
             .reshape(ic, jc, t, t, 16, n_cols))
        op = torch.nn.functional.pad(oc.float(),
                                     (0, 0) + (half_t, half_t) * 2)
        d = 2 * half_t
        dx = torch.zeros(n, ic * n_cols, h, w)
        for c in range(ic):
            for v in range(t):
                p = torch.zeros(n, h, w, n_cols)
                for j in range(jc):
                    for u in reversed(range(t)):
                        a = op[:, j, d - u:d - u + h, d - v:d - v + w]
                        p += (a.reshape(-1, 16) @ b[c, j, v, u]).reshape(
                            n, h, w, n_cols)
                dx[:, c * n_cols:(c + 1) * n_cols] += (
                    p.bfloat16().float().permute(0, 3, 1, 2))
        outs.append(dx[:, :k])
    return tuple(outs)


@pytest.mark.parametrize("n,k,h,w,half_t", [
    (2, 3, 12, 20, 2), (1, 15, 10, 9, 1), (2, 17, 8, 20, 2),
    (1, 33, 6, 7, 1)])
def test_v9_order_restatement(n, k, h, w, half_t):
    """X9's order (v, then j chunk, then u, bf16 of each p_v) over the
    laid-out operands vs plain X9: the same bf16 operands and exact
    products, each p_v summed in another f32 order before it is rounded,
    so the v7 criterion (mean <= 1e-5, max <= 2e-3 of max). Covers i and j
    padded from 3 to 16 (k=3), one j chunk (k <= 16), two (k=17, where the
    v-outer order differs from X8's) and three (k=33)."""
    rng = np.random.default_rng(n + k + w + half_t)
    x1, x2 = (_softmax_maps(rng, n, k, h, w) for _ in range(2))
    t = 2 * half_t + 1
    g = rng.standard_normal((k, k, t, t)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (g, x1, x2)]
    gots = _v9_order(*args, half_t)
    refs = jx.dgrad_fused_v7_plain(*args, half_t)
    for got, ref in zip(gots, refs):
        assert got.shape == ref.shape == (n, k, h, w)
        mean, mx = _mean_max(got.numpy(), ref.numpy())
        assert mean <= V7_MEAN and mx <= V7_MAX, (mean, mx)


def test_v9_order_matches_jax_tool(v7_case):
    """The restated X9 order vs the TPU tool's ``dgrad_fused_v7`` (interpret
    mode), by the v7 criterion."""
    (x1, x2, g, half_t), refs = v7_case
    gots = _v9_order(*map(torch.from_numpy, (g, x1, x2)), half_t)
    for got, ref in zip(gots, refs):
        mean, mx = _mean_max(got.numpy(), ref)
        assert mean <= V7_MEAN and mx <= V7_MAX, (mean, mx)


@pytest.mark.parametrize("k,n_cols", [(1, None), (3, None), (8, None),
                                      (9, None), (15, None), (16, None),
                                      (17, None), (33, None), (3, 16),
                                      (8, 16)])
def test_v8_operands_gather_back(k, n_cols):
    """``seg_joint.dgrad_v8_operands`` (K2's and X8's operands, N = 8 at
    k <= 8 and 16 above; X9's, N = 16 at every k) gathers back to G and
    ``other`` rounded to bf16, with zeros past k: tile (ic, jc, v, u)[j, i]
    = G[(v, N ic + i), (u, 16 jc + j)] through wgmma's core matrices, and
    oc[n, jc, y, x, c] = other[n, 16 jc + c, y, x]."""
    rng = np.random.default_rng(k)
    n, h, w, half_t = 2, 5, 7, 2
    t = 2 * half_t + 1
    other = torch.from_numpy(rng.random((n, k, h, w)).astype(np.float32))
    g2d = torch.from_numpy(rng.standard_normal((k * t, k * t))
                           .astype(np.float32))
    gc, oc = sj.dgrad_v8_operands(g2d, other, half_t, n_cols)
    assert gc.dtype == oc.dtype == torch.bfloat16
    n_cols = n_cols or (8 if k <= 8 else 16)
    ic, jc = -(-k // n_cols), -(-k // 16)
    assert gc.shape == (ic, jc, t, t, 2, n_cols // 8, 8, 8)
    assert oc.shape == (n, jc, h, w, 16)
    # core matrix (i/8, j/8) of each tile: its row is i % 8, its 8 bf16 j % 8
    tiles = gc.permute(0, 1, 2, 3, 5, 6, 4, 7).reshape(ic, jc, t, t, n_cols,
                                                      16)  # [.., i, j]
    g = tiles.permute(2, 0, 4, 3, 1, 5).reshape(t, ic * n_cols, t, jc * 16)
    want = g2d.bfloat16().reshape(t, k, t, k)  # [v, i, u, j]
    assert torch.equal(g[:, :k, :, :k], want)
    assert not g[:, k:].any() and not g[:, :, :, k:].any()
    o = oc.permute(0, 1, 4, 2, 3).reshape(n, jc * 16, h, w)
    assert torch.equal(o[:, :k], other.bfloat16())
    assert not o[:, k:].any()


@pytest.mark.parametrize("k", [3, 15, 17, 33, 64])
def test_x9_patch_plan_keeps_every_h(k):
    """X9 (N = 16 at every k) keeps every j chunk's whole patch while they
    fit beside the two adjoint chunks, else slabs of each (v, j chunk)'s 64
    columns, as many rows as fit: every k and every h the TPU tool admits
    (2h <= 128) fits a block's 227 KB."""
    n_cols, jchunks = 16, -(-k // 16)
    for h in range(65):
        slab, smem = jx.fused_v7_slab(k, h), jx.fused_v7_smem(k, h)
        assert smem <= 232448
        whole = (max(jchunks * (8 + 2 * h) * (64 + 2 * h) * 32,
                     8 * n_cols * 68 * 4) + 2 * (2 * h + 1) * n_cols * 32)
        if whole <= 232448:
            assert slab == 0 and smem == whole
        else:
            assert 1 <= slab <= 8 + 2 * h
            assert smem == jx._v8_smem(n_cols, h, slab)
            assert (slab == 8 + 2 * h
                    or jx._v8_smem(n_cols, h, slab + 1) > 232448)
        jx.check_fused_v7(k, h)
    if 8 < k <= 16:  # one j chunk at X8's N: X9's plan is X8's
        assert all(jx.fused_v7_smem(k, h) == jx.dgrad_v8_smem(k, h)
                   for h in range(65))


def test_cpu_wrappers_use_plain_and_count_no_launch():
    jx.reset_launch_counts()
    x = torch.rand(2, 3, 8, 8)
    g = torch.rand(3, 3, 5, 5)
    jx.joint_fwd_v8(x, x, 2, 4)
    jx.bwd_v8(g, x, x, 2, 8)
    jx.dgrad_fused_v7(g, x, x, 2)
    assert set(jx.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("run,variants", [("v8", 6), ("v7", 2)])
def test_tool_backward_runs_on_cpu(capsys, run, variants):
    """The port's ``v8`` and ``v7`` runs end to end at a tiny size on the
    plain versions: every variant reports, none FAILED, every time and
    error is finite; the bf16 variants are within bf16 rounding of the
    float64 reference, K2 within f32 rounding, and X9 within 1e-5 in the
    mean of its own plain version in float64."""
    records = tool.main([run, *map(str, SIZES[1])], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith(f"joint_kernel_exp {run}: ") \
        and out[0].endswith("cpu")
    assert len(out) == 1 + len(records) == 1 + variants, out
    for rec, line in zip(records, out[1:]):
        assert rec["failed"] is None and line.startswith(rec["name"]), line
        assert math.isfinite(rec["ms"]) and rec["errs"], rec
        for label, err in rec["errs"].items():
            assert math.isfinite(err), rec
            if "mean err vs v7 plain" in label:
                assert err <= V7_MEAN, rec
            elif rec["name"].startswith("V"):
                assert err < 1e-2, rec  # bf16 rounding (about 2e-3)
            else:
                assert err < 1e-5, rec  # f32 rounding
