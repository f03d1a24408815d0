"""The port's displacement-joint kernels K1 / K2 (iic_tpu_torch/ops/kernels/
seg_joint.py) against the JAX package: the plain versions against JAX's
conv and its Pallas kernels (interpret mode on the CPU) and the SegJoint
backward against jax.grad. Inputs are made from a numpy seed and fed to
both. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu.ops.iid_seg_loss import displacement_joint_dense as jax_dense
from iic_tpu.ops.pallas import displacement_joint_dense_pallas
from iic_tpu.ops.pallas.seg_joint_kernel import (_dgrad_pallas,
                                                 _joint_pallas_raw)
from iic_tpu_torch.ops.kernels import seg_joint as sj


def _maps(rng, n, k, h, w):
    """Softmax heat-maps (n, k, h, w) float32, masked like the loss does."""
    z = rng.standard_normal((n, k, h, w)).astype(np.float32)
    e = np.exp(z - z.max(axis=1, keepdims=True))
    m = (rng.random((n, 1, h, w)) > 0.1).astype(np.float32)
    return (e / e.sum(axis=1, keepdims=True)) * m


SHAPES = [(0, 3, 3, 8, 8), (2, 3, 4, 12, 12), (3, 2, 5, 16, 16),
          (2, 2, 3, 10, 7)]  # (half_t, n, k, h, w)


@pytest.mark.parametrize("half_t,n,k,h,w", SHAPES)
def test_plain_joint_matches_jax_conv(half_t, n, k, h, w):
    """Plain K1 vs JAX displacement_joint_dense, both f32 exact: rtol 1e-4
    (summation order only)."""
    rng = np.random.default_rng(half_t + 10 * k)
    x1, x2 = _maps(rng, n, k, h, w), _maps(rng, n, k, h, w)
    ref = np.asarray(jax_dense(jnp.asarray(x1), jnp.asarray(x2), half_t))
    got = sj.displacement_joint_dense(torch.from_numpy(x1),
                                      torch.from_numpy(x2), half_t).numpy()
    assert got.shape == ref.shape == (k, k, 2 * half_t + 1, 2 * half_t + 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("half_t,n,k,h,w", SHAPES[:3])
def test_plain_joint_matches_jax_pallas_interpret(half_t, n, k, h, w):
    """Plain K1 vs the JAX Pallas kernel in interpret mode. The Pallas
    kernel rounds its operands to bf16: rtol 5e-3, atol 5e-3 * max (its
    own contract, tests/test_pallas_kernels.py)."""
    rng = np.random.default_rng(7 + half_t)
    x1, x2 = _maps(rng, n, k, h, w), _maps(rng, n, k, h, w)
    ref = np.asarray(displacement_joint_dense_pallas(
        jnp.asarray(x1), jnp.asarray(x2), half_t))
    got = sj.joint_fwd(torch.from_numpy(x1), torch.from_numpy(x2),
                       half_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-3 * ref.max())


@pytest.mark.parametrize("half_t,n,k,h,w", SHAPES[1:])
def test_plain_dgrad_matches_jax_dgrad_pallas(half_t, n, k, h, w):
    """dgrad_plain vs JAX _dgrad_pallas (interpret) on the same (kT, kT)
    adjoint: bf16 operands on the JAX side, rtol 5e-3, atol 5e-3 * max."""
    rng = np.random.default_rng(3 + k)
    t = 2 * half_t + 1
    other = _maps(rng, n, k, h, w)
    g2d = rng.standard_normal((k * t, k * t)).astype(np.float32)
    ref = np.asarray(_dgrad_pallas(jnp.asarray(g2d), jnp.asarray(other),
                                   half_t, True))
    got = sj.dgrad_plain(torch.from_numpy(g2d), torch.from_numpy(other),
                         half_t).numpy()
    assert got.shape == ref.shape == other.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-3 * scale)


@pytest.mark.parametrize("half_t,n,k,h,w", SHAPES)
def test_segjoint_backward_matches_autograd_of_plain(half_t, n, k, h, w):
    """SegJoint's backward (two dgrad calls on the reordered adjoints) vs
    torch autograd through the plain conv, all f32: rtol 1e-4."""
    rng = np.random.default_rng(11 + k)
    t = 2 * half_t + 1
    x1, x2 = _maps(rng, n, k, h, w), _maps(rng, n, k, h, w)
    cot = torch.from_numpy(rng.standard_normal((k, k, t, t))
                           .astype(np.float32))

    def grads(fn):
        a = torch.from_numpy(x1).requires_grad_()
        b = torch.from_numpy(x2).requires_grad_()
        return torch.autograd.grad((fn(a, b, half_t) * cot).sum(), (a, b))

    ref = grads(sj.displacement_joint_dense)
    got = grads(sj.displacement_joint_dense_kernel)
    for g, r in zip(got, ref):
        scale = float(r.abs().max())
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale)


def test_segjoint_backward_matches_jax_grad_through_pallas():
    """SegJoint's gradients vs jax.grad through displacement_joint_dense_
    pallas at tests/test_pallas_kernels.py:99-122's shapes; the JAX kernel
    is bf16: rtol 5e-3, atol 5e-3 * max."""
    rng = np.random.default_rng(1)
    x1, x2 = _maps(rng, 2, 3, 10, 10), _maps(rng, 2, 3, 10, 10)
    half_t = 2
    w_cot = rng.standard_normal((3, 3, 5, 5)).astype(np.float32)

    def f(a, b):
        return jnp.sum(displacement_joint_dense_pallas(a, b, half_t) * w_cot)

    g1_ref, g2_ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(x1),
                                                  jnp.asarray(x2))
    a = torch.from_numpy(x1).requires_grad_()
    b = torch.from_numpy(x2).requires_grad_()
    loss = (sj.SegJoint.apply(a, b, half_t) * torch.from_numpy(w_cot)).sum()
    g1, g2 = torch.autograd.grad(loss, (a, b))
    scale = float(np.abs(np.asarray(g1_ref)).max())
    np.testing.assert_allclose(g1.numpy(), np.asarray(g1_ref), rtol=5e-3,
                               atol=5e-3 * scale)
    np.testing.assert_allclose(g2.numpy(), np.asarray(g2_ref), rtol=5e-3,
                               atol=5e-3 * scale)


def test_cpu_wrappers_use_plain_and_count_no_launch():
    """On CPU tensors the wrappers take the plain versions and launch
    nothing."""
    sj.reset_launch_counts()
    x = torch.rand(2, 3, 6, 6)
    sj.joint_fwd(x, x, 1)
    sj.joint_dgrad(torch.rand(9, 9), x, 1)
    assert sj.LAUNCHES == {"seg_joint_fwd": 0, "seg_joint_dgrad": 0}


@pytest.mark.parametrize("half_t,n,k,h,w", SHAPES[1:] + [(3, 1, 17, 9, 20)])
def test_k2_card_function_matches_jax_dgrad_pallas(half_t, n, k, h, w):
    """What K2 computes on the card, the adjoint and ``other`` rounded to
    bf16 with exact products and f32 sums, is what the TPU kernel
    computes: X8's plain version and X8's GEMM restated over K2's operand
    layouts (``sj.dgrad_v8_operands``, K2's tensor-core form) vs JAX
    _dgrad_pallas (interpret) on the same adjoint: f32 summation order only,
    atol 1e-5 * max."""
    from iic_tpu_torch.ops.kernels import joint_exp as jx
    from test_torch_joint_exp_bwd import _v8_gemm

    rng = np.random.default_rng(3 + k)
    t = 2 * half_t + 1
    other = _maps(rng, n, k, h, w)
    g2d = rng.standard_normal((k * t, k * t)).astype(np.float32)
    ref = np.asarray(_dgrad_pallas(jnp.asarray(g2d), jnp.asarray(other),
                                   half_t, True))
    args = (torch.from_numpy(g2d), torch.from_numpy(other), half_t)
    for got in (jx.dgrad_v8_plain(*args), _v8_gemm(*args)):
        assert got.shape == ref.shape == other.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_k2_form_and_its_limits():
    """K2 takes its CUDA-core form at k <= 4 while that form's f32 adjoint
    and patch fit a block (h <= 44), else the tensor-core form, whose patch
    plan keeps every h <= 64; each form's shared memory as its kernel
    computes it."""
    for k in (1, 3, 4):
        assert sj.k2_form(k, 10) == "cuda-core"
        assert sj.k2_form(k, 44) == "cuda-core"
        assert sj.k2_form(k, 45) == "wgmma"
    for k in (5, 8, 9, 15, 17, 64):
        assert sj.k2_form(k, 0) == sj.k2_form(k, 10) == "wgmma"
    assert sj._k2_small_smem(10) == 4 * (21 * 21 * 4 + 52 * 148)
    assert sj._k2_small_smem(44) <= 232448 < sj._k2_small_smem(45)
    assert sj.dgrad_v8_smem(15, 10) == 96768
    assert all(sj.dgrad_v8_smem(k, h) <= 232448
               for k in (1, 3, 15, 64) for h in range(65))


def test_cpu_k2_takes_plain_in_every_form():
    """On CPU tensors K2 returns its f32 plain version whatever the form,
    and counts no launch; an unknown form is refused on every device."""
    sj.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 3, 6, 6)).astype(np.float32))
    g2d = torch.from_numpy(rng.standard_normal((9, 9)).astype(np.float32))
    ref = sj.dgrad_plain(g2d, x, 1)
    for form in (None, *sj.K2_FORMS):
        assert torch.equal(sj.joint_dgrad(g2d, x, 1, form=form), ref)
    assert sj.LAUNCHES == {"seg_joint_fwd": 0, "seg_joint_dgrad": 0}
    with pytest.raises(ValueError, match="form"):
        sj.joint_dgrad(g2d, x, 1, form="cudnn")


def test_training_path_needs_no_experiment_module():
    """The segmentation loss and its train step import K1/K2 and X8's
    operand layout from ``seg_joint`` and never the experiment tool's
    ``joint_exp``."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys, iic_tpu_torch.parallel.train_step; "
            "assert 'iic_tpu_torch.ops.kernels.seg_joint' in sys.modules; "
            "assert 'iic_tpu_torch.ops.kernels.joint_exp' not in "
            "sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_wrapper_refuses_mixed_devices():
    x = torch.rand(2, 3, 6, 6)
    with pytest.raises(ValueError):
        sj.joint_fwd(x, x.to("meta"), 1)


def _gather(x, idx, ok):
    """x[idx] where ``ok``, else 0 (idx clamped into range first)."""
    return torch.where(ok, x[idx.clamp(0, x.numel() - 1)], torch.zeros(()))


def _k1_mma_restated(x1, x2, half_t, rb=sj.K1_RB,
                     chunk_rows=sj.K1_CHUNK_ROWS):
    """K1's tensor-core form (csrc/joint_fwd_common.cuh) restated in plain
    PyTorch from the operands in the layout its kernel reads
    (``sj.channels_last_chunks``): for each block (N tile, M tile, chunk of
    passes of rb rows, ``sj.k1_plan``) and each slab of 16 rows x 64
    pixels, the x2 window and the x1 rows staged in shared-memory byte
    order ([row][channel half][pixel][8 channels], zero outside the frame),
    A gathered at the addresses the lanes give ldmatrix.trans (pixel
    (l & 7) + 8 (l >> 4) shifted by the warp's v, half (l >> 3) & 1), B at
    the core-matrix addresses of the MN-major descriptor (LBO 128 bytes
    along K, SBO one channel half along N) from the warpgroup's first core
    matrix, one (64 x 16) @ (16 x 168) product per warpgroup, row and k16
    step in f32; the partials stored at ((v, i), (u, j)), u = T - 1 - u',
    and added in chunk order."""
    n, k, h, w = x1.shape
    t = 2 * half_t + 1
    tk = k * t
    ch, pix, rows_max, nv, cm, wgs, nu = (
        sj._JF_CH, sj._JF_PIX, sj._JF_ROWS, sj._JF_V, sj._JF_CM,
        sj._JF_WGS, sj._JF_U)
    a_pix = sj._JF_A_PIX
    half_b, a_half = pix * 16, a_pix * 16  # bytes
    row_b, a_row = 2 * half_b, 2 * a_half
    x1c = sj.channels_last_chunks(x1).float()
    x2c = sj.channels_last_chunks(x2).float()
    assert x1c.shape == (n, -(-k // ch), h, w, ch)
    chunks = x1c.shape[1]
    m_tiles, n_tiles = -(-t // nv), -(-t // nu)
    assert sj.k1_tiles(k, half_t) == (chunks * n_tiles, chunks * m_tiles)
    per, splits = sj.k1_plan(n, k, h, half_t, rb, chunk_rows)
    pph = -(-h // rb)
    passes = n * pph
    assert (splits - 1) * per < passes <= splits * per

    # byte offsets (from the staged x1 row, from the warpgroup's first
    # core matrix) of A[16 warp + c][kk] and B[kk][nn]
    warp, c16, kk = torch.meshgrid(torch.arange(nv), torch.arange(ch),
                                   torch.arange(16), indexing="ij")
    a_off = ((c16 // 8) * a_half + (warp + kk % 8 + 8 * (kk // 8)) * 16
             + 2 * (c16 % 8)).reshape(64, 16)
    kq, nn = torch.meshgrid(torch.arange(16), torch.arange(8 * cm),
                            indexing="ij")
    b_off = (nn // 8) * half_b + (kq // 8) * 128 + (kq % 8) * 16 \
        + 2 * (nn % 8)

    part = torch.zeros(splits, tk, tk)
    for bx in range(chunks * n_tiles):
        jc, up0 = bx // n_tiles, (bx % n_tiles) * nu
        for by in range(chunks * m_tiles):
            ic, v0 = by // m_tiles, (by % m_tiles) * nv
            for z in range(splits):
                acc = torch.zeros(wgs, 64, 8 * cm)
                for p in range(z * per, min(z * per + per, passes)):
                    img, yb = divmod(p, pph)
                    for wy in range(yb * rb, min(yb * rb + rb, h), rows_max):
                        rows = min(rows_max, yb * rb + rb - wy, h - wy)
                        for q0 in range(0, w, pix):
                            steps = -(-min(pix, w - q0) // 16)
                            # the staged window [r][c][px][8] and x1 rows
                            r, c, px, e = torch.meshgrid(
                                torch.arange(rows + nu - 1), torch.arange(2),
                                torch.arange(pix), torch.arange(8),
                                indexing="ij")
                            yy, xx = wy - half_t + up0 + r, q0 + px
                            src = x2c[img, jc].flatten()
                            win = _gather(src, (yy * w + xx) * ch + 8 * c + e,
                                          (yy >= 0) & (yy < h) & (xx < w))
                            r, c, px, e = torch.meshgrid(
                                torch.arange(rows), torch.arange(2),
                                torch.arange(a_pix), torch.arange(8),
                                indexing="ij")
                            xx = q0 + v0 - half_t + px
                            src = x1c[img, ic].flatten()
                            arow = _gather(src,
                                           ((wy + r) * w + xx) * ch + 8 * c + e,
                                           (xx >= 0) & (xx < w)
                                           & (px < a_pix - 1))
                            win, arow = win.flatten(), arow.flatten()
                            for ry in range(rows):
                                for s_ in range(steps):
                                    a = arow[(a_off + ry * a_row + 256 * s_)
                                             // 2]
                                    for g in range(wgs):
                                        b = win[(b_off + g * cm * half_b
                                                 + ry * row_b + 256 * s_)
                                                // 2]
                                        acc[g] += a @ b
                m_loc, col = torch.meshgrid(torch.arange(64),
                                            torch.arange(8 * cm),
                                            indexing="ij")
                for g in range(wgs):
                    ct = g * cm + col // 8
                    v, i = v0 + m_loc // 16, ic * ch + m_loc % 16
                    u = t - 1 - (up0 + ct // 2)
                    j = jc * ch + 8 * (ct % 2) + col % 8
                    ok = (v < t) & (u >= 0) & (i < k) & (j < k)
                    part[z][(v * k + i)[ok], (u * k + j)[ok]] = acc[g][ok]
    out = part[0].clone()
    for z in range(1, splits):
        out += part[z]
    return out.reshape(t, k, t, k).permute(1, 3, 2, 0)


K1_CARD_SHAPES = SHAPES + [(3, 1, 17, 9, 20)]


@pytest.mark.parametrize("half_t,n,k,h,w", K1_CARD_SHAPES)
def test_k1_card_function_matches_jax_joint_pallas(half_t, n, k, h, w):
    """What K1 computes on the card, x1 and x2 rounded to bf16 with exact
    products and f32 sums (``sj.joint_fwd_bf16_plain``, X7's plain version
    too), is what the TPU kernel computes: vs JAX _joint_pallas_raw
    (interpret), f32 summation order only, atol 1e-5 * max."""
    rng = np.random.default_rng(17 + half_t + k)
    x1, x2 = _maps(rng, n, k, h, w), _maps(rng, n, k, h, w)
    ref = np.asarray(_joint_pallas_raw(jnp.asarray(x1), jnp.asarray(x2),
                                       half_t, True))
    got = sj.joint_fwd_bf16_plain(torch.from_numpy(x1),
                                  torch.from_numpy(x2), half_t).numpy()
    assert got.shape == ref.shape == (k, k, 2 * half_t + 1, 2 * half_t + 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("half_t,n,k,h,w,rb,chunk_rows", [
    (0, 3, 3, 8, 8, 16, 128), (2, 3, 4, 12, 12, 16, 128),
    (3, 2, 5, 16, 16, 16, 16), (2, 2, 3, 10, 7, 32, 128),
    (3, 1, 17, 9, 20, 16, 128), (1, 2, 6, 20, 70, 16, 16),
    (11, 1, 2, 30, 9, 16, 128), (2, 3, 16, 40, 18, 64, 16)])
def test_k1_mma_restatement(half_t, n, k, h, w, rb, chunk_rows):
    """K1's tensor-core form restated over its operand layouts vs the JAX
    _joint_pallas_raw (interpret): the same bf16 operands and exact
    products, f32 sums in another order: atol 1e-5 * max. Covers two
    channel chunks (k=17), k=16, two N tiles (half_t 11: T = 23 > 21
    shifts u), several M tiles, w not a multiple of 16 or 64 (a ragged
    column slab), h not a multiple of 16 (a ragged row slab), rb 16, 32
    and 64 and several split-K chunks."""
    rng = np.random.default_rng(5 + half_t + k + w)
    x1, x2 = _maps(rng, n, k, h, w), _maps(rng, n, k, h, w)
    ref = np.asarray(_joint_pallas_raw(jnp.asarray(x1), jnp.asarray(x2),
                                       half_t, True))
    got = _k1_mma_restated(torch.from_numpy(x1), torch.from_numpy(x2),
                           half_t, rb, chunk_rows).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_k1_form_plan_and_limits(monkeypatch):
    """K1 takes its CUDA-core form at k <= 4 and its tensor-core form above,
    at every half_t; the tensor-core form's shared memory (two buffers of
    the x2 window of 16 + 20 rows and 16 x1 rows, 64 pixels each) does not
    depend on k, h or w, so no shape is refused, and a form over the
    block's limit would be;
    the split plan cuts the main path's (n, y) rows into chunks of
    K1_CHUNK_ROWS rows, and grows the chunks instead of the splits where a
    large T would put too many blocks in flight."""
    for k in (1, 3, 4):
        assert sj.k1_form(k, 0) == sj.k1_form(k, 64) == "cuda-core"
    for k in (5, 15, 16, 17, 70):
        assert sj.k1_form(k, 0) == sj.k1_form(k, 64) == "wgmma"
    assert sj.k1_smem("wgmma") == 2 * (36 * 2048 + 16 * 2176) == 217088
    assert sj.k1_smem("cuda-core") == 8704
    for form in sj.K1_FORMS:
        sj.check_k1_smem(form)
    monkeypatch.setattr(sj, "_SMEM_BLOCK", 100000)
    with pytest.raises(ValueError, match="shared memory"):
        sj.check_k1_smem("wgmma")
    sj.check_k1_smem("cuda-core")
    assert sj.k1_tiles(15, 10) == (1, 6)
    assert sj.k1_tiles(17, 11) == (4, 12)
    assert sj.k1_plan(120, 15, 128, 10) == (8, 120)
    assert sj.k1_plan(120, 15, 128, 10, 64) == (2, 120)
    # 960 one-pass chunks x 6 tiles would pass 2112 blocks: 3 passes each
    assert sj.k1_plan(120, 15, 128, 10, 16, 16) == (3, 320)
    per, splits = sj.k1_plan(120, 15, 128, 64)
    tiles = sj.k1_tiles(15, 64)
    assert tiles == (7, 33) and splits * tiles[0] * tiles[1] <= 2112


def test_cpu_k1_takes_plain_in_every_form():
    """On CPU tensors K1 returns its f32 plain version (not the bf16 card
    function) whatever the form, and counts no launch; an unknown form is
    refused on every device."""
    sj.reset_launch_counts()
    rng = np.random.default_rng(1)
    x1 = torch.from_numpy(rng.random((2, 5, 6, 6)).astype(np.float32))
    x2 = torch.from_numpy(rng.random((2, 5, 6, 6)).astype(np.float32))
    ref = sj.displacement_joint_dense(x1, x2, 1)
    for form in (None, *sj.K1_FORMS):
        assert torch.equal(sj.joint_fwd(x1, x2, 1, form=form), ref)
    assert sj.LAUNCHES == {"seg_joint_fwd": 0, "seg_joint_dgrad": 0}
    with pytest.raises(ValueError, match="form"):
        sj.joint_fwd(x1, x2, 1, form="cudnn")
