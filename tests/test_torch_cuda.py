"""The port's CUDA kernels K1 / K2 (displacement joint on bf16 operands,
on the tensor cores at k > 4), K3 (fused
clustering IID loss), X1 / X2 / X7 (the experiment tool's stack-product
probe and bf16 joint forwards), X3-X6 (its pipelined bf16 joint forwards)
and X8 / X9 (its bf16 input gradients) on the card, against their plain
PyTorch versions; the bf16 nets on the card against the same nets' bf16
forwards on the CPU; the prefetch thread's uploads against the
synchronous ones, and the native host prep's batches uploaded to the card
against the CPU's; the augmentations and train steps of the clustering
and semisup paths on the card against the CPU; the baselines' k-means on
the card against its float64 replay on the CPU.
Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from iic_tpu_torch.ops import iid_loss, iid_seg_loss
from iic_tpu_torch.ops.kernels import iid_loss as k3
from iic_tpu_torch.ops.kernels import joint_exp as jx
from iic_tpu_torch.ops.kernels import seg_joint as sj


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


def _maps(rng, n, k, h, w):
    z = rng.standard_normal((n, k, h, w)).astype(np.float32)
    e = np.exp(z - z.max(axis=1, keepdims=True))
    m = (rng.random((n, 1, h, w)) > 0.1).astype(np.float32)
    return (e / e.sum(axis=1, keepdims=True)) * m


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", [
    (0, 3, 3, 8, 8), (2, 3, 4, 12, 12), (3, 2, 5, 16, 16), (2, 2, 3, 10, 7),
    (10, 4, 15, 128, 128), (10, 4, 3, 128, 96), (10, 2, 17, 40, 33),
    (4, 1, 1, 5, 70), (10, 2, 45, 128, 128), (5, 2, 36, 200, 200)])
def test_kernels_match_plain(gpu, half_t, n, k, h, w):
    """K1 and K2 (dx1, dx2) vs their plain versions: the JAX package's
    kernel contract, rtol 5e-3, atol 5e-3 * max. The last two shapes are
    COCO-Stuff's head A (k=45, three 16-channel chunks) and Potsdam's (k=36,
    T=11, a 200-pixel map that is no multiple of K1's 64-pixel slabs) at
    n=2."""
    rng = np.random.default_rng(5)
    t = 2 * half_t + 1
    x1 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    x2 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    g = torch.from_numpy(rng.standard_normal((k, k, t, t))
                         .astype(np.float32)).to(gpu)
    g2d, g2d_swap = sj.adjoints(g)
    pairs = [(sj.joint_fwd(x1, x2, half_t),
              sj.displacement_joint_dense(x1, x2, half_t)),
             (sj.joint_dgrad(g2d, x2, half_t),
              sj.dgrad_plain(g2d, x2, half_t)),
             (sj.joint_dgrad(g2d_swap, x1, half_t),
              sj.dgrad_plain(g2d_swap, x1, half_t))]
    for got, ref in pairs:
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=5e-3,
                                   atol=5e-3 * np.abs(ref).max())


# K2 against its bf16 function in float64: f32 sums, which the tensor cores
# accumulate truncating (toward zero) where FMAs round; measured up to
# 1.2e-5 of max on the card at T = 21 to 129
K2_F64 = 3e-5
K12_SHAPES = [
    (0, 3, 3, 8, 8), (2, 3, 4, 12, 12), (3, 2, 5, 16, 16), (2, 2, 3, 10, 7),
    (10, 4, 15, 128, 128), (10, 4, 3, 128, 96), (10, 2, 17, 40, 33),
    (4, 1, 1, 5, 70)]


# K1 against its bf16 function in float64: the tensor cores' f32 sums
# truncate and a joint's terms are all positive, so the error grows with a
# chunk's depth: measured 8.4e-5 of max at 128-row chunks (k=15, n=4 and
# 120, 128^2) on the card; the CUDA-core form rounds (2.6e-6)
K1_F64 = {"wgmma": 2e-4, "cuda-core": 2e-5}
K1_SHAPES = K12_SHAPES + [(1, 2, 16, 20, 33), (0, 3, 17, 12, 70),
                          (1, 2, 6, 30, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", K1_SHAPES)
def test_k1_forms_are_the_bf16_joint(gpu, half_t, n, k, h, w):
    """Both of K1's forms, forced at every k (the CUDA-core form serves
    k <= 4, the tensor-core form above), compute the TPU kernel's function:
    x1 and x2 rounded to bf16, exact products, f32 sums. Against that
    function in float64 each is within K1_F64 of max (f32 summation only),
    and within the JAX package's kernel contract (rtol 5e-3, atol 5e-3 *
    max) of the f32 conv; each counts one launch."""
    rng = np.random.default_rng(21 + k + half_t)
    x1 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    x2 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    ref = sj.joint_fwd_bf16_plain(x1.double(), x2.double(), half_t)
    ref32 = sj.displacement_joint_dense(x1, x2, half_t).cpu().numpy()
    scale = float(ref.abs().max())
    for form in sj.K1_FORMS:
        sj.reset_launch_counts()
        got = sj.joint_fwd(x1, x2, half_t, form=form)
        assert sj.LAUNCHES["seg_joint_fwd"] == 1
        assert got.shape == ref.shape and got.dtype == torch.float32
        err = float((got.double() - ref).abs().max())
        assert err <= K1_F64[form] * scale, (form, err / scale)
        np.testing.assert_allclose(got.cpu().numpy(), ref32, rtol=5e-3,
                                   atol=5e-3 * np.abs(ref32).max(),
                                   err_msg=form)


@pytest.mark.cuda
def test_k1_chunks_and_refusals(gpu):
    """K1's tensor-core form gives the same joint, within K1_F64, at every
    chunk depth, and shorter chunks sit no further from float64; its C
    entry refuses a plan whose chunks do not cover the passes, or have
    none, with a CUDA error code."""
    rng = np.random.default_rng(4)
    x1 = torch.from_numpy(_maps(rng, 8, 7, 64, 64)).to(gpu)
    x2 = torch.from_numpy(_maps(rng, 8, 7, 64, 64)).to(gpu)
    ref = sj.joint_fwd_bf16_plain(x1.double(), x2.double(), 3)
    scale = float(ref.abs().max())
    errs = []
    for rows in (16, 64, 128):
        got = sj.launch_joint_fwd_mma(sj._lib().seg_joint_fwd, x1, x2, 3,
                                      sj.K1_RB, rows)
        errs.append(float((got.double() - ref).abs().max()) / scale)
    assert max(errs) <= K1_F64["wgmma"] and errs[0] <= errs[-1], errs
    lib = sj._lib()
    xc = torch.empty((2, 8, 1, 64, 64, 16), device=gpu, dtype=torch.bfloat16)
    part = torch.empty((32, 49, 49), device=gpu)
    out = torch.empty((7, 7, 7, 7), device=gpu)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x1.data_ptr(), x2.data_ptr(), xc[0].data_ptr(), xc[1].data_ptr(),
            part.data_ptr(), out.data_ptr(), 8, 7, 64, 64, 3, 16)
    assert lib.seg_joint_fwd(*args, 4, 8, stream) == 0   # 32 passes
    assert lib.seg_joint_fwd(*args, 4, 7, stream) != 0   # 28 < 32
    assert lib.seg_joint_fwd(*args, 4, 9, stream) != 0   # an empty chunk
    assert lib.seg_joint_fwd(*args, 0, 8, stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", K12_SHAPES)
def test_k2_is_the_bf16_gradient(gpu, half_t, n, k, h, w):
    """K2 computes the TPU kernel's function: the adjoint and the input
    rounded to bf16, exact products, f32 sums. Against that function in
    float64 (X8's plain version) it is within K2_F64 of max (f32 summation
    only); at k > 4 it is X8's kernel on X8's operands, bit for bit."""
    rng = np.random.default_rng(9)
    t = 2 * half_t + 1
    x2 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    g = torch.from_numpy(rng.standard_normal((k, k, t, t))
                         .astype(np.float32)).to(gpu)
    g2d, _ = sj.adjoints(g)
    sj.reset_launch_counts()
    got = sj.joint_dgrad(g2d, x2, half_t)
    assert sj.LAUNCHES["seg_joint_dgrad"] == 1
    ref = jx.dgrad_v8_plain(g2d.double(), x2.double(), half_t)
    scale = float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= K2_F64 * scale
    if sj.k2_form(k, half_t) == "wgmma":
        assert torch.equal(got, jx.dgrad_v8(g2d, x2, half_t, rb=16))


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", [
    (10, 3, 3, 128, 128), (2, 2, 1, 12, 70), (4, 2, 4, 40, 33),
    (10, 2, 5, 20, 20)])
def test_k2_forms_agree(gpu, half_t, n, k, h, w):
    """Both of K2's forms, forced at every k (the CUDA-core form serves
    k <= 4, the tensor-core form above): the same bf16 operands, so both
    are within K2_F64 of max of the float64 gradient; each counts one
    launch."""
    rng = np.random.default_rng(11 + k)
    t = 2 * half_t + 1
    x2 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    g2d = torch.from_numpy(rng.standard_normal((k * t, k * t))
                           .astype(np.float32)).to(gpu)
    ref = jx.dgrad_v8_plain(g2d.double(), x2.double(), half_t)
    scale = float(ref.abs().max())
    for form in sj.K2_FORMS:
        sj.reset_launch_counts()
        got = sj.joint_dgrad(g2d, x2, half_t, form=form)
        assert sj.LAUNCHES["seg_joint_dgrad"] == 1
        assert float((got.double() - ref).abs().max()) <= K2_F64 * scale, form


@pytest.mark.cuda
def test_k2_large_half_t(gpu):
    """Where the CUDA-core form's f32 adjoint and patch no longer fit a
    block (h = 45 at k <= 4), K2 takes the tensor-core form and, from h = 23
    (25 at k <= 8), its sliced patch plan, as X8 does; the wrapper refuses
    what its form cannot hold (the adjoint chunks alone at k = 9, h = 97;
    the CUDA-core form forced at h = 45)."""
    for half_t, k in ((45, 3), (25, 15), (64, 2)):
        assert sj.k2_form(k, half_t) == "wgmma"
        rng = np.random.default_rng(half_t)
        t = 2 * half_t + 1
        x2 = torch.from_numpy(_maps(rng, 1, k, 20, 40)).to(gpu)
        g2d = torch.from_numpy(rng.standard_normal((k * t, k * t))
                               .astype(np.float32)).to(gpu)
        got = sj.joint_dgrad(g2d, x2, half_t)
        ref = jx.dgrad_v8_plain(g2d.double(), x2.double(), half_t)
        assert float((got.double() - ref).abs().max()) <= K2_F64 * float(
            ref.abs().max())
    x = torch.rand(1, 9, 8, 8, device=gpu)
    with pytest.raises(ValueError, match="shared memory"):
        sj.joint_dgrad(torch.rand(9 * 195, 9 * 195, device=gpu), x, 97)
    with pytest.raises(ValueError, match="shared memory"):
        sj.joint_dgrad(torch.rand(2 * 91, 2 * 91, device=gpu),
                       x[:, :2].contiguous(), 45, form="cuda-core")


@pytest.mark.cuda
def test_loss_through_kernels_matches_conv(gpu, monkeypatch):
    """The uncollapsed loss and its gradient with joint_impl="pallas" (the
    kernels, which must launch) vs "conv": rtol 1e-3 on the loss. K1 rounds
    both inputs and K2 the cotangent and the other input to bf16, as the
    TPU kernels do. So the gradient is held within atol 1e-3 * max of the
    same loss with K2 replaced by its function's plain version (the same
    forward, so the same cotangent), and the loss within rtol 1e-4 of the
    same loss with K1 replaced too; there the cotangent differs by f32
    rounding, which can move an entry across a bf16 rounding boundary in
    K2, so that gradient is held within one bf16 step of the adjoint,
    atol 2^-8 * max. The gradient is held within the JAX package's kernel
    contract (rtol 5e-3, atol 5e-3 * max) of the f32 conv path."""
    rng = np.random.default_rng(2)
    n, k, hw = 4, 6, 32
    x1 = torch.from_numpy(_maps(rng, n, k, hw, hw)).to(gpu)
    x2 = torch.from_numpy(_maps(rng, n, k, hw, hw)).to(gpu)
    aff = torch.eye(2, 3, device=gpu).repeat(n, 1, 1)
    mask = torch.ones((n, hw, hw), device=gpu)

    def run(impl):
        a = x1.clone().requires_grad_()
        loss, _ = iid_seg_loss.IID_segmentation_loss_uncollapsed(
            a, x2, aff, mask, half_T_side_dense=3, half_T_side_sparse_min=0,
            half_T_side_sparse_max=0, joint_impl=impl)
        grad = torch.autograd.grad(loss, a)[0]
        return float(loss.detach()), grad.cpu().numpy()

    sj.reset_launch_counts()
    loss_k, grad_k = run("pallas")
    assert sj.LAUNCHES == {"seg_joint_fwd": 1, "seg_joint_dgrad": 2}
    loss_c, grad_c = run("conv")
    np.testing.assert_allclose(loss_k, loss_c, rtol=1e-3)
    np.testing.assert_allclose(grad_k, grad_c, rtol=5e-3,
                               atol=5e-3 * np.abs(grad_c).max())
    monkeypatch.setattr(sj, "joint_dgrad", jx.dgrad_v8_plain)
    _, grad_r = run("pallas")
    np.testing.assert_allclose(grad_k, grad_r, atol=1e-3 * np.abs(grad_r).max())
    monkeypatch.setattr(sj, "joint_fwd", sj.joint_fwd_bf16_plain)
    loss_r, grad_r = run("pallas")
    np.testing.assert_allclose(loss_k, loss_r, rtol=1e-4)
    np.testing.assert_allclose(grad_k, grad_r,
                               atol=2 ** -8 * np.abs(grad_r).max())


@pytest.mark.cuda
def test_sparse_translation_with_a_cuda_generator(gpu):
    """The loss's sparse translation draws from the batch's CUDA generator
    and stays finite."""
    rng = np.random.default_rng(3)
    x1 = torch.from_numpy(_maps(rng, 2, 3, 16, 16)).to(gpu)
    x2 = torch.from_numpy(_maps(rng, 2, 3, 16, 16)).to(gpu)
    aff = torch.eye(2, 3, device=gpu).repeat(2, 1, 1)
    mask = torch.ones((2, 16, 16), device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(0)
    loss, _ = iid_seg_loss.IID_segmentation_loss_uncollapsed(
        x1, x2, aff, mask, half_T_side_dense=2, half_T_side_sparse_min=1,
        half_T_side_sparse_max=2, generator=gen)
    assert torch.isfinite(loss)


@pytest.mark.cuda
def test_wrappers_raise_on_bad_input(gpu):
    x = torch.rand(2, 3, 8, 8, device=gpu)
    with pytest.raises(TypeError):
        sj.joint_fwd(x.double(), x.double(), 1)
    with pytest.raises(ValueError):
        sj.joint_fwd(x.transpose(2, 3), x, 1)
    with pytest.raises(ValueError):
        sj.joint_dgrad(torch.rand(8, 8, device=gpu), x, 1)
    with pytest.raises(ValueError):
        sj.joint_fwd(x, x.cpu(), 1)
    with pytest.raises(ValueError):
        sj.joint_dgrad(torch.rand(9, 9, device=gpu), x, 1, form="cudnn")
    with pytest.raises(ValueError, match="form"):
        sj.joint_fwd(x, x, 1, form="cudnn")
    with pytest.raises(TypeError):
        sj.joint_dgrad(torch.rand(9, 9, device=gpu), x.double(), 1)


def _softmax_pair(rng, *shape):
    def one():
        z = rng.standard_normal(shape).astype(np.float32)
        e = np.exp(z - z.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
    return one(), one()


@pytest.mark.cuda
@pytest.mark.parametrize("s,bn,k", [
    (1, 1, 1), (1, 7, 3), (5, 33, 10), (5, 257, 70), (1, 660, 140),
    (5, 660, 70), (5, 660, 10), (5, 1000, 140), (2, 99, 180), (1, 31, 1),
    (5, 700, 50), (5, 700, 10), (5, 700, 70), (5, 585, 50), (5, 585, 10)])
def test_k3_matches_plain(gpu, s, bn, k):
    """K3 vs its plain version at small and ragged shapes (and at model
    685's heads A and B, model 569's head A, and both heads of the Digits
    guard at the Digits set's ragged last batch of 585 rows): loss and
    loss_nl
    within rtol 1e-5, atol 1e-5 (the JAX package's kernel contract), P
    within 1e-6 of max |P| of the plain version in float64 (the kernel
    sums each entry in row ranges, the f32 plain version in cuBLAS's
    order, itself up to 1.1e-6 of max off float64), total within rtol
    1e-5."""
    z, zt = (torch.from_numpy(a).to(gpu)
             for a in _softmax_pair(np.random.default_rng(k), s, bn, k))
    got = k3.iid_loss_fwd(z, zt, 1.3)
    ref = k3.iid_loss_fused_plain(z, zt, 1.3)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    p_ref = k3.iid_loss_fused_plain(z.double(), zt.double(),
                                    1.3)[2].cpu().numpy()
    np.testing.assert_allclose(got[2].cpu().numpy(), p_ref, rtol=0,
                               atol=1e-6 * np.abs(p_ref).max())
    np.testing.assert_allclose(got[3].cpu().numpy(), ref[3].cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.cuda
def test_k3_sub_heads_are_independent(gpu):
    """One launch over (S, bn, k) gives each sub-head exactly the numbers
    of a launch on that sub-head alone."""
    z, zt = (torch.from_numpy(a).to(gpu)
             for a in _softmax_pair(np.random.default_rng(0), 5, 130, 70))
    together = k3.iid_loss_fwd(z, zt, 1.0)
    for i in range(5):
        alone = k3.iid_loss_fwd(z[i], zt[i], 1.0)
        for a, b in zip(alone, together):
            assert torch.equal(a, b[i])


@pytest.mark.cuda
@pytest.mark.parametrize("s,bn,k", [(1, 64, 10), (5, 660, 70),
                                    (5, 1000, 140)])
def test_k3_backward_matches_float64_autograd(gpu, s, bn, k):
    """Gradients through K3 (kernel forward, analytic backward) against
    autograd of the plain loss in float64, for a cotangent on both
    outputs: rtol 1e-3, atol 1e-6 (``tests/test_pallas_kernels.py:54-55``).
    """
    z, zt = _softmax_pair(np.random.default_rng(1), s, bn, k)
    w = torch.linspace(0.5, 1.5, s, device=gpu)

    def grads(fn, dtype):
        a = torch.from_numpy(z).to(gpu, dtype).requires_grad_()
        b = torch.from_numpy(zt).to(gpu, dtype).requires_grad_()
        loss, nl = fn(a, b)[:2]
        obj = (w.to(dtype) * loss).sum() - 0.3 * nl.sum()
        return torch.autograd.grad(obj, (a, b))

    got = grads(lambda a, b: k3.iid_loss_fused(a, b, 1.0), torch.float32)
    ref = grads(lambda a, b: k3.iid_loss_fused_plain(a, b, 1.0),
                torch.float64)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
def test_k3_counts_launches_and_serves_iid_loss(gpu):
    """``IID_loss(impl="fused")`` on CUDA launches K3 once for all sub-heads
    and agrees with the xla path within 1e-5."""
    z, zt = (torch.from_numpy(a).to(gpu)
             for a in _softmax_pair(np.random.default_rng(2), 5, 66, 10))
    k3.reset_launch_counts()
    fused = iid_loss.IID_loss(z, zt, impl="fused")
    assert k3.LAUNCHES == {"iid_loss_fwd": 1}
    plain = iid_loss.IID_loss(z, zt)
    for f, p in zip(fused, plain):
        np.testing.assert_allclose(f.cpu().numpy(), p.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k3_refuses_what_it_cannot_launch(gpu):
    """Bad input raises before a launch; a launch the C entry point refuses
    (k over its maximum) returns a CUDA error code."""
    z = torch.rand(4, 10, device=gpu)
    with pytest.raises(TypeError):
        k3.iid_loss_fwd(z.double(), z.double())
    with pytest.raises(ValueError):
        k3.iid_loss_fwd(z.t(), z.t())
    with pytest.raises(ValueError):
        k3.iid_loss_fwd(z, z.cpu())
    big = torch.rand(4, 200, device=gpu)
    with pytest.raises(ValueError, match="k <="):
        k3.iid_loss_fwd(big, big)
    with pytest.raises(ValueError, match="form"):
        k3.iid_loss_fwd(z, z, form="warp")
    lib = k3._lib()
    out = torch.empty(200 * 200 + 3, device=gpu)
    stream = torch.cuda.current_stream().cuda_stream
    for cluster in (0, k3.CLUSTER, 8, 17, -1):
        k = 200 if cluster in (0, k3.CLUSTER) else 10
        err = lib.iid_loss_fwd(big.data_ptr(), big.data_ptr(),
                               out.data_ptr(), out.data_ptr(),
                               out.data_ptr(), out.data_ptr(), 1, 4, k, 1.0,
                               cluster, stream)
        assert err != 0, cluster


# K3's cluster form where its split is at an edge: bn under the cluster
# (ranks with no rows), bn = 1, k = 1, k at iid_loss_max_k() (180), bn
# ragged against both the cluster and the 32-row stage, and k % 4 of 0, 2
# and odd (16-, 8- and 4-byte copies)
K3_EDGES = [(5, 5, 70), (3, 1, 10), (2, 40, 1), (1, 1, 1), (2, 99, 180),
            (5, 661, 70), (5, 663, 12), (3, 517, 33), (1, 300, 140)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,bn,k", K3_EDGES)
def test_k3_cluster_split_edges(gpu, s, bn, k):
    """K3's cluster form and its block form vs the plain version at the split's edges: loss and loss_nl within
    rtol = atol = 1e-5, P within 1e-6 of max |P| (the cluster form against
    the plain version in float64, the block form, which sums in its
    order, against the f32 one), total within rtol 1e-5."""
    z, zt = (torch.from_numpy(a).to(gpu)
             for a in _softmax_pair(np.random.default_rng(bn + k), s, bn, k))
    ref = k3.iid_loss_fused_plain(z, zt, 1.1)
    p64 = k3.iid_loss_fused_plain(z.double(), zt.double(),
                                  1.1)[2].cpu().numpy()
    for form in k3.FORMS:
        p_ref = p64 if form == "cluster" else ref[2].cpu().numpy()
        got = k3.iid_loss_fwd(z, zt, 1.1, form=form)
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=form)
        np.testing.assert_allclose(got[2].cpu().numpy(), p_ref, rtol=0,
                                   atol=1e-6 * np.abs(p_ref).max(),
                                   err_msg=form)
        np.testing.assert_allclose(got[3].cpu().numpy(),
                                   ref[3].cpu().numpy(), rtol=1e-5,
                                   err_msg=form)


@pytest.mark.cuda
@pytest.mark.parametrize("s,bn,k", [(5, 660, 70), (5, 1000, 140),
                                    (2, 5, 70)])
def test_k3_launches_give_equal_bits(gpu, s, bn, k):
    """The cluster form adds its partial joints in rank order and every
    other sum in a fixed order: two launches give the same bits, and a
    sub-head's numbers do not depend on the other sub-heads of the
    launch."""
    z, zt = (torch.from_numpy(a).to(gpu)
             for a in _softmax_pair(np.random.default_rng(s * k), s, bn, k))
    first = k3.iid_loss_fwd(z, zt, 1.0)
    second = k3.iid_loss_fwd(z, zt, 1.0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    alone = k3.iid_loss_fwd(z[-1:].contiguous(), zt[-1:].contiguous(), 1.0)
    for a, b in zip(first, alone):
        assert torch.equal(a[-1:], b)


_NO_LAUNCH = dict.fromkeys(jx.LAUNCHES, 0)
X2_SHAPES = [(2, 3, 3, 8, 8), (3, 2, 5, 16, 16), (2, 2, 3, 10, 7),
             (10, 4, 15, 128, 128), (10, 3, 3, 128, 96), (4, 1, 17, 40, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", X2_SHAPES)
def test_x2_matches_plain(gpu, half_t, n, k, h, w):
    """X2 in every mode vs its plain version. full, rank3 and
    aligned-copies: the same bf16 operands and exact products, so only the
    f32 summation order differs, and the tensor cores' f32 sums truncate:
    within K1_F64 of max of the bf16 function in float64. mm-only and
    copies-only are exact."""
    rng = np.random.default_rng(half_t + k)
    x1 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    x2 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    t = 2 * half_t + 1
    for mode in jx.MODES:
        got = jx.joint_fwd_v2(x1, x2, half_t, mode=mode)
        ref = jx.joint_fwd_v2_plain(x1, x2, half_t, mode)
        assert got.shape == ref.shape == (k, k, t, t)
        if mode in ("mm-only", "copies-only"):
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          ref.cpu().numpy(), err_msg=mode)
        else:
            ref64 = jx.joint_fwd_v2_plain(x1.double(), x2.double(), half_t,
                                          mode)
            err = float((got.double() - ref64).abs().max())
            assert err <= K1_F64["wgmma"] * float(ref64.abs().max()), mode
    aligned = jx.joint_fwd_v2(x1, x2, half_t, mode="aligned-copies")
    assert torch.equal(aligned, aligned[:, :, :1, :1].expand(k, k, t, t))


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", X2_SHAPES + [
    (1, 2, 5, 20, 70), (10, 1, 17, 9, 20), (10, 2, 5, 18, 33)])
def test_x2_x3_tensor_core_forms_run_k1s_products(gpu, half_t, n, k, h, w):
    """X2's full and rank3 are X7's tensor-core launch, and X3's tensor-core form issues the same products in the same
    order, fed by TMA: each equals X7 ("wgmma") on the same bf16 operands
    bit for bit at rb 16, 32 and 64; X2's aligned-copies is the zero-shift
    joint in every (u, v), within K1_F64 of max of it in float64; one
    launch a call."""
    x1, x2, _ = _inputs(half_t + 7 * k, half_t, n, k, h, w, gpu)
    x1b, x2b = x1.bfloat16(), x2.bfloat16()
    for rb in (16, 32, 64):
        x7 = jx.joint_fwd_v8(x1b, x2b, half_t, rb, form="wgmma")
        for mode in ("full", "rank3"):
            jx.reset_launch_counts()
            got = jx.joint_fwd_v2(x1b, x2b, half_t, mode, rb)
            assert jx.LAUNCHES == {**_NO_LAUNCH, "joint_fwd_v2": 1}
            assert torch.equal(got, x7), (mode, rb)
        jx.reset_launch_counts()
        got = jx.joint_fwd_v3(x1b, x2b, half_t, rb, form="wgmma")
        assert jx.LAUNCHES == {**_NO_LAUNCH, "joint_fwd_v3": 1}
        assert torch.equal(got, x7), rb
    ref = sj.joint_fwd_bf16_plain(x1b.double(), x2b.double(), 0)
    aligned = jx.joint_fwd_v2(x1b, x2b, half_t, "aligned-copies")
    err = float((aligned[:, :, 0, 0].double() - ref[:, :, 0, 0]).abs().max())
    assert err <= K1_F64["wgmma"] * float(ref.abs().max())


@pytest.mark.cuda
def test_x2_rb_and_input_type(gpu):
    """rb changes the passes, not the joint (within f32 summation order);
    bf16 inputs give exactly what their f32 originals give; copies-only's
    checksum and mm-only's count of terms (K1's slab walk covers each row
    once) are the same at every rb; one launch is counted per call."""
    rng = np.random.default_rng(9)
    x1 = torch.from_numpy(_maps(rng, 3, 7, 64, 64)).to(gpu)
    x2 = torch.from_numpy(_maps(rng, 3, 7, 64, 64)).to(gpu)
    jx.reset_launch_counts()
    outs = [jx.joint_fwd_v2(x1, x2, 10, rb=rb) for rb in (16, 32, 64)]
    assert jx.LAUNCHES == {**_NO_LAUNCH, "joint_fwd_v2": 3}
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-5,
                                   atol=1e-6 * float(outs[0].abs().max()))
    same = jx.joint_fwd_v2(x1.bfloat16(), x2.bfloat16(), 10, rb=16)
    assert torch.equal(same, outs[0])
    assert torch.equal(jx.joint_fwd_v2(x1, x2, 10, mode="copies-only", rb=16),
                       jx.joint_fwd_v2(x1, x2, 10, mode="copies-only", rb=64))
    for rb in (16, 32, 64):  # the count of terms issued, at each rb
        assert torch.equal(
            jx.joint_fwd_v2(x1[:1], x2[:1], 10, mode="mm-only", rb=rb),
            jx.joint_fwd_v2_plain(x1[:1], x2[:1], 10, "mm-only", rb))


@pytest.mark.cuda
@pytest.mark.parametrize("form", jx.FORMS)
@pytest.mark.parametrize("n,k,h,half_t,rb", [(2, 7, 16, 10, 16),
                                             (3, 15, 128, 10, 32),
                                             (1, 3, 20, 4, 64),
                                             (1, 17, 16, 10, 16)])
def test_x1_counts_the_terms(gpu, form, n, k, h, half_t, rb):
    """X1 multiplies tiles of ones on the tensor cores: every entry is the
    count of terms it issued, exactly its plain version's (integers under
    2^24). kT = 147, 315, 27 and 357 fill none of the 64 x 160 tiles
    whole; a descriptor that strays into the zeroed guards falls short."""
    jx.reset_launch_counts()
    out = jx.mm_probe(n, k, h, half_t, rb, form, gpu)
    tk = k * (2 * half_t + 1)
    assert out.shape == (tk, tk) and out.device.type == "cuda"
    want = jx.mm_probe_plain(n, k, h, half_t, rb, gpu)
    assert float(want[0, 0]) == n * (jx.row_window(h, half_t, rb)[1]
                                     - jx.row_window(h, half_t, rb)[0]) \
        * rb * 128
    assert torch.equal(out, want)
    assert jx.LAUNCHES == {**_NO_LAUNCH, "mm_probe": 1}


@pytest.mark.cuda
def test_x1_x2_refuse_what_they_cannot_launch(gpu):
    """Bad input raises before a launch; a launch the C entry points refuse
    (X2 in an unknown mode or over a plan that misses passes, X1 over the
    shared memory or at an odd rb) returns a CUDA error code."""
    x = torch.rand(2, 3, 8, 8, device=gpu)
    with pytest.raises(TypeError):
        jx.joint_fwd_v2(x.double(), x.double(), 2)
    with pytest.raises(ValueError):
        jx.joint_fwd_v2(x.transpose(2, 3), x, 2)
    with pytest.raises(ValueError):
        jx.joint_fwd_v2(x, x.cpu(), 2)
    with pytest.raises(ValueError):
        jx.joint_fwd_v2(x, x[:1].contiguous(), 2)
    with pytest.raises(ValueError, match="shared memory"):
        jx.mm_probe(2, 3, 8, 2, 128, "mk-nk", gpu)
    with pytest.raises(ValueError, match="even"):
        jx.mm_probe(2, 3, 8, 2, 17, "mk-kn", gpu)
    lib = jx._lib()
    xb = x.bfloat16()
    part = torch.empty(64 * 64 * 64, device=gpu)
    stream = torch.cuda.current_stream().cuda_stream
    # X2: an unknown mode; in each mode, a plan whose chunks miss passes
    args = (xb.data_ptr(), xb.data_ptr(), part.data_ptr(), part.data_ptr(),
            part.data_ptr(), part.data_ptr(), part.data_ptr(), 2, 3, 8, 8, 2,
            16)
    assert lib.joint_exp_fwd_v2(*args, 7, 2, 1, stream) != 0
    for mode in range(4):
        assert lib.joint_exp_fwd_v2(*args, mode, 1, 1, stream) != 0
    assert lib.joint_exp_mm_probe(part.data_ptr(), part.data_ptr(), 15, 128,
                                  0, 1, 1, 1, stream) != 0
    assert lib.joint_exp_mm_probe(part.data_ptr(), part.data_ptr(), 15, 17,
                                  1, 1, 1, 1, stream) != 0
    # X1's one-wave plan reads the card's slots: 3 blocks an SM at rb=16
    # (59,392 bytes of tiles each); none at rb=128
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    assert lib.joint_exp_mm_probe_slots(16, 0) == 3 * sms
    assert lib.joint_exp_mm_probe_slots(16, 1) == 3 * sms
    assert lib.joint_exp_mm_probe_slots(128, 0) < 0


def _inputs(seed, half_t, n, k, h, w, gpu):
    rng = np.random.default_rng(seed)
    t = 2 * half_t + 1
    x1 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    x2 = torch.from_numpy(_maps(rng, n, k, h, w)).to(gpu)
    g = torch.from_numpy(rng.standard_normal((k, k, t, t))
                         .astype(np.float32)).to(gpu)
    return x1, x2, g


@pytest.mark.cuda
@pytest.mark.parametrize("rb", [16, 32, 64])
@pytest.mark.parametrize("half_t,n,k,h,w", X2_SHAPES)
def test_x7_x8_match_plain(gpu, half_t, n, k, h, w, rb):
    """X7 (joint, its CUDA-core form) and X8 (dx1, dx2 through ``bwd_v8``)
    vs their plain versions at each rb: the same bf16 operands and exact
    products, so only the f32 summation order differs: rtol 1e-4, atol
    2e-5 * max. (X7's tensor-core form: test_x7_forms_run_k1s_kernel.)"""
    x1, x2, g = _inputs(half_t + k, half_t, n, k, h, w, gpu)
    jx.reset_launch_counts()
    pairs = [(jx.joint_fwd_v8(x1, x2, half_t, rb, form="cuda-core"),
              jx.joint_fwd_v8_plain(x1, x2, half_t, rb))]
    g2d, g2d_swap = sj.adjoints(g)
    dx1, dx2 = jx.bwd_v8(g, x1, x2, half_t, rb)
    pairs += [(dx1, jx.dgrad_v8_plain(g2d, x2, half_t)),
              (dx2, jx.dgrad_v8_plain(g2d_swap, x1, half_t))]
    assert jx.LAUNCHES == {**_NO_LAUNCH, "joint_fwd_v8": 1, "dgrad_v8": 2}
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == torch.float32
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-4,
                                   atol=2e-5 * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", X2_SHAPES + [(1, 2, 16, 32, 40)])
def test_x7_forms_run_k1s_kernel(gpu, half_t, n, k, h, w):
    """X7 in both forms at rb 16, 32 and 64: within K1_F64 of max of its
    bf16 function in float64, one launch a call; the tensor-core form is
    K1's kernel, so where the passes of rb rows cut the frame as K1's do
    (h a multiple of rb) it equals K1 on the same bf16 operands bit for
    bit."""
    x1, x2, _ = _inputs(half_t + 5 * k, half_t, n, k, h, w, gpu)
    x1b, x2b = x1.bfloat16(), x2.bfloat16()
    ref = jx.joint_fwd_v8_plain(x1b.double(), x2b.double(), half_t)
    scale = float(ref.abs().max())
    k1 = sj.joint_fwd(x1, x2, half_t, form="wgmma")
    for form in sj.K1_FORMS:
        for rb in (16, 32, 64):
            jx.reset_launch_counts()
            got = jx.joint_fwd_v8(x1b, x2b, half_t, rb, form=form)
            assert jx.LAUNCHES == {**_NO_LAUNCH, "joint_fwd_v8": 1}
            err = float((got.double() - ref).abs().max())
            assert err <= K1_F64[form] * scale, (form, rb, err / scale)
            if form == "wgmma" and h % rb == 0:
                assert torch.equal(got, k1), rb


@pytest.mark.cuda
def test_x8_tile_rows_and_input_type(gpu):
    """Every rb that holds the shifts gives X8 exactly the same gradient:
    rb moves the tiles and the 8-row windows, and each pixel's sum runs
    over (j chunk, v, u) in the same order in every tile and window; bf16
    inputs give exactly what their f32 originals give."""
    x1, x2, g = _inputs(3, 2, 2, 5, 40, 36, gpu)
    g2d, _ = sj.adjoints(g)
    rbs = (2, 3, 4, 8, 16, 24, 32, 64, 128)
    outs = [jx.dgrad_v8(g2d, x2, 2, rb) for rb in rbs]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert torch.equal(jx.dgrad_v8(g2d.bfloat16(), x2.bfloat16(), 2, 16),
                       outs[rbs.index(16)])


def _dgrad_v8_slab(g2d, other, half_t, rb, slab):
    """X8 through its C entry point with the patch plan ``slab`` forced."""
    n, k, h, w = other.shape
    gc, oc = jx.dgrad_v8_operands(g2d, other, half_t)
    dx = torch.empty((n, k, h, w), device=other.device)
    err = jx._bwd_lib().joint_exp_dgrad_v8(
        gc.data_ptr(), oc.data_ptr(), dx.data_ptr(), n, k, h, w, half_t, rb,
        slab, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return dx


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,k", [(2, 5), (10, 15), (4, 17)])
def test_x8_sliced_form_equals_whole_patch(gpu, half_t, k):
    """X8's sliced form (each v's 64 columns in slabs of patch rows, for h
    whose whole patch does not fit) runs the same products in the same
    order as the whole patch: forced at small h, every slab height gives
    the whole patch's bits, at rb 8, 16 and 24."""
    _, x2, g = _inputs(7 + k, half_t, 2, k, 30, 70, gpu)
    g2d, _ = sj.adjoints(g)
    ph = 8 + 2 * half_t
    for rb in (8, 16, 24):
        if rb < half_t:
            continue
        whole = _dgrad_v8_slab(g2d, x2, half_t, rb, 0)
        for slab in (1, 3, 8, ph):
            assert torch.equal(_dgrad_v8_slab(g2d, x2, half_t, rb, slab),
                               whole)


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,k,h,w", [(23, 15, 30, 70), (25, 3, 28, 66),
                                          (40, 7, 20, 40),
                                          (64, 15, 12, 80)])
def test_x8_large_half_t_matches_plain(gpu, half_t, k, h, w):
    """From h = 23 (N=16) or 25 (N=8) the wrapper plans slabs: X8 vs its
    plain version (rtol 1e-4, atol 2e-5 * max, as at small h) up to the TPU
    tool's largest h, 64, and bit-equal across rb."""
    assert jx.dgrad_v8_slab(k, half_t) > 0
    _, x2, g = _inputs(half_t + k, half_t, 1, k, h, w, gpu)
    g2d, _ = sj.adjoints(g)
    jx.reset_launch_counts()
    outs = [jx.dgrad_v8(g2d, x2, half_t, rb)
            for rb in (half_t, half_t + 5)]
    assert jx.LAUNCHES == {**_NO_LAUNCH, "dgrad_v8": 2}
    assert torch.equal(outs[0], outs[1])
    ref = jx.dgrad_v8_plain(g2d, x2, half_t).cpu().numpy()
    np.testing.assert_allclose(outs[0].cpu().numpy(), ref, rtol=1e-4,
                               atol=2e-5 * np.abs(ref).max())


def _mean_max(got, ref):
    d = (got.double() - ref.double()).abs()
    return (float(d.mean() / ref.double().abs().mean()),
            float(d.max() / ref.double().abs().max()))


# X9 also at k > 16, where its v-outer order differs from X8's: three j
# chunks held whole, and k=40 at h=10, where they do not fit (sliced form)
X9_SHAPES = X2_SHAPES + [(3, 2, 33, 24, 70), (10, 1, 40, 20, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", X9_SHAPES)
def test_x9_matches_plain(gpu, half_t, n, k, h, w):
    """X9 (one launch, dx1 and dx2) vs its plain version: each p_v is
    rounded to bf16, and a last-bit difference in the f32 partial can move
    it across a rounding boundary, so the criterion is mean |d| / mean |ref|
    <= 1e-5 and max |d| <= 2e-3 * max |ref|. X8's unrounded pair fails the
    mean criterion: the check sees a lost rounding."""
    x1, x2, g = _inputs(half_t + 2 * k, half_t, n, k, h, w, gpu)
    jx.reset_launch_counts()
    got = jx.dgrad_fused_v7(g, x1, x2, half_t)
    assert jx.LAUNCHES == {**_NO_LAUNCH, "dgrad_fused_v7": 1}
    ref = jx.dgrad_fused_v7_plain(g, x1, x2, half_t)
    unrounded = jx.bwd_v8(g, x1, x2, half_t)
    for a, r, u in zip(got, ref, unrounded):
        assert a.shape == r.shape == (n, k, h, w)
        mean, mx = _mean_max(a, r)
        assert mean <= 1e-5 and mx <= 2e-3, (mean, mx)
        assert _mean_max(u, r)[0] > 1e-4


def _fused_v7_slab(g, x1, x2, half_t, rb, slab):
    """X9 through its C entry point with the patch plan ``slab`` forced."""
    n, k, h, w = x1.shape
    g2d, g2d_swap = sj.adjoints(g)
    gc1, oc1 = jx.dgrad_v8_operands(g2d, x2, half_t, 16)  # X9's N
    gc2, oc2 = jx.dgrad_v8_operands(g2d_swap, x1, half_t, 16)
    dx1 = torch.empty((n, k, h, w), device=x1.device)
    dx2 = torch.empty_like(dx1)
    err = jx._bwd_lib().joint_exp_dgrad_fused_v7(
        gc1.data_ptr(), oc1.data_ptr(), gc2.data_ptr(), oc2.data_ptr(),
        dx1.data_ptr(), dx2.data_ptr(), n, k, h, w, half_t, rb, slab,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return dx1, dx2


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,k", [(2, 5), (10, 15), (4, 17), (3, 33),
                                      (10, 3)])
def test_x9_sliced_form_equals_whole_patch(gpu, half_t, k):
    """X9's sliced form (each (v, j chunk)'s 64 columns in slabs of patch
    rows) runs the whole patches' products in the same order: forced at
    small h, every slab height gives the whole form's bits, and rb moves
    no bit either (each pixel sums over v, then j chunk and u, in the same
    order in every tile and window)."""
    x1, x2, g = _inputs(5 + k, half_t, 2, k, 30, 70, gpu)
    whole = _fused_v7_slab(g, x1, x2, half_t, 16, 0)
    for rb, slab in ((16, 1), (16, 3), (16, 8 + 2 * half_t), (8, 5),
                     (24, 0), (3, 0)):
        got = _fused_v7_slab(g, x1, x2, half_t, rb, slab)
        for a, b in zip(got, whole):
            assert torch.equal(a, b), (rb, slab)


@pytest.mark.cuda
def test_x7_x8_x9_refuse_what_they_cannot_launch(gpu):
    """Bad input raises before a launch; rb under the TPU tool's asserts
    and X9's half_t over the TPU tool's are refused on every device; a
    launch a C entry point refuses (rb 0, a negative slab, a whole patch
    over the shared memory) returns a CUDA error code."""
    x = torch.rand(2, 3, 8, 8, device=gpu)
    g = torch.rand(3, 3, 5, 5, device=gpu)
    g2d, _ = sj.adjoints(g)
    with pytest.raises(TypeError):
        jx.joint_fwd_v8(x.double(), x.double(), 2)
    with pytest.raises(ValueError):
        jx.joint_fwd_v8(x, x.cpu(), 2)
    with pytest.raises(ValueError):
        jx.dgrad_v8(g2d[:4], x, 2)
    with pytest.raises(TypeError):
        jx.dgrad_v8(g2d.double(), x, 2)
    with pytest.raises(ValueError, match="2\\*half_t"):
        jx.dgrad_v8(g2d, x, 2, rb=1)
    with pytest.raises(ValueError):
        jx.dgrad_fused_v7(g[:2], x, x, 2)
    with pytest.raises(ValueError, match="2\\*half_t"):
        jx.dgrad_fused_v7(torch.rand(3, 3, 131, 131, device=gpu), x, x, 65)
    lib = jx._bwd_lib()
    xb = x.bfloat16()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    gc, oc = jx.dgrad_v8_operands(g2d, xb, 2)
    for half_t, rb, slab in ((2, 0, 0), (2, 16, -1), (63, 64, 0)):
        assert lib.joint_exp_dgrad_v8(gc.data_ptr(), oc.data_ptr(),
                                      out.data_ptr(), 2, 3, 8, 8, half_t, rb,
                                      slab, stream) != 0
        assert lib.joint_exp_dgrad_fused_v7(
            gc.data_ptr(), oc.data_ptr(), gc.data_ptr(), oc.data_ptr(),
            out.data_ptr(), out.data_ptr(), 2, 3, 8, 8, half_t, rb, slab,
            stream) != 0


# X3 at every rb and flat in its default form, X3, X4 and X5 at every rb
# in each form, X6 at both roll_build in each form
PIPE = ([("joint_fwd_v3", {"rb": rb, "flat": flat})
         for rb in (16, 32, 64) for flat in (True, False)]
        + [(name, {"rb": rb, "form": f})
           for name in ("joint_fwd_v3", "joint_fwd_v4", "joint_fwd_v5")
           for f in jx.X_FORMS for rb in (16, 32, 64)]
        + [("joint_fwd_v6", {"roll_build": roll, "form": f})
           for f in jx.X_FORMS for roll in (False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", X2_SHAPES)
def test_x3_x6_match_plain(gpu, half_t, n, k, h, w):
    """X3-X6 (each in both forms) vs X2's plain version: the same
    bf16 operands (X6 rounds its f32 inputs itself) and exact products, so
    only the f32 summation order differs: rtol 1e-4, atol 2e-5 * max. One
    launch is counted per call."""
    x1, x2, _ = _inputs(half_t + 3 * k, half_t, n, k, h, w, gpu)
    ref = jx.joint_fwd_v2_plain(x1, x2, half_t).cpu().numpy()
    t = 2 * half_t + 1
    for name, kwargs in PIPE:
        jx.reset_launch_counts()
        got = getattr(jx, name)(x1, x2, half_t, **kwargs)
        assert jx.LAUNCHES == {**_NO_LAUNCH, name: 1}
        assert got.shape == (k, k, t, t) and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-4,
                                   atol=2e-5 * np.abs(ref).max(),
                                   err_msg=f"{name} {kwargs}")


@pytest.mark.cuda
@pytest.mark.parametrize("half_t,n,k,h,w", X2_SHAPES)
def test_x3_x5_x6_sum_in_x7_order(gpu, half_t, n, k, h, w):
    """In each form X3 and X5 add the same terms in the order of X7 in
    that form, so at one rb they equal it bit for bit: on the CUDA cores
    the same stages (X5's priming and padding products add zeros), on the
    tensor cores K1's products in K1's order, fed by TMA (X3 one slab at a
    time, X5 two from static slots). So does X4 on the tensor cores (one
    slab from the slot a branch on its parity picks; its CUDA-core form
    adds each stage's staged product, another order). The form is named
    in every call: the
    default is the tensor cores at k > 4. In each form X6 equals X5 on
    inputs the wrapper rounds, and roll_build=True equals False, bit for
    bit."""
    x1, x2, _ = _inputs(half_t + 4 * k, half_t, n, k, h, w, gpu)
    for form in jx.X_FORMS:
        for rb in (16, 32, 64):
            x7 = jx.joint_fwd_v8(x1, x2, half_t, rb, form=form)
            x3 = jx.joint_fwd_v3(x1, x2, half_t, rb, form=form)
            assert torch.equal(x3, x7), (form, rb)
            assert torch.equal(jx.joint_fwd_v3(x1, x2, half_t, rb, False,
                                               form=form), x7), (form, rb)
            if form == "wgmma":
                x4 = jx.joint_fwd_v4(x1, x2, half_t, rb, form=form)
                assert torch.equal(x4, x7) and torch.equal(x4, x3), rb
            x5 = jx.joint_fwd_v5(x1, x2, half_t, rb, form=form)
            assert torch.equal(x5, x7) and torch.equal(x5, x3), (form, rb)
        x6 = jx.joint_fwd_v6(x1, x2, half_t, form=form)
        assert torch.equal(x6, jx.joint_fwd_v5(x1.bfloat16(), x2.bfloat16(),
                                               half_t, 16, form=form)), form
        assert torch.equal(jx.joint_fwd_v6(x1, x2, half_t, roll_build=True,
                                           form=form), x6), form


@pytest.mark.cuda
def test_x3_x6_refuse_what_they_cannot_launch(gpu):
    """Bad input raises before a launch; the TPU tool's asserts are refused
    on the card too (X6 has no rb: half_t=10 runs where X3-X5 at rb=8
    refuse it), in each form of X3-X6, which refuse any other form; a
    launch the C entry points refuse (no chunks) returns a CUDA error
    code."""
    x = torch.rand(2, 3, 8, 8, device=gpu)
    formed = (jx.joint_fwd_v3, jx.joint_fwd_v4, jx.joint_fwd_v5,
              jx.joint_fwd_v6)
    calls = [(fn, {"form": f}) for fn in formed for f in jx.X_FORMS]
    for fn, kw in calls:
        with pytest.raises(TypeError):
            fn(x.double(), x.double(), 2, **kw)
        with pytest.raises(ValueError):
            fn(x, x.cpu(), 2, **kw)
        with pytest.raises(ValueError):
            fn(x.transpose(2, 3), x, 2, **kw)
        with pytest.raises(ValueError):
            fn(x, x[:1].contiguous(), 2, **kw)
        with pytest.raises(ValueError, match="2\\*half_t"):
            fn(x, x, 65, **kw)
        if fn is jx.joint_fwd_v6:
            assert fn(x, x, 10, **kw).shape == (3, 3, 21, 21)
        else:
            with pytest.raises(ValueError, match="2\\*half_t"):
                fn(x, x, 10, rb=8, **kw)
    for fn in formed:
        with pytest.raises(ValueError, match="form"):
            fn(x, x, 2, form="cudnn")
    lib = jx._pipe_lib()
    xb = x.bfloat16()
    part = torch.empty(64 * 64, device=gpu)
    stream = torch.cuda.current_stream().cuda_stream
    args = (part.data_ptr(), part.data_ptr(), 2, 3, 8, 8, 2)
    for v in ("v3", "v4", "v5"):
        entry = getattr(lib, f"joint_exp_fwd_{v}")
        assert entry(xb.data_ptr(), xb.data_ptr(), *args, 0, 16, stream) != 0
    assert lib.joint_exp_fwd_v6(x.data_ptr(), x.data_ptr(), *args, 1, 0, 16,
                                stream) != 0
    # the tensor-core forms of X3-X6 (X6 at both roll_build): no chunks,
    # or chunks that miss passes
    lib = jx._tma_lib()
    entries = [lib.joint_exp_fwd_v3_tma, lib.joint_exp_fwd_v4_tma,
               lib.joint_exp_fwd_v5_tma] + [
        lambda *a, roll=roll: lib.joint_exp_fwd_v6_tma(*a[:-1], roll, a[-1])
        for roll in (0, 1)]
    for tma in entries:
        for per, splits in ((1, 0), (1, 1)):
            assert tma(xb.data_ptr(), xb.data_ptr(), part.data_ptr(),
                       part.data_ptr(), part.data_ptr(), part.data_ptr(), 2,
                       3, 8, 8, 2, 16, per, splits, stream) != 0


def _bf16_nets(gpu, arch, extra):
    """The net in bf16 on the CPU and an identical copy on the card."""
    import copy
    from types import SimpleNamespace
    from iic_tpu_torch import models
    cfg = SimpleNamespace(arch=arch, output_k_A=6, output_k_B=3,
                          num_sub_heads=2, batchnorm_track=True,
                          model_dtype="bfloat16", **extra)
    torch.manual_seed(0)
    cpu = models.build(arch, cfg)
    return cpu, copy.deepcopy(cpu).to(gpu)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
def test_bf16_seg_forward_on_the_card_matches_the_cpu(gpu, train):
    """SegmentationNet10aTwoHead in bf16: cuDNN's forward against the CPU's
    on the same weights and input. f32 softmax maps; mean |d| <= 1e-3, max
    |d| <= 2e-2 (twice the bounds that hold the CPU forward to the JAX
    bf16 net in tests/test_torch_bf16.py: two bf16 forwards differ where
    a rounding falls the other way)."""
    cpu, card = _bf16_nets(gpu, "SegmentationNet10aTwoHead",
                           dict(in_channels=5, input_sz=24))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 5, 24, 24)).astype(np.float32))
    cpu.train(train)
    card.train(train)
    with torch.no_grad():
        ref = cpu(x, head="A")
        got = card(x.to(gpu), head="A").cpu()
    assert got.dtype == ref.dtype == torch.float32
    d = (got - ref).abs()
    assert float(d.mean()) <= 1e-3 and float(d.max()) <= 2e-2, (
        float(d.mean()), float(d.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
def test_bf16_cluster_block_on_the_card_matches_the_cpu(gpu, train):
    """ClusterNet5gTwoHead in bf16: layer 2's first block (downsample,
    residual add) on the card against the CPU on the same bf16 input, mean
    |d| / mean |ref| <= 2e-4 (the bound of the CPU block against the JAX
    bf16 block; f32 is 3.6e-3 off), and the whole net's f32 outputs
    finite."""
    cpu, card = _bf16_nets(gpu, "ClusterNet5gTwoHead",
                           dict(in_channels=2, output_k=3, input_sz=32))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 64, 17, 17)).astype(
        np.float32)).bfloat16()
    cpu.train(train)
    card.train(train)
    with torch.no_grad():
        ref = cpu.trunk.layer2[0](x).float()
        got = card.trunk.layer2[0](x.to(gpu)).float().cpu()
        out = card(torch.from_numpy(rng.standard_normal(
            (8, 2, 32, 32)).astype(np.float32)).to(gpu), head="B")
    err = float((got - ref).abs().mean() / ref.abs().mean())
    assert err <= 2e-4, err
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_prefetch_batches_equal_the_synchronous_upload(gpu):
    """Both train pipelines on the card: the batches behind the prefetch
    thread (copy stream, event, record_stream) equal the synchronous
    uploads and the CPU pipeline's batches bit for bit, and so do the
    augmentation draws of each batch's generator."""
    from iic_tpu_torch.cli._args import parse_cluster_args, parse_seg_args
    from iic_tpu_torch.data.pipeline import ClusterTrainPipeline
    from iic_tpu_torch.data.prefetch import ThreadedPrefetch
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline

    seg = parse_seg_args([
        "--mode", "IID", "--dataset", "SyntheticSeg3x48x16",
        "--dataset_root", "", "--batch_sz", "4", "--num_dataloaders", "1",
        "--input_sz", "32", "--include_rgb"]).finalize(twohead=True)
    clu = parse_cluster_args([
        "--dataset", "Synthetic10x32x3x16", "--dataset_root", "",
        "--batch_sz", "12", "--num_dataloaders", "3", "--crop_orig",
        "--rand_crop_sz", "20", "--input_sz", "32"])
    clu.finalize(twohead=True, sobel=True)
    for make in (lambda d: SegTrainPipeline(seg, ["train"], seed=3,
                                            device=d),
                 lambda d: ClusterTrainPipeline(clu, [True, False], seed=3,
                                                device=d)):
        ref = list(make("cpu").epoch(1))
        pipe = make(gpu)
        sync = list(pipe.epoch(1))
        threaded = list(ThreadedPrefetch(pipe.epoch(1), depth=2))
        assert len(ref) == len(sync) == len(threaded) > 1
        for r, s, t in zip(ref, sync, threaded):
            *r_data, _ = r
            *s_data, s_gen = s
            *t_data, t_gen = t
            for a, b, c in zip(r_data, s_data, t_data):
                assert b.device.type == c.device.type == "cuda"
                assert torch.equal(a, b.cpu()) and torch.equal(a, c.cpu())
            assert torch.equal(torch.rand(4, generator=s_gen, device=gpu),
                               torch.rand(4, generator=t_gen, device=gpu))


@pytest.mark.cuda
def test_native_batches_upload_bit_equal(gpu):
    """The native host prep (built by g++ on the card's host) behind
    DeviceUpload: the batches on the card equal the CPU pipeline's native
    and numpy batches bit for bit."""
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline

    cfg = parse_seg_args([
        "--mode", "IID", "--dataset", "SyntheticSegPotsdam3x48x16",
        "--dataset_root", "", "--batch_sz", "4", "--num_dataloaders", "1",
        "--input_sz", "32", "--include_rgb"]).finalize(twohead=True)
    on_card = SegTrainPipeline(cfg, ["train"], seed=3, device=gpu,
                               use_native=True)
    assert on_card._native is not None
    got = list(on_card.epoch(1))
    for use_native in (True, False):
        ref = list(SegTrainPipeline(cfg, ["train"], seed=3,
                                    use_native=use_native).epoch(1))
        assert len(ref) == len(got) > 1
        for (gi, gm, _), (ri, rm, _) in zip(got, ref):
            assert gi.device.type == gm.device.type == "cuda"
            assert gi.shape[-1] == 4
            assert torch.equal(gi.cpu(), ri) and torch.equal(gm.cpu(), rm)


@pytest.mark.cuda
def test_greyscale_augment_pair_on_the_card_matches_the_cpu(gpu):
    """Model 685's tf1 and tf2 (rotation, the choice crop grouped by size,
    the resize, jitter) on the card against the CPU, given the same draws:
    within 1e-5 (grid_sample's and the resize's f32 sums)."""
    from iic_tpu_torch.data.transforms import make_greyscale_pair_transforms
    from iic_tpu_torch.train.config import ClusterConfig
    cfg = ClusterConfig(
        crop_orig=True, crop_other=True, tf1_crop="centre_half",
        tf2_crop="random", tf1_crop_sz=20, tf2_crop_szs=(16, 20, 24),
        input_sz=24, rot_val=25.0, no_flip=True).finalize(sobel=False)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((140, 28, 28, 1)).astype(np.float32))
    for tf in make_greyscale_pair_transforms(cfg)[:2]:
        draws = tf.draw(140, 28, 28, torch.Generator().manual_seed(1), "cpu")
        ref = tf.apply(img, draws)
        got = tf.apply(img.to(gpu), {k: v.to(gpu) for k, v in draws.items()})
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.cuda
def test_net6c_twohead_steps_on_the_card_match_the_cpu(gpu):
    """Two ClusterNet6cTwoHead steps (heads A, B; K3 on the card, its
    plain version on the CPU) from the same weights on the same batch:
    losses within 1e-4, with TF32 off so that both sides convolve in f32."""
    import copy
    from types import SimpleNamespace
    from iic_tpu_torch import models
    from iic_tpu_torch.parallel.train_step import (
        make_cluster_train_step, make_optimizer)
    cfg = SimpleNamespace(arch="ClusterNet6cTwoHead", in_channels=1,
                          output_k_A=50, output_k_B=10, num_sub_heads=5,
                          input_sz=24, batchnorm_track=True, opt="Adam",
                          lr=1e-4)
    torch.manual_seed(0)
    nets = {"cpu": models.build(cfg.arch, cfg)}
    nets["card"] = copy.deepcopy(nets["cpu"]).to(gpu)
    rng = np.random.default_rng(3)
    batch = [rng.random((140, 1, 24, 24)).astype(np.float32)]
    batch.append(np.clip(batch[0] + 0.1 * rng.standard_normal(
        batch[0].shape), 0, 1).astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        losses = {}
        for where, net in nets.items():
            dev = torch.device("cpu") if where == "cpu" else gpu
            opt = make_optimizer(net, cfg)
            losses[where] = [float(make_cluster_train_step(
                net, opt, None, lamb=1.0, head=h, loss_impl="fused")(
                tuple(torch.from_numpy(x).to(dev) for x in batch))[0])
                for h in "AB"]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(losses["card"], losses["cpu"], atol=1e-4)
    assert all(np.isfinite(losses["card"]))


@pytest.mark.cuda
def test_sobel_tf2_with_affine_and_cutout_on_the_card_matches_the_cpu(gpu):
    """Table 3's sobel tf2 (crop, random affine, cutout, resize, flip,
    jitter) on the card against the CPU, given the same draws: within 3e-5
    (the warp's bilinear sums in f32, then brightness and contrast factors
    of up to 1.4 each and the hue's round trip through HSV: 1.7e-5 on 8 of
    2.3M values on an H100; the greyscale tf2, without hue, holds 1e-5)."""
    from types import SimpleNamespace
    from iic_tpu_torch.data.transforms import make_sobel_pair_transforms
    cfg = SimpleNamespace(include_rgb=True, crop_orig=True, rand_crop_sz=64,
                          input_sz=64, use_random_affine=True, affine_p=0.5,
                          cutout=True, cutout_p=0.5, cutout_max_box=0.7)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((140, 96, 96, 3)).astype(np.float32))
    tf2 = make_sobel_pair_transforms(cfg)[1]
    draws = tf2.draw(140, 96, 96, torch.Generator().manual_seed(1), "cpu")
    assert 0 < int(draws["affine"].sum()) < 140
    assert 0 < int(draws["cutout"].sum()) < 140
    ref = tf2.apply(img, draws)
    got = tf2.apply(img.to(gpu), {k: v.to(gpu) for k, v in draws.items()})
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=3e-5)


@pytest.mark.cuda
def test_semisup_steps_on_the_card_match_the_cpu(gpu):
    """Two finetune steps (ResNet-34 trunk read before layer4, SupHead5,
    cross-entropy, one Adam with a trunk and a head group) from the same
    weights on the same batch: losses within 1e-4, with TF32 off so that
    both sides convolve in f32."""
    import copy
    from types import SimpleNamespace
    from iic_tpu_torch import models
    from iic_tpu_torch.models.semisup import SemisupNet, SupHead5Head
    from iic_tpu_torch.parallel.train_step import (
        make_semisup_optimizer, make_semisup_train_step)
    cfg = SimpleNamespace(arch="ClusterNet5g", in_channels=2, output_k=70,
                          num_sub_heads=5, input_sz=32, batchnorm_track=True)
    torch.manual_seed(0)
    models_ = {"cpu": SemisupNet(models.build(cfg.arch, cfg),
                                 SupHead5Head(256 * 5 * 5, 10), True)}
    models_["card"] = copy.deepcopy(models_["cpu"]).to(gpu)
    rng = np.random.default_rng(3)
    imgs = rng.random((64, 2, 32, 32)).astype(np.float32)
    labels = rng.integers(0, 10, 64)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        losses = {}
        for where, model in models_.items():
            dev = torch.device("cpu") if where == "cpu" else gpu
            step = make_semisup_train_step(
                model, make_semisup_optimizer(model, 1e-4, 1e-3))
            batch = (torch.from_numpy(imgs).to(dev),
                     torch.from_numpy(labels).to(dev))
            losses[where] = [float(step(batch)) for _ in range(2)]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(losses["card"], losses["cpu"], atol=1e-4)
    assert all(np.isfinite(losses["card"]))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(50_000, 512, 3), (50_000, 512, 15),
                                   (10_000, 512, 10)])
def test_device_kmeans_matches_its_float64_replay(gpu, n, d, k):
    """The port's k-means on the card (f32, the distances through one
    matmul) against the same Lloyd iterations in float64 on the CPU
    (``replay_float64``): each iteration's labels equal but for points
    within 1e-6 (relative) of a tie, each M-step's centroids within 1e-4
    of max, on overlapping relu'd Gaussian clusters; on separated
    clusters, accuracy 1.0 after the Hungarian match."""
    from iic_tpu_torch.evals.kmeans_eval import (
        KMeans, kmeans_cluster_assess, replay_float64)

    rng = np.random.default_rng(k)
    centres = rng.standard_normal((k, d)).astype(np.float32)
    truth = rng.integers(0, k, n)
    noise = rng.standard_normal((n, d)).astype(np.float32)
    x = torch.from_numpy(np.maximum(0.15 * centres[truth] + noise, 0))
    km = KMeans(k, seed=0).fit(x.to(gpu))
    rep = replay_float64(x.to(gpu), km)
    assert rep["mismatches"] == 0, rep
    assert rep["centre_err"] <= 1e-4, rep
    blobs = torch.from_numpy(3.0 * centres[truth] + noise)
    assert kmeans_cluster_assess(blobs.to(gpu), truth, k) == 1.0


# ------------------------------------------------------ data parallelism

@pytest.mark.cuda
def test_sync_batch_norm_on_the_card_matches_the_cpu(gpu):
    """``SyncBatchNorm2d`` without a mesh (var = E[x^2] - E[x]^2 on the
    rank's rows): its train-mode output, input and weight gradients and
    running statistics on the card within rtol 1e-4 / atol 1e-5 of the CPU's,
    in f32 and on a bf16 input."""
    from iic_tpu_torch.models.layers import SyncBatchNorm2d

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 8, 5, 7)).astype(
        np.float32) * 2 + 1)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        out = {}
        for dev in ("cpu", gpu):
            bn = SyncBatchNorm2d(8).to(dev)
            with torch.no_grad():
                bn.weight.copy_(torch.linspace(0.5, 1.5, 8))
            xi = x.to(dev, dtype).detach().requires_grad_()
            y = bn(xi)
            (y.float() * g.to(dev)).sum().backward()
            out[str(dev)] = [t.detach().float().cpu() for t in (
                y, xi.grad, bn.weight.grad, bn.running_mean,
                bn.running_var)]
        for a, b in zip(out["cpu"], out[str(gpu)]):
            tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                       atol=tol)


def _world_one_rank(device):
    """One NCCL rank: the differentiable all-reduces and a synced BN at
    world size 1."""
    from iic_tpu_torch.models.layers import SyncBatchNorm2d
    from iic_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(1, device)
    x = torch.arange(6.0, device=device).requires_grad_()
    out = {}
    for name, fn in (("joint", mesh_lib.all_reduce_joint),
                     ("stats", mesh_lib.all_reduce_stats)):
        y = fn(x * 2, mesh)
        (y * torch.arange(6.0, device=device)).sum().backward()
        out[name] = (y.detach().cpu(), x.grad.detach().cpu().clone())
        x.grad = None
    inp = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    bns = [SyncBatchNorm2d(3, mesh=m).to(device) for m in (mesh, None)]
    out["bn"] = [bn(inp.to(device)).detach().cpu() for bn in bns]
    return out


@pytest.mark.cuda
def test_all_reduce_at_world_size_one_over_nccl(gpu):
    """A spawned rank over NCCL at world size 1: both all-reduces return
    their input and the gradient unchanged (the sum over one rank), and a
    synced BN over the group equals it without a mesh."""
    from iic_tpu_torch.parallel.mesh import spawn

    out, = spawn(_world_one_rank, 1, device_type="cuda", timeout=600)
    for name in ("joint", "stats"):
        y, grad = out[name]
        assert torch.equal(y, torch.arange(6.0) * 2)
        assert torch.equal(grad, torch.arange(6.0) * 2)
    assert torch.equal(*out["bn"])


def _seg_step_rank(device, n_ranks, cfg, state, batch, rows_order=None):
    """Model 555's head-A step (k 15, T=21, K1 and K2) with --bn_sync on a
    fixed batch: this rank's shard (or, without a group, one process on the
    whole batch in ``rows_order``); TF32 off, SGD. Returns (loss, grads)."""
    from iic_tpu_torch import models
    from iic_tpu_torch.models.layers import sync_batch_norm
    from iic_tpu_torch.parallel.mesh import make_mesh
    from iic_tpu_torch.parallel.train_step import make_seg_train_step

    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(n_ranks, device) if n_ranks else None
    net = models.build("SegmentationNet10aTwoHead", cfg).to(device)
    net.load_state_dict(state)
    sync_batch_norm(net, mesh)
    step = make_seg_train_step(
        net, torch.optim.SGD(net.parameters(), lr=0.05), lamb=1.0, head="A",
        half_T_side_dense=10, half_T_side_sparse_min=0,
        half_T_side_sparse_max=0, sobel=True, include_rgb=True,
        use_uncollapsed_loss=True, mesh=mesh)
    n = len(batch[0])
    if mesh is not None:
        rows = slice(mesh.rank * n // n_ranks, (mesh.rank + 1) * n // n_ranks)
    else:
        rows = rows_order if rows_order is not None else slice(None)
    loss, _ = step(tuple(x[rows].to(device) for x in batch))
    return float(loss), {k: p.grad.detach().cpu()
                         for k, p in net.named_parameters()}


def _seg_step_inputs():
    """(config, state_dict, batch of 8 pairs at 64^2) made from seeds."""
    from types import SimpleNamespace

    from iic_tpu_torch import models

    cfg = SimpleNamespace(in_channels=5, output_k_A=15, output_k_B=3,
                          num_sub_heads=1, input_sz=64, batchnorm_track=True)
    torch.manual_seed(0)
    state = models.build("SegmentationNet10aTwoHead", cfg).state_dict()
    g = torch.Generator().manual_seed(1)
    img1 = torch.rand(8, 4, 64, 64, generator=g)
    img2 = (img1 + 0.1 * torch.randn(img1.shape, generator=g)).clamp(0, 1)
    aff = torch.eye(2, 3).expand(8, 2, 3).contiguous()
    mask = (torch.rand(8, 64, 64, generator=g) > 0.1).float()
    return cfg, state, (img1, img2, aff, mask)


def _seg_step_spawned(device, n_ranks):
    return _seg_step_rank(device, n_ranks, *_seg_step_inputs())


@pytest.mark.cuda
def test_two_rank_seg_step_equals_one_rank(gpu):
    """Where two cards are visible: 2 NCCL ranks of the seg step (K1 and
    K2 on each rank's 4 of 8 pairs at 64^2, k 15, T=21, --bn_sync, TF32
    off) against one card on the whole batch: the loss and every gradient
    within 4x (and 1e-4 of max at least) what one card moves by itself on
    the batch reversed (the f32 noise of the synced BN's E[x^2] - E[x]^2
    and of K1's split-K sums)."""
    from iic_tpu_torch.parallel.mesh import spawn

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    two = spawn(_seg_step_spawned, 2, args=(2,), device_type="cuda",
                timeout=600)
    inputs = _seg_step_inputs()
    ref = _seg_step_rank(gpu, 0, *inputs)
    rev = _seg_step_rank(gpu, 0, *inputs, torch.arange(7, -1, -1))
    big = max(float(v.abs().max()) for v in ref[1].values())

    def err(got):
        return (abs(got[0] - ref[0]) / abs(ref[0]),
                max(float((got[1][k] - v).abs().max())
                    for k, v in ref[1].items()) / big)

    floor = err(rev)
    for got in two:
        for e, f in zip(err(got), floor):
            assert e <= max(4 * f, 1e-4), (err(got), floor)
