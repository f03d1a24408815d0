"""The port's CUDA kernels K1 / K2 on the card, against their plain
PyTorch versions. Every test here needs an NVIDIA GPU and skips without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from iic_tpu_torch.ops import iid_seg_loss
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
    (4, 1, 1, 5, 70)])
def test_kernels_match_plain(gpu, half_t, n, k, h, w):
    """K1 and K2 (dx1, dx2) vs their plain versions: the JAX package's
    kernel contract, rtol 5e-3, atol 5e-3 * max."""
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


@pytest.mark.cuda
def test_loss_through_kernels_matches_conv(gpu):
    """The uncollapsed loss and its gradient with joint_impl="pallas" (the
    kernels, which must launch) vs "conv": rtol 1e-3 on the loss, atol
    1e-3 * max on the gradient."""
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
    np.testing.assert_allclose(grad_k, grad_c, atol=1e-3 * np.abs(grad_c).max())


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
