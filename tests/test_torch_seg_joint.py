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
from iic_tpu.ops.pallas.seg_joint_kernel import _dgrad_pallas
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


def test_wrapper_refuses_mixed_devices():
    x = torch.rand(2, 3, 6, 6)
    with pytest.raises(ValueError):
        sj.joint_fwd(x, x.to("meta"), 1)
