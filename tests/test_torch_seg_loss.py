"""The port's segmentation losses (iic_tpu_torch/ops/iid_seg_loss.py)
against the JAX package's, values and gradients, with the JAX warp on its
exact path (warp_impl="gather"). Inputs are made from a numpy seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu.ops import iid_seg_loss as jl
from iic_tpu_torch.ops import iid_seg_loss as tl


def _inputs(seed, n=3, k=4, hw=12):
    rng = np.random.default_rng(seed)

    def sm():
        z = 2.0 * rng.standard_normal((n, k, hw, hw)).astype(np.float32)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    angles = np.radians(rng.uniform(-20, 20, n))
    scale = rng.uniform(0.9, 1.1, n)
    aff = np.zeros((n, 2, 3), np.float32)
    aff[:, 0, 0] = np.cos(angles) * scale
    aff[:, 0, 1] = -np.sin(angles) * scale
    aff[:, 1, 0] = np.sin(angles) * scale
    aff[:, 1, 1] = np.cos(angles) * scale
    aff[::2, 0, :] *= -1.0  # some flipped samples
    mask = (rng.random((n, hw, hw)) > 0.2).astype(np.float32)
    return sm(), sm(), aff, mask


CASES = [("collapsed", 1, "conv"), ("collapsed", 0, "conv"),
         ("uncollapsed", 2, "conv"), ("uncollapsed", 2, "pallas"),
         ("uncollapsed", 0, "pallas")]


def _jax_loss(kind, half_t, lamb):
    def f(x1, x2, aff, mask):
        if kind == "collapsed":
            return jl.IID_segmentation_loss(
                x1, x2, aff, mask, lamb=lamb, half_T_side_dense=half_t,
                half_T_side_sparse_min=0, half_T_side_sparse_max=0,
                warp_impl="gather")
        return jl.IID_segmentation_loss_uncollapsed(
            x1, x2, aff, mask, lamb=lamb, half_T_side_dense=half_t,
            half_T_side_sparse_min=0, half_T_side_sparse_max=0,
            warp_impl="gather", joint_impl="conv")
    return f


def _torch_loss(kind, half_t, lamb, joint_impl):
    def f(x1, x2, aff, mask):
        if kind == "collapsed":
            return tl.IID_segmentation_loss(
                x1, x2, aff, mask, lamb=lamb, half_T_side_dense=half_t,
                half_T_side_sparse_min=0, half_T_side_sparse_max=0)
        return tl.IID_segmentation_loss_uncollapsed(
            x1, x2, aff, mask, lamb=lamb, half_T_side_dense=half_t,
            half_T_side_sparse_min=0, half_T_side_sparse_max=0,
            joint_impl=joint_impl)
    return f


@pytest.mark.parametrize("kind,half_t,joint_impl", CASES)
def test_loss_values_match_jax(kind, half_t, joint_impl):
    """(loss, loss_no_lamb) within 1e-5 absolute + 1e-4 relative (f32
    summation order; the losses are O(0.1-1))."""
    x1, x2, aff, mask = _inputs(half_t + len(kind))
    lamb = 1.3
    ref = _jax_loss(kind, half_t, lamb)(*map(jnp.asarray, (x1, x2, aff,
                                                            mask)))
    got = _torch_loss(kind, half_t, lamb, joint_impl)(
        *map(torch.from_numpy, (x1, x2, aff, mask)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind,half_t,joint_impl", CASES)
def test_loss_gradients_match_jax(kind, half_t, joint_impl):
    """d loss / d (x1, x2): rtol 1e-3, atol 1e-4 * max|grad| (the gradient
    runs through logs of small joint entries)."""
    x1, x2, aff, mask = _inputs(40 + half_t)
    lamb = 1.0
    jf = _jax_loss(kind, half_t, lamb)
    gj = jax.grad(lambda a, b: jf(a, b, jnp.asarray(aff),
                                  jnp.asarray(mask))[0],
                  argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    a = torch.from_numpy(x1).requires_grad_()
    b = torch.from_numpy(x2).requires_grad_()
    loss = _torch_loss(kind, half_t, lamb, joint_impl)(
        a, b, torch.from_numpy(aff), torch.from_numpy(mask))[0]
    gt = torch.autograd.grad(loss, (a, b))
    for g, r in zip(gt, gj):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max())


def test_box_sum_matches_jax():
    x = np.random.default_rng(0).random((2, 3, 9, 7)).astype(np.float32)
    ref = np.asarray(jl._box_sum(jnp.asarray(x), 2))
    got = tl._box_sum(torch.from_numpy(x), 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_random_translation_is_a_zero_filled_shift():
    """Same semantics as the JAX version (different random stream): the
    output is the input shifted by one (dx, dy) with |d| in [min, max]."""
    x = torch.arange(2 * 1 * 6 * 6, dtype=torch.float32).reshape(2, 1, 6, 6)
    g = torch.Generator().manual_seed(3)
    out = tl.random_translation_multiple(x, 1, 2, generator=g)
    found = []
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            pad = torch.nn.functional.pad(x, (2, 2, 2, 2))
            cand = pad[:, :, 2 + dy:8 + dy, 2 + dx:8 + dx]
            if torch.equal(cand, out):
                found.append((dy, dx))
    assert len(found) == 1
    assert all(1 <= abs(d) <= 2 for d in found[0])


def test_fft_joint_refused():
    x1, x2, aff, mask = map(torch.from_numpy, _inputs(0))
    with pytest.raises(NotImplementedError):
        tl.IID_segmentation_loss_uncollapsed(
            x1, x2, aff, mask, half_T_side_dense=1,
            half_T_side_sparse_min=0, half_T_side_sparse_max=0,
            joint_impl="fft")
