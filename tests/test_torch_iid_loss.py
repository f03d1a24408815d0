"""The port's clustering IID loss and K3's plain version against the JAX
package: ``IID_loss`` / ``compute_joint`` / ``iid_loss_multihead`` against
their JAX counterparts, and ``iid_loss_fused_plain`` with its analytic
backward against the JAX fused kernel run in interpret mode (as
``tests/test_pallas_kernels.py`` runs it on the CPU). Inputs are softmax
pairs made from numpy seeds. Tolerances are the JAX package's own kernel
contract (``tests/test_pallas_kernels.py:34-37, :54-55``): values rtol and
atol 1e-5, gradients rtol 1e-3 with atol 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from iic_tpu.ops import iid_loss as jl
from iic_tpu.ops.pallas import iid_loss_kernel as jk
from iic_tpu_torch.ops import iid_loss as tl
from iic_tpu_torch.ops.kernels import iid_loss as tk

SHAPES = [(64, 10, 1.0), (300, 10, 1.3), (128, 70, 1.0), (1000, 140, 1.0)]


def _softmax(rng, *shape):
    logits = rng.standard_normal(shape).astype(np.float32)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _pair(seed, *shape):
    rng = np.random.default_rng(seed)
    return _softmax(rng, *shape), _softmax(rng, *shape)


def _close(got, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("bn,k,lamb", SHAPES)
def test_iid_loss_and_joint_match_jax(bn, k, lamb):
    """``IID_loss`` (xla) and ``compute_joint``: loss within 1e-5, the joint
    within 1e-6 of its max."""
    z, zt = _pair(0, bn, k)
    ref = jl.IID_loss(jnp.asarray(z), jnp.asarray(zt), lamb=lamb)
    got = tl.IID_loss(torch.from_numpy(z), torch.from_numpy(zt), lamb=lamb)
    for g, r in zip(got, ref):
        _close(float(g), float(r))
    p_ref = np.asarray(jl.compute_joint(jnp.asarray(z), jnp.asarray(zt)))
    p = tl.compute_joint(torch.from_numpy(z), torch.from_numpy(zt)).numpy()
    _close(p, p_ref, rtol=0, atol=1e-6 * np.abs(p_ref).max())


@pytest.mark.parametrize("bn,k,lamb", SHAPES)
def test_fused_plain_matches_jax_kernel(bn, k, lamb):
    """K3's plain version against the JAX fused kernel (interpret mode):
    loss and loss_nl within 1e-5, P within 1e-6 of its max, total within
    rtol 1e-5."""
    z, zt = _pair(1, bn, k)
    with pltpu.force_tpu_interpret_mode():
        (loss, nl), (p, total) = jk._fwd(jnp.asarray(z), jnp.asarray(zt),
                                         lamb)
    got = tk.iid_loss_fused_plain(torch.from_numpy(z), torch.from_numpy(zt),
                                  lamb)
    _close(float(got[0]), float(loss))
    _close(float(got[1]), float(nl))
    p = np.asarray(p)
    _close(got[2].numpy(), p, rtol=0, atol=1e-6 * np.abs(p).max())
    _close(float(got[3]), float(total), rtol=1e-5, atol=0)


@pytest.mark.parametrize("bn,k,lamb", SHAPES)
def test_fused_backward_matches_jax_grad(bn, k, lamb):
    """The analytic backward (``IIDLossFused``) against ``jax.grad`` of the
    JAX fused kernel and against torch autograd of the plain loss, for a
    cotangent on both outputs (the loss_nl branch included): rtol 1e-3,
    atol 1e-6."""
    z, zt = _pair(2, bn, k)
    g_l, g_nl = 0.7, -0.3

    def jax_obj(a, b):
        loss, nl = jk.iid_loss_fused(a, b, lamb)
        return g_l * loss + g_nl * nl

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jax_obj, argnums=(0, 1))(jnp.asarray(z),
                                                jnp.asarray(zt))

    def torch_grads(fn):
        a = torch.from_numpy(z).requires_grad_()
        b = torch.from_numpy(zt).requires_grad_()
        loss, nl = fn(a, b)[:2]
        return torch.autograd.grad(g_l * loss + g_nl * nl, (a, b))

    analytic = torch_grads(lambda a, b: tk.iid_loss_fused(a, b, lamb))
    autodiff = torch_grads(lambda a, b: tk.iid_loss_fused_plain(a, b, lamb))
    for got, r, auto in zip(analytic, ref, autodiff):
        _close(got.numpy(), np.asarray(r), rtol=1e-3, atol=1e-6)
        _close(got.numpy(), auto.numpy(), rtol=1e-3, atol=1e-6)


def test_fused_backward_when_p_clamps():
    """A joint with zero cells (disjoint one-hot pairs): the clamp masks cut
    the gradient exactly as autograd of the plain loss does."""
    z = np.zeros((8, 4), np.float32)
    zt = np.zeros((8, 4), np.float32)
    z[np.arange(8), np.arange(8) % 2] = 1.0
    zt[np.arange(8), np.arange(8) % 2] = 1.0
    grads = []
    for fn in (tk.iid_loss_fused, tk.iid_loss_fused_plain):
        a = torch.from_numpy(z).requires_grad_()
        loss = fn(a, torch.from_numpy(zt), 1.0)[0]
        grads.append(torch.autograd.grad(loss, a)[0].numpy())
    assert np.isfinite(grads[0]).all()
    _close(grads[0], grads[1], rtol=1e-3, atol=1e-6)


def test_weighted_joint_matches_jax():
    """``compute_joint`` with per-sample weights (zeros included) against
    the JAX one, within 1e-6 of its max; all-ones weights change nothing."""
    z, zt = _pair(3, 40, 7)
    w = np.ones(40, np.float32)
    w[30:] = 0.0
    w[:5] = 0.5
    ref = np.asarray(jl.compute_joint(jnp.asarray(z), jnp.asarray(zt),
                                      weights=jnp.asarray(w)))
    got = tl.compute_joint(torch.from_numpy(z), torch.from_numpy(zt),
                           weights=torch.from_numpy(w)).numpy()
    _close(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    ones = tl.compute_joint(torch.from_numpy(z), torch.from_numpy(zt),
                            weights=torch.ones(40))
    assert torch.equal(ones, tl.compute_joint(torch.from_numpy(z),
                                              torch.from_numpy(zt)))


def test_multihead_matches_jax_and_per_head():
    """(S, bn, k) in one call: each sub-head's loss equals the single-head
    call's, and the means match JAX ``iid_loss_multihead`` within 1e-5;
    the fused path on (S, bn, k) agrees with the xla path."""
    z, zt = _pair(4, 3, 50, 12)
    tz, tzt = torch.from_numpy(z), torch.from_numpy(zt)
    mean, mean_nl, losses = tl.iid_loss_multihead(tz, tzt, lamb=1.2)
    ref = jl.iid_loss_multihead(jnp.asarray(z), jnp.asarray(zt), lamb=1.2)
    for g, r in zip((mean, mean_nl, losses), ref):
        _close(g.numpy(), np.asarray(r))
    for s in range(3):
        single = tl.IID_loss(tz[s], tzt[s], lamb=1.2)[0]
        _close(float(losses[s]), float(single), rtol=1e-6, atol=0)
    fused = tl.IID_loss(tz, tzt, lamb=1.2, impl="fused")
    _close(fused[0].numpy(), losses.numpy())


def test_fused_impl_refuses_what_the_kernel_lacks():
    z = torch.from_numpy(_pair(5, 6, 3)[0])
    with pytest.raises(ValueError, match="epsilon"):
        tl.IID_loss(z, z, EPS=1e-8, impl="fused")
    with pytest.raises(ValueError, match="weighted"):
        tl.IID_loss(z, z, impl="fused", weights=torch.ones(6))
    with pytest.raises(ValueError, match="impl"):
        tl.IID_loss(z, z, impl="pallas")


def test_fused_backward_passes_gradcheck():
    """``IIDLossFused`` in float64 on the CPU (the plain forward and the
    analytic backward) against finite differences of both outputs."""
    z, zt = _pair(6, 12, 4)
    a = torch.from_numpy(z).double().requires_grad_()
    b = torch.from_numpy(zt).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, y: tk.iid_loss_fused(x, y, 1.3), (a, b), eps=1e-6,
        atol=1e-6, rtol=1e-3)


def _cluster_rows(bn, cluster):
    """The row ranges [r0, r1) of a sub-head's bn rows that the cluster
    form's ranks 0 ... cluster-1 take (csrc/iid_loss.cu: ceil(bn /
    cluster) rows each, the last ones shorter or empty)."""
    per = -(-bn // cluster)
    return [(min(bn, r * per), min(bn, (r + 1) * per))
            for r in range(cluster)]


def _cluster_restated(z, zt, lamb, cluster):
    """K3's cluster form (csrc/iid_loss.cu iid_loss_cluster_kernel)
    restated on one sub-head in f32: rank r's partial joint over its rows
    (``_cluster_rows``; a rank with none adds zeros); the rows i = r + C m
    of the symmetrised joint, (a + b) / 2 with a and b the partials of (i,
    j) and of (j, i) added in rank order 0 ... C-1; T the ranks' sums of
    their rows added in rank order; P = J / T; the log marginals of the
    unclamped P (row sums: one array for p_i and p_j, P being symmetric);
    the clamped log terms of each rank's rows, the ranks' sums added in
    rank order."""
    bn, k = z.shape
    partials = [z[r0:r1].T @ zt[r0:r1]
                for r0, r1 in _cluster_rows(bn, cluster)]
    a = torch.zeros(k, k)
    b = torch.zeros(k, k)
    for part in partials:
        a = a + part
        b = b + part.T
    sym = (a + b) / 2.0
    owned = [torch.tensor(range(r, k, cluster), dtype=torch.long)
             for r in range(cluster)]
    total = torch.zeros(())
    for rows in owned:
        total = total + sym[rows].sum()
    p = sym / total
    log_m = torch.log(p.sum(dim=1).clamp_min(tk.EPS))
    p_c = p.clamp_min(tk.EPS)
    log_p = torch.log(p_c)
    loss = torch.zeros(())
    loss_nl = torch.zeros(())
    for rows in owned:
        li = log_m[rows][:, None]
        loss = loss - (p_c[rows] * (log_p[rows] - lamb * log_m[None, :]
                                    - lamb * li)).sum()
        loss_nl = loss_nl - (p_c[rows] * (log_p[rows] - log_m[None, :]
                                          - li)).sum()
    return loss, loss_nl, p, total


def test_cluster_rows_cover_the_rows_once():
    """The restatement's ranks take contiguous ranges that cover the bn
    rows once, in order; past the end a rank's range is empty."""
    for bn in (1, 5, 7, 8, 9, 660, 1000):
        for cluster in (1, 3, tk.CLUSTER):
            ranges = _cluster_rows(bn, cluster)
            assert len(ranges) == cluster
            assert ranges[0][0] == 0 and ranges[-1][1] == bn
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(r0 <= r1 for r0, r1 in ranges)


@pytest.mark.parametrize("bn,k,lamb", SHAPES + [(5, 10, 1.0), (1, 7, 1.0),
                                                (40, 1, 1.0)])
def test_cluster_restatement_matches_jax_kernel(bn, k, lamb):
    """K3's cluster split restated (``tk.CLUSTER`` ranks: bn under the
    cluster, bn = 1 and k = 1 included) against the JAX fused kernel (interpret
    mode): loss and loss_nl within 1e-5, P within 1e-6 of its max, total
    within rtol 1e-5."""
    z, zt = _pair(7, bn, k)
    with pltpu.force_tpu_interpret_mode():
        (loss, nl), (p, total) = jk._fwd(jnp.asarray(z), jnp.asarray(zt),
                                         lamb)
    p = np.asarray(p)
    got = _cluster_restated(torch.from_numpy(z), torch.from_numpy(zt),
                            lamb, tk.CLUSTER)
    _close(float(got[0]), float(loss))
    _close(float(got[1]), float(nl))
    _close(got[2].numpy(), p, rtol=0, atol=1e-6 * np.abs(p).max())
    _close(float(got[3]), float(total), rtol=1e-5, atol=0)


def test_fwd_forms_on_cpu_are_the_plain_version():
    """On CPU tensors both forms return the plain version and count no
    launch; an unknown form is refused on every device."""
    z, zt = (torch.from_numpy(a) for a in _pair(8, 3, 20, 6))
    tk.reset_launch_counts()
    ref = tk.iid_loss_fused_plain(z, zt, 1.2)
    for form in tk.FORMS:
        got = tk.iid_loss_fwd(z, zt, 1.2, form=form)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert tk.LAUNCHES == {"iid_loss_fwd": 0}
    with pytest.raises(ValueError, match="form"):
        tk.iid_loss_fwd(z, zt, form="warp")
