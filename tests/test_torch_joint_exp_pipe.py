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
from iic_tpu_torch.tools import joint_kernel_exp as tool
from test_torch_joint_exp import _softmax_maps, jax_tool

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
