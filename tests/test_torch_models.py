"""net10a (one- and two-head) forward parity between the JAX package and
the port, with the flax weights carried across by iic_tpu_torch/compat/
flax_bridge.py, in both batchnorm_track modes, running statistics included.
Inputs are made from a numpy seed."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import load_seg_net


def _cfg(track, arch="SegmentationNet10aTwoHead"):
    return SimpleNamespace(arch=arch, in_channels=5, output_k=4,
                           output_k_A=6, output_k_B=3, num_sub_heads=2,
                           input_sz=24, batchnorm_track=track)


def _pair(track, arch="SegmentationNet10aTwoHead", seed=0):
    cfg = _cfg(track, arch)
    jnet = jmodels.build(arch, cfg)
    dummy = jnp.zeros((2, 5, 24, 24), jnp.float32)
    heads = ("A", "B") if arch.endswith("TwoHead") else None
    variables = jax.device_get(jmodels.init_variables(
        jnet, jax.random.PRNGKey(seed), dummy, heads=heads))
    tnet = load_seg_net(variables, tmodels.build(arch, cfg))
    return jnet, variables, tnet


def _x(seed=0, b=3):
    return np.random.default_rng(seed).standard_normal(
        (b, 5, 24, 24)).astype(np.float32)


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("head", ["A", "B"])
def test_twohead_train_forward_matches_jax(track, head):
    """Train-mode forward (batch statistics): softmax maps within 1e-5."""
    jnet, variables, tnet = _pair(track)
    x = _x(1)
    kw = {"mutable": ["batch_stats"]} if track else {}
    ref = jnet.apply(variables, jnp.asarray(x), head=head, train=True, **kw)
    ref = np.asarray(ref[0] if track else ref)
    tnet.train()
    got = tnet(torch.from_numpy(x), head=head).detach().numpy()
    assert got.shape == ref.shape == (2, 3, 6 if head == "A" else 3, 24, 24)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("track", [True, False])
def test_eval_forward_and_running_stats_match_jax(track):
    """One train-mode forward updates the running stats like flax's (the
    unbiased variance, momentum 0.1); the eval forward then matches: atol
    1e-5 on maps, rtol 1e-4 on statistics."""
    jnet, variables, tnet = _pair(track, seed=2)
    x, x_eval = _x(3), _x(4, b=2)
    tnet.train()
    tnet(torch.from_numpy(x), head="B")
    if track:
        _, upd = jnet.apply(variables, jnp.asarray(x), head="B", train=True,
                            mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": upd["batch_stats"]}
        bns = [m for m in tnet.trunk.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
        stats = upd["batch_stats"]["SegmentationNet10aTrunk_0"]["VGGTrunk_0"]
        for i, bn in enumerate(bns):
            s = stats[f"BatchNorm_{i}"]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(s["mean"]), rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(s["var"]), rtol=1e-4,
                                       atol=1e-6)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x_eval), head="B",
                                train=False))
    tnet.eval()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x_eval), head="B").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_single_head_forward_matches_jax():
    jnet, variables, tnet = _pair(True, arch="SegmentationNet10a", seed=5)
    x = _x(6)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])[0])
    tnet.train()
    got = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_state_dict_uses_reference_names():
    """Reference state_dict keys: trunk.features.<i>.*, head_A.heads.<s>.0."""
    tnet = tmodels.build("SegmentationNet10aTwoHead", _cfg(True))
    keys = set(tnet.state_dict())
    assert "trunk.features.0.weight" in keys
    assert "trunk.features.1.running_var" in keys
    assert "head_A.heads.1.0.weight" in keys
    assert "head_B.heads.0.0.weight" in keys


def test_bridge_refuses_a_mismatched_tree():
    _, variables, _ = _pair(True)
    wrong = tmodels.build("SegmentationNet10aTwoHead",
                          SimpleNamespace(**{**vars(_cfg(True)),
                                             "output_k_A": 7}))
    with pytest.raises(ValueError):
        load_seg_net(variables, wrong)


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError):
        tmodels.build("ClusterNet5gTwoHead", _cfg(True))
