"""ClusterNet5g (ResNet-34, one- and two-head) forward parity between the
JAX package and the port, with the flax weights carried across by
iic_tpu_torch/compat/flax_bridge.py: both heads, train-mode and eval-mode
BatchNorm, the running statistics after one train-mode forward, and the
bridge's numeric path order. Weights and inputs are made from numpy seeds.

Tolerance: outputs are softmax probabilities after 36 f32 convolutions,
which XLA and PyTorch sum in different orders; they agree within atol 1e-5
plus rtol 1e-4 (observed ~1e-6). Running statistics within 1e-5 + 1e-4
relative."""

import copy
import math
from functools import partial
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import _numbered, load_cluster_net

SZ = 32
ATOL, RTOL = 1e-5, 1e-4


def cluster_cfg(track=True, arch="ClusterNet5gTwoHead", in_channels=2,
                num_sub_heads=2, output_k_A=7, output_k_B=3):
    return SimpleNamespace(arch=arch, in_channels=in_channels,
                           output_k=output_k_B, output_k_A=output_k_A,
                           output_k_B=output_k_B, num_sub_heads=num_sub_heads,
                           input_sz=SZ, batchnorm_track=track)


def random_flax_variables(jnet, in_channels, heads=("A", "B"), seed=0,
                          head_std=0.01, sz=16):
    """A full flax variable tree for ``jnet`` filled from a numpy seed: the
    tree's structure from ``jax.eval_shape`` of the JAX init at ``sz``^2
    (no init pass to pay for; net6c's head width depends on it), conv
    kernels Kaiming fan-out, dense kernels N(0, head_std), BN scale / bias
    and running statistics randomised."""
    shapes = jax.eval_shape(lambda: jmodels.init_variables(
        jnet, jax.random.PRNGKey(0),
        jnp.zeros((2, in_channels, sz, sz), jnp.float32), heads=heads))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        collection, name, shape = path[0].key, path[-1].key, leaf.shape
        if collection == "batch_stats":
            v = (0.1 * rng.standard_normal(shape) if name == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif name == "kernel" and len(shape) == 4:  # HWIO conv
            fan_out = shape[0] * shape[1] * shape[3]
            v = rng.standard_normal(shape) * math.sqrt(2.0 / fan_out)
        elif name == "kernel":  # (S, D, K) dense heads
            v = head_std * rng.standard_normal(shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:  # BN and dense biases
            v = 0.1 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def nets():
    """(cfg, jnet, variables, torch net) per batchnorm_track mode."""
    out = {}
    for track in (True, False):
        cfg = cluster_cfg(track)
        jnet = jmodels.build(cfg.arch, cfg)
        variables = random_flax_variables(jnet, cfg.in_channels, seed=1)
        tnet = load_cluster_net(variables, tmodels.build(cfg.arch, cfg))
        out[track] = (cfg, jnet, variables, tnet)
    return out


def _x(seed=0, b=4, c=2):
    return np.random.default_rng(seed).standard_normal(
        (b, c, SZ, SZ)).astype(np.float32)


@partial(jax.jit, static_argnums=(0, 3, 4))
def _jax_apply(jnet, variables, x, head, train):
    if train:
        return jnet.apply(variables, x, head=head, train=True,
                          mutable=["batch_stats"])
    return jnet.apply(variables, x, head=head, train=False), {}


def _torch_bn_stats(tnet):
    return [(m.running_mean.numpy(), m.running_var.numpy())
            for m in tnet.modules() if isinstance(m, torch.nn.BatchNorm2d)]


@pytest.mark.parametrize("track,train", [(True, True), (True, False),
                                         (False, True)])
@pytest.mark.parametrize("head", ["A", "B"])
def test_twohead_forward_matches_jax(nets, track, train, head):
    """Train-mode BN (batch statistics) and eval-mode BN (running
    statistics), both heads: (S, B, K) softmax outputs agree."""
    cfg, jnet, variables, tnet = nets[track]
    tnet = copy.deepcopy(tnet)  # a train-mode forward updates its stats
    x = _x()
    ref, _ = _jax_apply(jnet, variables, jnp.asarray(x), head, train)
    tnet.train(train)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), head=head).numpy()
    k = cfg.output_k_A if head == "A" else cfg.output_k_B
    assert got.shape == (cfg.num_sub_heads, 4, k)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_running_stats_after_one_train_forward_match_jax(nets):
    """One train-mode forward updates every BN's running mean and
    (unbiased) variance as the JAX BatchNorm does."""
    cfg, jnet, variables, _ = nets[True]
    tnet = load_cluster_net(variables, tmodels.build(cfg.arch, cfg))
    x = _x(seed=3)
    _, upd = _jax_apply(jnet, variables, jnp.asarray(x), "A", True)
    tnet.train()
    with torch.no_grad():
        tnet(torch.from_numpy(x), head="A")
    ref = _numbered(jax.device_get(upd["batch_stats"]), "BatchNorm")
    got = _torch_bn_stats(tnet)
    assert len(got) == len(ref) == 36
    for (mean, var), (path, node) in zip(got, ref):
        np.testing.assert_allclose(mean, node["mean"], rtol=RTOL, atol=ATOL,
                                   err_msg="/".join(path))
        np.testing.assert_allclose(var, node["var"], rtol=RTOL, atol=ATOL,
                                   err_msg="/".join(path))


def test_single_head_forward_matches_jax():
    """``ClusterNet5g``: eval-mode forward through the bridge."""
    cfg = cluster_cfg(True, arch="ClusterNet5g", num_sub_heads=3)
    jnet = jmodels.build(cfg.arch, cfg)
    variables = random_flax_variables(jnet, 2, heads=None, seed=2)
    tnet = load_cluster_net(variables, tmodels.build(cfg.arch, cfg)).eval()
    x = _x(seed=4, b=3)
    ref = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 3, cfg.output_k)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_bridge_orders_paths_numerically():
    """``BasicBlock_10`` sorts after ``BasicBlock_2`` (a string sort would
    put it first), per layer, and a module's own convs come before its
    sub-modules'."""
    leaf = {"kernel": np.zeros(1)}
    blocks = {f"BasicBlock_{i}": {"Conv_1": leaf, "Conv_0": leaf}
              for i in (10, 2, 0, 1)}
    tree = {"ResNetLayer_1": {"BasicBlock_0": {"Conv_0": leaf}},
            "ResNetLayer_0": blocks, "Conv_0": leaf}
    paths = ["/".join(p) for p, _ in _numbered(tree, "Conv")]
    assert paths == ["Conv_0"] + [
        f"ResNetLayer_0/BasicBlock_{b}/Conv_{c}"
        for b in (0, 1, 2, 10) for c in (0, 1)] + [
        "ResNetLayer_1/BasicBlock_0/Conv_0"]


def test_state_dict_uses_reference_names():
    """The reference's module names, so its saves load directly; the 1x1
    downsample exists where the stride or the width changes."""
    net = tmodels.build("ClusterNet5gTwoHead", cluster_cfg(True))
    keys = set(net.state_dict())
    for key in ("trunk.conv1.weight", "trunk.bn1.running_mean",
                "trunk.layer1.2.conv2.weight", "trunk.layer2.0.downsample.0."
                "weight", "trunk.layer4.2.bn2.bias", "head_A.heads.1.0.weight",
                "head_B.heads.0.0.bias"):
        assert key in keys, key
    assert not any(k.startswith("trunk.layer1.0.downsample") for k in keys)
    assert sum(isinstance(m, torch.nn.Conv2d) for m in net.modules()) == 36


def test_init_follows_the_reference():
    """Convs Kaiming fan-out (std sqrt(2 / (k*k*out))), heads N(0, 0.01)
    with zero bias, BN scale 1 and bias 0."""
    torch.manual_seed(0)
    net = tmodels.build("ClusterNet5gTwoHead", cluster_cfg(True))
    w = net.trunk.layer3[1].conv1.weight.detach()
    assert float(w.std()) == pytest.approx(math.sqrt(2 / (9 * 256)), rel=0.02)
    lin = net.head_A.heads[0][0]
    assert float(lin.weight.detach().std()) == pytest.approx(0.01, rel=0.05)
    assert float(lin.bias.detach().abs().max()) == 0.0
    bn = net.trunk.layer2[0].bn1
    assert torch.all(bn.weight == 1) and torch.all(bn.bias == 0)
