"""Carries the JAX package's flax ``variables`` into the port's modules.

Takes the variables as nested dicts of numpy arrays (``jax.device_get`` of
the JAX tree), so this module needs no JAX. Mapping:

  - flax ``Conv`` kernel HWIO -> torch weight OIHW;
  - flax ``BatchNorm`` scale / bias / mean / var -> weight / bias /
    running_mean / running_var;
  - ``MultiConvSoftmaxHead`` kernel (1, 1, C, S*K) -> S 1x1 convs (K, C, 1, 1)
    (the flax head reshapes its kernel to (C, S, K));
  - ``MultiDenseHead`` kernel (S, D, K) and bias (S, K) -> S Linear layers,
    weight (K, D) and bias (K,);
  - the semisup head B's ``head_B_kernel`` (D, K) / ``head_B_bias`` and
    ``SupHead5Head``'s ``kernel1`` / ``bias1`` / ``BatchNorm_0`` /
    ``kernel2`` / ``bias2`` -> Linear and BatchNorm1d modules;
  - ``TripletsNet``'s ``kernel`` (D, K) / ``bias`` -> its Linear ``head``;
  - the segmentation baselines' ``_SiameseJointHead_0``: ``siamese_conv``
    and ``siamese_bn`` as above, ``joint_kernel<i>`` (D, K) /
    ``joint_bias<i>`` -> ``joint<i>``, weight (K, D).

Convs and BatchNorms are matched by their flax path and index (``Conv_<i>``,
``BatchNorm_<i>`` inside ``ResNetLayer_<l>/BasicBlock_<b>``), which count
them in creation order, against the order of the torch modules. Paths sort
by their numbers, so ``BasicBlock_10`` comes after ``BasicBlock_2``. Every
copy is shape-checked.
"""

import re

import numpy as np
import torch
import torch.nn as nn

_TRUNK_KEY = "SegmentationNet10aTrunk_0"
_CLUSTER_TRUNK_KEYS = ("ClusterNet5gTrunk_0", "ClusterNet6cTrunk_0")


def _path_key(path):
    """Sort key of a flax path: each ``<name>_<i>`` by name, then number."""
    key = []
    for part in path:
        m = re.fullmatch(r"(.*)_(\d+)", part)
        key.append((m.group(1), int(m.group(2))) if m else (part, -1))
    return tuple(key)


def _numbered(tree, prefix):
    """Sub-dicts named ``<prefix>_<i>`` anywhere below ``tree``, as a list
    ordered by i (the flax creation order within one module scope)."""
    found = []

    def walk(node, path):
        for key, val in node.items():
            if not isinstance(val, dict):
                continue
            m = re.fullmatch(rf"{prefix}_(\d+)", key)
            if m:
                found.append((path, int(m.group(1)), val, path + (key,)))
            else:
                walk(val, path + (key,))

    walk(tree, ())
    found.sort(key=lambda f: (_path_key(f[0]), f[1]))
    return [(full, val) for _, _, val, full in found]


def _lookup(tree, path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _copy(dst, src, what):
    src = torch.tensor(np.asarray(src, dtype=np.float32))
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"{what}: shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.device))


def load_trunk(params, stats, trunk):
    """Copy a flax VGG or ResNet trunk's params (and batch stats) into
    ``trunk``."""
    t_convs = [m for m in trunk.modules() if isinstance(m, nn.Conv2d)]
    t_bns = [m for m in trunk.modules() if isinstance(m, nn.BatchNorm2d)]
    f_convs = _numbered(params, "Conv")
    f_bns = _numbered(params, "BatchNorm")
    if len(t_convs) != len(f_convs) or len(t_bns) != len(f_bns):
        raise ValueError(f"trunk mismatch: torch {len(t_convs)} convs / "
                         f"{len(t_bns)} BNs, flax {len(f_convs)} / "
                         f"{len(f_bns)}")
    for conv, (path, node) in zip(t_convs, f_convs):
        _copy(conv.weight, np.transpose(node["kernel"], (3, 2, 0, 1)),
              "/".join(path))
    for bn, (path, node) in zip(t_bns, f_bns):
        _copy(bn.weight, node["scale"], "/".join(path) + "/scale")
        _copy(bn.bias, node["bias"], "/".join(path) + "/bias")
        st = _lookup(stats, path) if stats else None
        if bn.track_running_stats:
            if st is None:
                raise ValueError(f"{'/'.join(path)}: no batch stats for a "
                                 "BN that tracks running stats")
            _copy(bn.running_mean, st["mean"], "/".join(path) + "/mean")
            _copy(bn.running_var, st["var"], "/".join(path) + "/var")


def load_conv_heads(flax_head, head):
    """``MultiConvSoftmaxHead`` kernel (1, 1, C, S*K) -> the S 1x1 convs of
    ``head.heads``."""
    kernel = np.asarray(flax_head["kernel"])
    _, _, c, sk = kernel.shape
    s = len(head.heads)
    per_head = kernel.reshape(c, s, sk // s)
    for i, sub in enumerate(head.heads):
        w = per_head[:, i, :].T.reshape(sk // s, c, 1, 1)
        _copy(sub[0].weight, w, f"head sub-head {i}")


def load_dense_heads(flax_head, head):
    """``MultiDenseHead`` kernel (S, D, K) and bias (S, K) -> the S Linear
    layers of ``head.heads``."""
    kernel = np.asarray(flax_head["kernel"])
    bias = np.asarray(flax_head["bias"])
    if kernel.shape[0] != len(head.heads):
        raise ValueError(f"head has {len(head.heads)} sub-heads, flax "
                         f"kernel {kernel.shape}")
    for i, sub in enumerate(head.heads):
        _copy(sub[0].weight, kernel[i].T, f"head sub-head {i} kernel")
        _copy(sub[0].bias, bias[i], f"head sub-head {i} bias")


def load_cluster_net(variables, net):
    """Fill a ``ClusterNet5g[TwoHead]`` or ``ClusterNet6c[TwoHead]`` from
    flax ``variables``: the trunk's convs and BNs (the ResNet's stem first,
    then ``ResNetLayer_<l>/BasicBlock_<b>`` in order; net6c's
    ``VGGTrunk_0``), then the dense heads."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    key = next((k for k in _CLUSTER_TRUNK_KEYS if k in params), None)
    if key is None:
        raise ValueError(f"no cluster trunk among {sorted(params)}")
    load_trunk(params[key], stats.get(key), net.trunk)
    if hasattr(net, "head_A"):
        load_dense_heads(params["head_A"], net.head_A)
        if getattr(net, "semisup", False):
            _load_linear(net.head_B, params["head_B_kernel"],
                         params["head_B_bias"], "semisup head B")
        else:
            load_dense_heads(params["head_B"], net.head_B)
    else:
        load_dense_heads(params["MultiDenseHead_0"], net.head)
    return net


def _load_linear(linear, kernel, bias, what):
    """A flax (D, K) kernel and (K,) bias -> ``nn.Linear(D, K)``."""
    _copy(linear.weight, np.asarray(kernel).T, what + " kernel")
    _copy(linear.bias, bias, what + " bias")


def load_sup_head(variables, head):
    """Fill a ``models.semisup.SupHead5Head`` from the JAX
    ``SupHead5Head``'s flax ``variables``: ``kernel1`` / ``bias1``, the
    ``BatchNorm_0`` scale, bias (and running statistics when the head
    tracks them), ``kernel2`` / ``bias2``."""
    params = variables["params"]
    _load_linear(head.linear1, params["kernel1"], params["bias1"], "linear1")
    _load_linear(head.linear2, params["kernel2"], params["bias2"], "linear2")
    _load_bn(head.bn, params["BatchNorm_0"],
             (variables.get("batch_stats") or {}).get("BatchNorm_0"),
             "BatchNorm_0")
    return head


def load_seg_net(variables, net):
    """Fill a ``SegmentationNet10a[TwoHead]`` from flax ``variables``."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    load_trunk(params[_TRUNK_KEY], stats.get(_TRUNK_KEY), net.trunk)
    if hasattr(net, "head_A"):
        load_conv_heads(params["head_A"], net.head_A)
        load_conv_heads(params["head_B"], net.head_B)
    else:
        load_conv_heads(params["MultiConvSoftmaxHead_0"], net.head)
    return net


def _load_bn(bn, params, stats, what):
    """A flax ``BatchNorm``'s scale / bias (and its running statistics when
    ``bn`` tracks them) -> ``bn``."""
    _copy(bn.weight, params["scale"], what + "/scale")
    _copy(bn.bias, params["bias"], what + "/bias")
    if bn.track_running_stats:
        if stats is None:
            raise ValueError(f"{what}: no batch stats for a BN that tracks "
                             "running stats")
        _copy(bn.running_mean, stats["mean"], what + "/mean")
        _copy(bn.running_var, stats["var"], what + "/var")


def load_triplets_net(variables, net):
    """Fill a ``TripletsNet`` (either trunk) from the JAX ``TripletsNet``'s
    flax ``variables``: the trunk as ``load_cluster_net`` fills it, then
    the Linear head from ``kernel`` / ``bias``."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    key = next((k for k in _CLUSTER_TRUNK_KEYS if k in params), None)
    if key is None:
        raise ValueError(f"no cluster trunk among {sorted(params)}")
    load_trunk(params[key], stats.get(key), net.trunk)
    _load_linear(net.head, params["kernel"], params["bias"], "triplets head")
    return net


def load_seg_baseline_net(variables, net):
    """Fill a ``models.seg_baselines.SegBaselineNet`` (Doersch or Isola)
    from the JAX ``_SegBaselineNet``'s flax ``variables``: the net10a
    trunk, the siamese conv (HWIO -> OIHW) and BN, and the two joint
    Linears."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    load_trunk(params[_TRUNK_KEY], stats.get(_TRUNK_KEY), net.trunk)
    fhead = params["_SiameseJointHead_0"]
    hstats = stats.get("_SiameseJointHead_0") or {}
    head = net.head
    _copy(head.siamese_conv.weight,
          np.transpose(fhead["siamese_conv"]["kernel"], (3, 2, 0, 1)),
          "siamese_conv")
    _load_bn(head.siamese_bn, fhead["siamese_bn"], hstats.get("siamese_bn"),
             "siamese_bn")
    for i in (1, 2):
        _load_linear(getattr(head, f"joint{i}"), fhead[f"joint_kernel{i}"],
                     fhead[f"joint_bias{i}"], f"joint{i}")
    return net
