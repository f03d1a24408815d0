"""Carries the JAX package's flax ``variables`` into the port's modules.

Takes the variables as nested dicts of numpy arrays (``jax.device_get`` of
the JAX tree), so this module needs no JAX. Mapping:

  - flax ``Conv`` kernel HWIO -> torch weight OIHW;
  - flax ``BatchNorm`` scale / bias / mean / var -> weight / bias /
    running_mean / running_var;
  - ``MultiConvSoftmaxHead`` kernel (1, 1, C, S*K) -> S 1x1 convs (K, C, 1, 1)
    (the flax head reshapes its kernel to (C, S, K)).

Convs and BatchNorms are matched by their flax index (``Conv_<i>``,
``BatchNorm_<i>``), which counts them in execution order, against the order
of the torch modules. Every copy is shape-checked.
"""

import re

import numpy as np
import torch
import torch.nn as nn

_TRUNK_KEY = "SegmentationNet10aTrunk_0"


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
    found.sort(key=lambda f: (f[0], f[1]))
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
    """Copy a flax VGG trunk's params (and batch stats) into ``trunk``."""
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
