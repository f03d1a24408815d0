"""The ranks of tests/test_torch_parallel.py: steps of the port's trainers
on each rank's shard of a fixed global batch, run in gloo processes
(``iic_tpu_torch.parallel.mesh.spawn``) that import torch and the port
only, and the same steps on the whole batch in one process (``mesh=None``).

A case is a dict: ``kind`` ("cluster", "seg" or "semisup"), the net's
``arch`` and config fields ``cfg``, its ``state`` (a state_dict), the
global batch as numpy arrays, and the step's options. ``run_case`` returns
the logged losses, the state_dict after the step and each parameter's
reduced gradient. This file holds no test."""

import time
from types import SimpleNamespace

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.models.layers import sync_batch_norm
from iic_tpu_torch.models.semisup import SemisupNet, SupHead5Head
from iic_tpu_torch.parallel import mesh as mesh_lib
from iic_tpu_torch.parallel.train_step import (
    make_cluster_train_step, make_seg_train_step, make_semisup_train_step)


def _shard(x, mesh):
    """Rank ``mesh.rank``'s contiguous rows of ``x`` (all without a
    mesh), as a tensor."""
    if mesh is not None:
        n = len(x) // mesh.size
        x = x[mesh.rank * n:(mesh.rank + 1) * n]
    return torch.from_numpy(np.ascontiguousarray(x))


def _optimizer(case, groups):
    if case["opt"] == "sgd":
        return torch.optim.SGD(groups, lr=case["lr"])
    return torch.optim.Adam(groups, lr=case["lr"])


def _net(case, mesh):
    net = models.build(case["arch"], SimpleNamespace(**case["cfg"]))
    if case["kind"] == "semisup":
        sz = case["cfg"]["input_sz"]
        dlen = 512 * (sz // 8) ** 2
        net = SemisupNet(net, SupHead5Head(dlen, case["gt_k"]))
    net.load_state_dict(case["state"])
    if case.get("bn_sync"):
        sync_batch_norm(net, mesh)
    return net


def run_case(case, mesh):
    """One step of ``case`` on ``mesh`` (None: one process, whole batch).
    Returns {"loss", "loss_nl", "state", "grads"}."""
    net = _net(case, mesh)
    batch = case["batch"]
    loss_nl = None
    saved = dict(mesh_lib.GRAD_REDUCTION)
    mesh_lib.GRAD_REDUCTION.update(case.get("grad_reduction", {}))
    try:
        if case["kind"] == "cluster":
            opt = _optimizer(case, net.parameters())
            weighted = "weights" in batch
            step = make_cluster_train_step(
                net, opt, None, lamb=case["lamb"], head=case["head"],
                mesh=mesh, joint_mode=case["joint_mode"], weighted=weighted)
            pair = (_shard(batch["imgs"], mesh),
                    _shard(batch["imgs_tf"], mesh))
            loss, loss_nl = step((pair, _shard(batch["weights"], mesh))
                                 if weighted else pair)
        elif case["kind"] == "seg":
            opt = _optimizer(case, net.parameters())
            step = make_seg_train_step(
                net, opt, lamb=case["lamb"], head=case["head"],
                half_T_side_dense=case["half_t"], half_T_side_sparse_min=0,
                half_T_side_sparse_max=0, sobel=True, include_rgb=True,
                use_uncollapsed_loss=case["uncollapsed"], mesh=mesh,
                joint_mode=case["joint_mode"])
            loss, loss_nl = step(tuple(
                _shard(batch[k], mesh)
                for k in ("img1", "img2", "affine", "mask")))
        else:
            opt = _optimizer(case, [
                {"params": list(net.net.trunk.parameters())},
                {"params": list(net.head.parameters())}])
            step = make_semisup_train_step(net, opt, mesh=mesh)
            loss = step((_shard(batch["imgs"], mesh),
                         _shard(batch["labels"], mesh)))
    finally:
        mesh_lib.GRAD_REDUCTION.clear()
        mesh_lib.GRAD_REDUCTION.update(saved)
    return {"loss": float(loss),
            "loss_nl": None if loss_nl is None else float(loss_nl),
            "state": {k: v.detach().clone()
                      for k, v in net.state_dict().items()},
            "grads": {k: p.grad.detach().clone()
                      for k, p in net.named_parameters()
                      if p.grad is not None}}


def run_cases(device, cases):
    """A spawned rank: every case in turn on the group's mesh."""
    mesh = mesh_lib.make_mesh(None, device)
    return [run_case(case, mesh) for case in cases]


def count_writes(device, main, argv):
    """A spawned rank running a CLI's ``main(argv, device)`` in the group:
    returns (the rank, how many times it wrote a checkpoint, plots.png or
    config.pickle, the history)."""
    from iic_tpu_torch.train import checkpoint as ckpt

    writes = []
    for name in ("save_checkpoint", "save_meta", "save_plots"):
        real = getattr(ckpt, name)

        def counted(*a, _real=real, _name=name, **kw):
            writes.append(_name)
            return _real(*a, **kw)

        setattr(ckpt, name, counted)
    _, history = main(argv, device=device)
    return mesh_lib.make_mesh(None, device).rank, len(writes), history


def fail(device):
    """A rank that raises."""
    raise RuntimeError("rank 0 fails")


def hang(device):
    """A rank that never returns (within a test's patience)."""
    time.sleep(600)
