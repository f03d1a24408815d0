"""The ranks of tests/test_torch_sharded_eval.py, run in gloo processes
(``iic_tpu_torch.parallel.mesh.spawn``) that import torch and the port
only: the sharded eval forward (``make_sharded_eval``) of a net on a fixed
whole batch, and the clustering trainer's sub-head pick by loss on fixed
image pairs, with its BatchNorm statistics over the ranks or, for the
check that must fail, over each rank's shard.

An eval case is a dict: the net's ``arch`` and config fields ``cfg``, its
``state`` (a state_dict), the whole batch ``imgs`` (numpy) and
``train_mode`` (the double eval's forward). A pick case: ``cfg``, ``state``,
``pairs`` (a list of (imgs, imgs_tf) numpy batches) and ``per_shard``.
This file holds no test."""

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.parallel import mesh as mesh_lib
from iic_tpu_torch.parallel.train_step import make_apply_fn
from iic_tpu_torch.train import cluster_trainer


def build_net(case):
    net = models.build(case["arch"], SimpleNamespace(**case["cfg"]))
    net.load_state_dict(case["state"])
    return net


def eval_apply(case, net):
    """The trainers' eval forward of head B for ``case``."""
    return make_apply_fn(net, head="B", sobel=False,
                         include_rgb=case["cfg"]["include_rgb"],
                         train_mode=case["train_mode"])


@contextlib.contextmanager
def _per_shard(module, on):
    """With ``on``, ``module.global_batch_stats`` does nothing inside the
    block: BatchNorm then takes its batch statistics over each rank's shard
    (the check that must fail)."""
    real = module.global_batch_stats
    if on:
        module.global_batch_stats = lambda net, mesh: contextlib.nullcontext()
    try:
        yield
    finally:
        module.global_batch_stats = real


def run_eval(case, mesh):
    """The sharded eval of the whole batch on this rank: {"out": the
    gathered output, "rows": the rows of each forward this rank ran,
    "buffers_kept": whether every buffer is as it was}. ``per_shard``
    (optional) runs it with each rank's batch statistics its shard's."""
    net = build_net(case)
    rows = []
    hook = net.register_forward_pre_hook(
        lambda module, args: rows.append(int(args[0].shape[0])))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with _per_shard(mesh_lib, case.get("per_shard", False)):
        out = mesh_lib.make_sharded_eval(eval_apply(case, net), net, mesh)(
            torch.from_numpy(case["imgs"]))
    hook.remove()
    kept = all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    return {"out": out, "rows": rows, "buffers_kept": kept}


class FixedPairs:
    """A head-B pipeline stand-in for the sharded pick: each batch of
    ``pairs`` is a base (its index) with all-ones weights for this rank's
    rows, and ``augment_pair`` gives the rank's rows of the fixed pair."""

    def __init__(self, pairs, mesh):
        self.pairs = pairs
        self.mesh = mesh

    def _rows(self, n):
        shard = n // self.mesh.size
        return slice(self.mesh.rank * shard, (self.mesh.rank + 1) * shard)

    def epoch(self, epoch_idx):
        for i, (imgs, _) in enumerate(self.pairs):
            rows = self._rows(len(imgs))
            yield (torch.tensor([i]),
                   torch.ones(rows.stop - rows.start)), None

    def augment_pair(self, base, generator):
        imgs, imgs_tf = self.pairs[int(base[0])]
        rows = self._rows(len(imgs))
        return (torch.from_numpy(imgs[rows]), torch.from_numpy(imgs_tf[rows]))


def run_pick(case, mesh):
    """``_select_sub_head_on_loss`` on this rank: {"pick", "losses": each
    sub-head's loss summed over the batches, as the pick sums them}.
    ``per_shard`` runs it with its BatchNorm statistics over each rank's
    shard (the pick before the fix)."""
    net = build_net(case)
    config = SimpleNamespace(**case["cfg"], sobel=False, lamb_B=1.3)
    losses = []
    real = cluster_trainer.IID_loss

    def recorded(*a, **kw):
        out = real(*a, **kw)
        losses.append(out[0].detach().cpu().numpy().astype(np.float64))
        return out

    cluster_trainer.IID_loss = recorded
    try:
        with _per_shard(cluster_trainer, case["per_shard"]):
            pick = cluster_trainer._select_sub_head_on_loss(
                config, net, FixedPairs(case["pairs"], mesh), mesh)
    finally:
        cluster_trainer.IID_loss = real
    return {"pick": pick, "losses": np.sum(losses, axis=0)}


def run_cases(device, cases):
    """A spawned rank: every case in turn on the group's mesh."""
    mesh = mesh_lib.make_mesh(None, device)
    return [run_pick(c, mesh) if "pairs" in c else run_eval(c, mesh)
            for c in cases]
