"""Data parallelism on ``torch.distributed`` (``iic_tpu/parallel/mesh.py``).

One process a device (a "rank"), PyTorch's own idiom: NCCL between cards,
gloo for CPU tensors (the tests). The JAX package shards the batch over a
1-D mesh and psums the k x k (clustering) or (k, k, T, T) (segmentation)
joint before the log terms, the exact global-batch MI estimator; here each
rank computes its shard's joint and ``all_reduce_joint`` sums it.

A port rank is always its own process, so the port follows the JAX
package's multi-host rules at every world size above 1: each rank's
pipeline yields its contiguous sub-block of the globally ordered batch
(``process_shard = (rank, world)``), with draws of its own. So
``make_global_batch`` and ``make_batch_globalizer`` have no counterpart: a
rank's batch is already its shard. At world size 1 (one card driven through
the process group) the pipelines are the single-process ones.

``initialize_distributed`` joins a process group (env:// under
``torchrun``, tcp:// from its arguments); ``make_mesh`` describes it;
``spawn`` runs a function in N local ranks (``--n_devices N``);
``reduce_gradients``, ``average_buffers`` and ``broadcast_state`` are the
JAX step's ``_reduce_grads``, ``_sync_batch_stats`` and
``make_replicator``. ``make_sharded_eval`` shards the eval forward: every
rank holds the whole eval batch (the mapping loaders load the whole set on
each rank, the JAX package's multi-host contract), forwards its contiguous
slice of it, and gets the whole output back by an all-gather, so the
host-side matching downstream is the same on every rank. Forwards whose
BatchNorm normalises by batch statistics take them over the ranks
(``global_batch_stats``), as the JAX package's plain jit over the mesh
does.
"""

import dataclasses
import functools
import os
import socket
import sys
import tempfile
import time
from contextlib import contextmanager

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """The ranks one run trains on: ``size`` processes, this one
    ``rank``, its ``device``, over the default process group."""
    size: int
    rank: int
    device: torch.device

    @property
    def is_main(self):
        """Rank 0, the one that writes the run's files."""
        return self.rank == 0


def backend_for(device):
    """NCCL for CUDA devices, gloo for the CPU: a CUDA tensor never takes
    gloo."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None):
    """Join the default process group: from ``torchrun``'s environment
    (env://) when ``coordinator_address`` is None, else at
    ``tcp://<coordinator_address>`` as rank ``process_id`` of
    ``num_processes``. ``backend`` defaults to NCCL; a failed NCCL init is
    an error, never a CPU run."""
    backend = backend or "nccl"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)


def under_torchrun():
    """True in a process ``torchrun`` started (its environment names the
    rank and world size)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def make_mesh(n_devices=None, device=None):
    """The mesh of the default process group, with this rank's
    ``device``. ``n_devices`` (None: the group's size) must be the group's
    size; more CUDA ranks than the host's visible cards raise, as the JAX
    function raises past ``jax.devices()``."""
    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group "
                         "(initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested n_devices={n_devices} in a process "
                         f"group of {world}")
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        check_visible(world)
        if dist.get_backend() != "nccl":
            raise ValueError("CUDA ranks need the NCCL backend")
    return Mesh(world, rank, device)


def check_visible(n_devices):
    """Raise when ``n_devices`` CUDA ranks exceed the visible cards."""
    visible = torch.cuda.device_count()
    if n_devices > visible:
        raise ValueError(f"requested n_devices={n_devices} but only "
                         f"{visible} CUDA devices are visible")


class _AllReduce(torch.autograd.Function):
    """Sum over ranks. Backward: the gradient unchanged (``sum_grad`` False)
    or summed over ranks too (True)."""

    @staticmethod
    def forward(ctx, x, sum_grad):
        ctx.sum_grad = sum_grad
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grad:
            grad = grad.clone()
            dist.all_reduce(grad)
        return grad, None


def all_reduce_joint(x, mesh):
    """The sum of ``x`` over ranks, differentiable; identity without a mesh.

    For a quantity whose downstream is computed alike on every rank (the
    joint, from which each rank computes the one global loss): each rank's
    upstream gradient is already the whole gradient, so the backward passes
    it through unchanged and each rank's gradient is its share of the one
    global loss's (so gradients are then summed, not averaged)."""
    if mesh is None:
        return x
    return _AllReduce.apply(x, False)


def all_reduce_stats(x, mesh):
    """The sum of ``x`` over ranks, differentiable; identity without a mesh.

    For a quantity each rank uses on its own rows (synced BatchNorm's
    moments): each rank's upstream gradient holds only its rows' share, so
    the backward sums it over ranks (the JAX package's psum transposes the
    same way)."""
    if mesh is None:
        return x
    return _AllReduce.apply(x, True)


def _flat_all_reduce(tensors, scale=None):
    """All-reduce (sum) ``tensors`` in place as one flat buffer, then
    multiply by ``scale``."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    if scale is not None:
        flat.mul_(scale)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


# The gradient reduction of each joint mode (the JAX step's
# ``_reduce_grads``): in global mode each rank's gradient is its share of
# the one global loss's, so they add; in parity mode the loss is the mean
# of the ranks' losses, and so is the gradient.
GRAD_REDUCTION = {"global": "sum", "parity": "mean"}


def reduce_gradients(params, mesh, joint_mode):
    """Reduce every parameter's gradient over ranks in one flattened
    all-reduce: summed in global mode, averaged in parity mode."""
    if mesh is None:
        return
    op = GRAD_REDUCTION[joint_mode]
    _flat_all_reduce([p.grad for p in params],
                     None if op == "sum" else 1.0 / mesh.size)


def average_buffers(module, mesh):
    """Average the floating-point buffers (BatchNorm's running statistics)
    over ranks after a step: each rank updated them from its own rows (the
    JAX step's ``_sync_batch_stats``). The batch counters are equal on
    every rank already."""
    if mesh is None:
        return
    _flat_all_reduce([b for b in module.buffers()
                      if b.is_floating_point()], 1.0 / mesh.size)


def broadcast_state(module, optimizer, mesh):
    """Make every rank's parameters, buffers and optimiser state rank 0's
    (the JAX package's ``make_replicator``): after the init, or a restart,
    every rank starts from the same state."""
    if mesh is None:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                tensors += [state[k] for k in sorted(state)
                            if torch.is_tensor(state[k])]
    with torch.no_grad():
        for t in tensors:
            if t.device == mesh.device:
                dist.broadcast(t, src=0)
            else:  # Adam's step count stays on the host under NCCL
                moved = t.to(mesh.device)
                dist.broadcast(moved, src=0)
                t.copy_(moved)


def global_mean(value, mesh):
    """The mean over ranks of a detached 0-d tensor (the parity mode's
    logged loss)."""
    if mesh is None:
        return value
    value = value.detach().clone()
    dist.all_reduce(value)
    return value / mesh.size


def _bn_forward_over(bn, mesh, x):
    """``bn``'s forward inside ``global_batch_stats``: by batch statistics
    over the ranks where the module normalises by batch statistics (train
    mode, or no running statistics), its own forward otherwise."""
    from iic_tpu_torch.models.layers import batch_norm_over

    if bn.training or not bn.track_running_stats:
        return batch_norm_over(bn, x, mesh)
    return type(bn).forward(bn, x)


@contextmanager
def global_batch_stats(net, mesh):
    """Inside the block, each BatchNorm of ``net`` that normalises by batch
    statistics takes them over the ranks of ``mesh`` (``batch_norm_over``:
    one all-reduce of the per-channel moments a layer, the formula of
    ``SyncBatchNorm2d``), whether or not ``--bn_sync`` is set, and leaves
    its running statistics alone; BatchNorm on running statistics runs as
    it is, with no collective. Every rank must run the same forwards on
    shards of one size. Identity without a mesh."""
    if mesh is None:
        yield
        return
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.forward = functools.partial(_bn_forward_over, m, mesh)
    try:
        yield
    finally:
        for m in bns:
            del m.forward


def make_sharded_eval(apply_fn, net, mesh):
    """The eval forward ``apply_fn(imgs) -> (H, b, k, ...)`` (a forward of
    ``net``) sharded over the ranks of ``mesh``
    (``iic_tpu/parallel/mesh.py``'s ``make_sharded_eval``). Every rank
    passes the same whole batch: it is padded to a multiple of the ranks
    with copies of its last image, as the JAX function pads, each rank
    forwards its contiguous slice under ``global_batch_stats`` (so a
    padded batch's BatchNorm statistics count the copies, as JAX's sharded
    forward does), the slices' outputs are all-gathered along the batch
    axis, and the padding is cut off: every rank returns the whole
    (H, b, k, ...) output."""
    def apply_sharded(imgs):
        b = imgs.shape[0]
        pad = (-b) % mesh.size
        if pad:
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
        rows = imgs.shape[0] // mesh.size
        with global_batch_stats(net, mesh):
            out = apply_fn(imgs[mesh.rank * rows:(mesh.rank + 1) * rows])
        parts = [torch.empty_like(out) for _ in range(mesh.size)]
        dist.all_gather(parts, out.contiguous())
        out = torch.cat(parts, dim=1)
        return out[:, :b] if pad else out

    return apply_sharded


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, world, port, device_type, out_dir, args):
    """One spawned rank: joins the group, runs ``fn(device, *args)`` and
    saves its result. Ranks above 0 print nothing to stdout."""
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if rank:
        sys.stdout = open(os.devnull, "w")
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           backend_for(device))
    try:
        result = fn(device, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks, args=(), device_type="cuda", timeout=None):
    """Run ``fn(device, *args)`` in ``n_ranks`` fresh local processes
    joined in one process group over ``127.0.0.1`` (NCCL, rank r on
    ``cuda:r``; gloo on the CPU for ``device_type="cpu"``). Returns the
    ranks' results in rank order. A rank that raises or dies fails the
    call (the others are stopped), and so do ranks still running after
    ``timeout`` seconds (None: no limit; a rank stuck in a collective
    would otherwise wait for ever)."""
    import torch.multiprocessing as mp

    if device_type == "cuda":
        check_visible(n_ranks)
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.spawn(_spawned, nprocs=n_ranks, join=False,
                       args=(fn, n_ranks, _free_port(), device_type, out_dir,
                             tuple(args)))
        while not ctx.join(timeout=None if deadline is None else 1.0):
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.terminate()
                for proc in ctx.processes:
                    proc.join(timeout=10)
                raise TimeoutError(f"{n_ranks} ranks still running after "
                                   f"{timeout} s")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n_ranks)]


def _rank_main(device, train_fn, config):
    """One spawned rank of ``run_data_parallel``: trains in the group the
    spawn made; rank 0 returns (its net, on the CPU, and the history)."""
    result = run_data_parallel(train_fn, config, device)
    if dist.get_rank():
        return None
    net, history = result
    return net.cpu(), history


def run_data_parallel(train_fn, config, device=None):
    """A trainer's entry: ``train_fn(config, device, mesh)`` on the mesh
    this process belongs to.

    - In a process group (a spawned rank, or a caller's): its mesh, which
      ``config.n_devices`` (when set) must match.
    - Under ``torchrun`` with no group yet: joins its group (env://) on
      ``device`` or ``cuda:<LOCAL_RANK>``.
    - ``--n_devices N > 1`` otherwise: spawns N local ranks (each on
      ``cuda:<rank>``, or on the CPU over gloo when ``device`` is the CPU)
      and returns rank 0's (net on the CPU, history).
    - Else one device and no mesh (``device`` defaults to cuda:0)."""
    from iic_tpu_torch.device import resolve_device

    n = config.n_devices
    if not dist.is_initialized() and under_torchrun():
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device(device if device is not None
                              else f"cuda:{local}")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        initialize_distributed(backend=backend_for(device))
    if dist.is_initialized():
        device = resolve_device(device)
        return train_fn(config, device, make_mesh(n, device))
    device = resolve_device(device)
    if n is not None and n > 1:
        return spawn(_rank_main, n, args=(train_fn, config),
                     device_type=device.type)[0]
    return train_fn(config, device, None)
