"""Clustering trainers (``iic_tpu/train/cluster_trainer.py``:
``train_cluster_twohead``, ``train_cluster_single``).

The epoch / head / batch loops of the reference's clustering scripts, on
one GPU or on several ranks (``--n_devices``, see ``train_cluster_twohead``).
Two-head (cluster_sobel_twohead, cluster_greyscale_twohead): head
B first unless ``--head_A_first`` (the opposite of the segmentation
scripts), ``head_X_epochs`` passes per head, a Hungarian eval (with double
eval) before training and after every epoch, optional sub-head selection by
loss. Single-head IID+ (cluster_sobel, cluster_greyscale): one pass an
epoch, the many-to-one ("orig") eval mapped on the assignment split and
scored on the held-out one, the losses logged in the head-B slots. Both:
the multiplicative lr schedule with Adam's moments kept, the NaN exit,
latest / best checkpoints, plots.png, ``--restart`` /
``--restart_from_best``, and the ``--test_code`` mode of two batches per
head pass and one epoch. The two-head scripts also draw the
``--save_progression`` point clouds (``utils/render.py``, with PIL).

Precision: the trunk runs in ``--model_dtype`` (float32 or bfloat16;
parameters, BN statistics, the heads, the loss and Adam stay f32). f32
cuDNN convolutions run in TF32 and matmuls (the heads, the plain loss) in
full f32; both flags are set here.

Input: each head pass's epoch runs behind the host prefetch thread
(``--prefetch_depth``, 8) unless ``--no_host_prefetch``; under
``--lazy_images`` that thread also reads the next batches' rows from disk.

``--profile_dir``: a ``torch.profiler`` chrome trace of the first epoch the
run trains, its eval included (``<profile_dir>/trace_epoch_<e>.json``,
written by rank 0 alone), each step a ``step_head_<A|B>`` span (the
single-head scripts' steps are ``step_head_B``).

Several ranks (the JAX package's multi-host rules, ``parallel/mesh.py``):
the batch is rounded down to a multiple of the ranks
(``adjust_batch_for_mesh``), each rank steps on its shard, ``--joint_mode
global`` (the global joint; a ragged final batch padded and weighted 0) or
``parity`` (each rank's joint, the losses averaged; a ragged final batch
dropped), ``--bn_sync`` syncs BatchNorm's batch statistics; ``--fused_loss``
falls back to the plain loss (K3 computes one rank's joint). The eval
forwards (the double eval's too) and the sub-head pick's run sharded with
BatchNorm's batch statistics taken over the ranks
(``parallel.mesh.make_sharded_eval``, ``global_batch_stats``); every rank
gets the whole eval output and matches it; rank 0 alone writes the run's
files.
"""

import sys
import time
from datetime import datetime

import numpy as np
import torch
from torch.profiler import record_function

from iic_tpu_torch import models
from iic_tpu_torch.data.pipeline import (
    cluster_create_dataloaders, cluster_twohead_create_dataloaders)
from iic_tpu_torch.data.prefetch import host_prefetch_iter
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.evals.cluster_eval import (
    cluster_eval, get_subhead_using_loss)
from iic_tpu_torch.models.layers import compute_dtype, sync_batch_norm
from iic_tpu_torch.ops.iid_loss import IID_loss
from iic_tpu_torch.parallel.mesh import (
    broadcast_state, global_batch_stats, make_sharded_eval, run_data_parallel)
from iic_tpu_torch.parallel.train_step import (
    make_apply_fn, make_cluster_train_step, make_optimizer, set_lr_mult)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import ClusterConfig, config_to_str
from iic_tpu_torch.train.seg_trainer import (
    adjust_batch_for_mesh, make_history, mesh_drop_last, resume, shard_of,
    start_epoch_trace, stop_epoch_trace)
from iic_tpu_torch.utils.render import save_progress

# Flags outside the ported slice: each is refused when it differs from its
# default, never ignored.
_REFUSED = ("epoch_scan", "resident_data", "fused_pair_forward",
            "use_orbax", "kmeans_on_features")


def _log(msg):
    print(msg)
    sys.stdout.flush()


def check_supported(config, refused=_REFUSED, one_device=False):
    """Raise ``NotImplementedError`` naming each flag of ``refused`` that
    differs from its default (and ``ValueError`` for a ``--model_dtype``
    other than float32 or bfloat16, or an unknown ``--joint_mode``).
    ``one_device`` (the baselines, whose JAX trainers read no mesh flag)
    also refuses ``--n_devices`` above 1 and ``--joint_mode parity``."""
    compute_dtype(config.model_dtype)
    defaults = ClusterConfig()
    for name in refused:
        if getattr(config, name) != getattr(defaults, name):
            raise NotImplementedError(f"--{name} is not ported")
    if one_device and config.n_devices is not None and config.n_devices > 1:
        raise NotImplementedError("--n_devices > 1: the baselines run on one "
                                  "device")
    if one_device and config.joint_mode != "global":
        raise NotImplementedError(f"--joint_mode {config.joint_mode}: the "
                                  "baselines run on one device")
    if config.joint_mode not in ("global", "parity"):
        raise ValueError(f"--joint_mode {config.joint_mode}: expected global "
                         "or parity")


def head_order(config):
    """The cluster scripts train head B first; --head_A_first flips."""
    return ["A", "B"] if config.head_A_first else ["B", "A"]


def _select_sub_head_on_loss(config, net, pipe_b, mesh=None):
    """The sub-head of lowest IID loss over head B's epoch-0 batches, with
    eval-mode BN. Sharded: each rank feeds its shard, BatchNorm on batch
    statistics (``--batchnorm_track`` off) takes them over the ranks, as
    the JAX pick's forward over the whole batch does, and each batch's
    weighted joint is summed over ranks (padded rows weigh 0), so every
    rank sums the same losses and picks the same sub-head."""
    apply_fn = make_apply_fn(net, head="B", sobel=config.sobel,
                             include_rgb=config.include_rgb)

    if shard_of(mesh) is None:
        def pairs():
            for imgs, imgs_tf in pipe_b.epoch(0, augmented=True):
                yield apply_fn(imgs), apply_fn(imgs_tf)

        return get_subhead_using_loss(config, pairs(), lamb=config.lamb_B)

    loss_per_sub_head = np.zeros(config.num_sub_heads)
    with torch.no_grad(), global_batch_stats(net, mesh):
        for (base, weights), gen in pipe_b.epoch(0):
            imgs, imgs_tf = pipe_b.augment_pair(base, gen)
            out, out_tf = apply_fn(imgs), apply_fn(imgs_tf)
            weights = weights.repeat(out.shape[1] // weights.shape[0])
            losses, _ = IID_loss(out, out_tf, lamb=config.lamb_B,
                                 weights=weights, mesh=mesh)
            loss_per_sub_head += losses.cpu().numpy()
    return int(np.argmin(loss_per_sub_head))


def train_cluster_twohead(config, device=None):
    """Two-head unsupervised clustering (IIC). Returns (net, history).
    ``device`` defaults to cuda:0; the tests pass "cpu". With
    ``--n_devices N > 1`` it runs N ranks (``run_data_parallel``: spawned
    here, or the ranks of ``torchrun`` or of a caller's process group) and
    returns rank 0's net (on the CPU where spawned) and history."""
    if not config.twohead:
        raise ValueError("a single-head config: use train_cluster_single")
    return run_data_parallel(_train, config, device)


def train_cluster_single(config, device=None):
    """Single-head IID+ clustering (the semisup overclustering
    pretraining). Returns (net, history). ``device`` defaults to cuda:0;
    the tests pass "cpu"; ``--n_devices`` as ``train_cluster_twohead``.

    It runs the plain loss whatever ``--fused_loss`` says, as the JAX
    function does (its step takes no ``loss_impl``), so K3 is not on this
    path; and ``--double_eval`` and ``--select_sub_head_on_loss`` do
    nothing here, as there."""
    if config.twohead:
        raise ValueError("a two-head config: use train_cluster_twohead")
    return run_data_parallel(_train, config, device)


def _train(config, device, mesh):
    # the progression plots are the two-head scripts' (the JAX single-head
    # trainer never reads the flag)
    check_supported(config, _REFUSED + (() if config.twohead
                                        else ("save_progression",)))
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    main_rank = mesh is None or mesh.is_main
    sharded = adjust_batch_for_mesh(config, mesh.size if mesh else 1)
    _log(config_to_str(config))
    _log(f"device: {device}" + (f", rank {mesh.rank} of {mesh.size}"
                                if mesh else ""))

    torch.manual_seed(config.seed)  # weight init
    shard = dict(drop_last=mesh_drop_last(config, sharded),
                 process_shard=shard_of(mesh))
    if config.twohead:
        pipe_a, pipe_b, map_assign, map_test = \
            cluster_twohead_create_dataloaders(config, seed=config.seed,
                                               device=device, **shard)
    else:
        pipe_b, map_assign, map_test = cluster_create_dataloaders(
            config, seed=config.seed, device=device, **shard)
    net = models.build(config.arch, config).to(device)
    if config.bn_sync:
        sync_batch_norm(net, mesh)
    optimizer = make_optimizer(net, config)

    # a sharded global run's pipelines pad a ragged final batch and weight
    # it; parity runs drop it (and the all-ones weights)
    weighted = sharded and config.joint_mode == "global"
    common = dict(sobel=config.sobel, include_rgb=config.include_rgb,
                  mesh=mesh, joint_mode=config.joint_mode,
                  weighted=weighted)
    if config.twohead:
        pipes = {"A": pipe_a, "B": pipe_b}
        lambs = {"A": config.lamb_A, "B": config.lamb_B}
        head_epochs = {"A": config.head_A_epochs, "B": config.head_B_epochs}
        loss_impl = "fused" if config.fused_loss else "xla"
        if loss_impl == "fused" and mesh is not None:
            _log("--fused_loss: the plain loss under a mesh (the fused "
                 "kernel computes one rank's joint)")
            loss_impl = "xla"
        # (history slot, pipeline, step, passes an epoch) in training order
        passes = [(h, pipes[h], make_cluster_train_step(
            net, optimizer, pipes[h].augment_pair, lamb=lambs[h], head=h,
            loss_impl=loss_impl, **common), head_epochs[h])
            for h in head_order(config)]
        eval_head = "B"
    else:
        passes = [("B", pipe_b, make_cluster_train_step(
            net, optimizer, pipe_b.augment_pair, lamb=config.lamb,
            head=None, **common), 1)]
        eval_head = None
    apply_kw = dict(head=eval_head, sobel=config.sobel,
                    include_rgb=config.include_rgb)

    def eval_apply(train_mode=False):
        apply = make_apply_fn(net, train_mode=train_mode, **apply_kw)
        return apply if shard_of(mesh) is None else make_sharded_eval(
            apply, net, mesh)

    def evaluate(use_sub_head=None):
        double = (eval_apply(train_mode=True)
                  if config.twohead and config.double_eval else None)
        is_best, _ = cluster_eval(
            config, eval_apply(), map_assign, map_test,
            history=history["eval"], double_eval_apply_fn=double,
            use_sub_head=use_sub_head)
        return is_best

    history, next_epoch = (resume(config, net, optimizer, device)
                           if config.restart else (make_history(), 1))
    broadcast_state(net, optimizer, mesh)  # every rank from rank 0's state
    if not config.restart:
        sub_head = None
        if config.twohead and config.select_sub_head_on_loss:
            sub_head = _select_sub_head_on_loss(config, net, pipe_b, mesh)
        evaluate(sub_head)
        _log(f"Pre: {history['eval'].epoch_stats[-1]}")

    last_saved = next_epoch - 1  # epoch of the on-disk latest weights
    for e_i in range(next_epoch, config.num_epochs):
        _log(f"Starting e_i: {e_i} {datetime.now()}")
        prof = start_epoch_trace(config, e_i, next_epoch, main_rank, device)
        if e_i in set(config.lr_schedule):
            set_lr_mult(optimizer, config.lr_mult)

        for head, pipe, step, repeats in passes:
            avg_loss = avg_loss_nl = 0.0
            count = 0
            for _ in range(repeats):
                it = host_prefetch_iter(pipe.epoch(e_i), config)
                for b_i, (base, gen) in enumerate(it):
                    if sharded and not weighted:
                        base = base[0]  # parity: the all-ones weights
                    t0 = time.perf_counter()
                    with record_function(f"step_head_{head}"):
                        loss, loss_nl = step(base, gen)
                        loss, loss_nl = float(loss), float(loss_nl)  # syncs
                    history[f"step_seconds_head_{head}"].append(
                        time.perf_counter() - t0)
                    if not np.isfinite(loss):
                        _log(f"Loss is NaN/inf ({loss}). Exiting.")
                        sys.exit(1)
                    avg_loss += loss
                    avg_loss_nl += loss_nl
                    count += 1
                    if b_i % 100 == 0:
                        _log(f"  head {head} batch {b_i} loss {loss:.5f} "
                             f"{datetime.now()}")
                    if config.test_code and b_i >= 1:
                        break
                it.close()  # stops the thread after --test_code's break
            history[f"epoch_loss_head_{head}"].append(avg_loss / count)
            history[f"epoch_loss_no_lamb_head_{head}"].append(
                avg_loss_nl / count)

        is_best = evaluate()
        if config.save_progression and main_rank:
            # the MNIST progression point clouds, figure 3 of the paper
            save_progress(config, make_apply_fn(net, **apply_kw), map_assign,
                          map_test, index=e_i)
        ev = history["eval"]
        if config.twohead:
            _log(f"Epoch {e_i}: acc {ev.epoch_acc[-1]:.6f} "
                 f"avg {ev.epoch_avg_subhead_acc[-1]:.6f} "
                 f"loss A {history['epoch_loss_head_A'][-1]:.5f} "
                 f"loss B {history['epoch_loss_head_B'][-1]:.5f}")
        else:
            _log(f"Epoch {e_i}: acc {ev.epoch_acc[-1]:.6f} "
                 f"loss {history['epoch_loss_head_B'][-1]:.5f}")
        stop_epoch_trace(config, prof, e_i)

        last_saved = ckpt.save_epoch(config, net, optimizer, history, e_i,
                                     is_best, last_saved, main_rank)
        if config.test_code:
            break
    return net, history
