"""Segmentation trainers (``iic_tpu/train/seg_trainer.py``:
``train_segmentation_twohead``, ``train_segmentation_single``).

The epoch / head / batch loops of the reference's segmentation_twohead and
segmentation (single-head IID+ overclustering) scripts, on one GPU or on
several ranks (``--n_devices``, the JAX package's multi-host rules; see
``train_segmentation_twohead``): head A
first (``--head_B_first`` flips), the NaN exit, a Hungarian eval before
training and after every epoch, latest / best checkpoints, plots.png,
``--restart`` / ``--restart_from_best``, and the ``--test_code`` mode of
two batches per head and one epoch. The single-head script logs its
losses in the head-B slots of the history.

Precision: the trunk runs in ``--model_dtype`` (float32 or bfloat16;
parameters, BN statistics, the heads, the loss and Adam stay f32). f32
cuDNN convolutions run in TF32 and matmuls in full f32; both flags are set
here. The heads' 1x1 convs and the plain joint stay full f32, like the JAX
package's HIGHEST-precision einsums.

Input: each head pass's epoch runs behind the host prefetch thread
(``--prefetch_depth``, 8) unless ``--no_host_prefetch``.

Several ranks: each steps on its shard of the batch (``--joint_mode
global``: the (k, k, T, T) or k x k joint summed over ranks, a ragged final
batch padded with zeroed relevancy masks; ``parity``: each rank's joint,
the ragged batch dropped), ``--bn_sync`` syncs BatchNorm's batch
statistics, the eval forward runs sharded with BatchNorm's batch
statistics taken over the ranks (``parallel.mesh.make_sharded_eval``),
every rank matches the whole eval output and rank 0 alone writes the
run's files.

``--profile_dir``: a ``torch.profiler`` chrome trace of the first epoch the
run trains, its eval included (``<profile_dir>/trace_epoch_<e>.json``,
written by rank 0 alone), each step a ``step_head_<A|B>`` span.

The helpers here (``adjust_batch_for_mesh``, ``mesh_drop_last``,
``shard_of``, the history, ``resume`` and the epoch trace) serve the
clustering trainer too.
"""

import os
import sys
import time
from datetime import datetime

import numpy as np
import torch
from torch.profiler import record_function

from iic_tpu_torch import models
from iic_tpu_torch.data.prefetch import host_prefetch_iter
from iic_tpu_torch.data.seg_pipeline import segmentation_create_dataloaders
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.evals.cluster_eval import EvalHistory
from iic_tpu_torch.evals.segmentation_eval import segmentation_eval
from iic_tpu_torch.models.layers import compute_dtype, sync_batch_norm
from iic_tpu_torch.parallel.mesh import (
    broadcast_state, make_sharded_eval, run_data_parallel)
from iic_tpu_torch.parallel.train_step import (
    make_apply_fn, make_optimizer, make_seg_train_step, set_lr_mult)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import SegConfig, config_to_str

# Flags outside the ported slice: each is refused when it differs from its
# default, never ignored. The baselines' flags are read by
# ``seg_baseline_trainers`` alone, as in the JAX package.
_REFUSED = ("epoch_scan", "resident_data", "fused_pair_forward",
            "use_orbax", "select_sub_head_on_loss",
            "use_doersch_datasets", "doersch_stats", "save_multiple",
            "per_sample_patches", "max_num_kmeans_samples", "verbose",
            "doersch_patch_side", "isola_patch_side")


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
    defaults = SegConfig()
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
    if config.joint_impl not in ("pallas", "conv"):
        raise NotImplementedError(f"--joint_impl {config.joint_impl} is not "
                                  "ported")


def adjust_batch_for_mesh(config, n_ranks=None):
    """Round the per-step base batch (``dataloader_batch_sz``) down to a
    multiple of ``n_ranks`` (None: ``--n_devices``), at least ``n_ranks``
    (paper batches such as 660 and 700 do not divide 8), and ``batch_sz``
    with it. Returns whether the run is sharded (more than one rank)."""
    if n_ranks is None:
        n_ranks = config.n_devices or 1
    if n_ranks <= 1:
        return False
    dbs = config.batch_sz // config.num_dataloaders
    new_dbs = max((dbs // n_ranks) * n_ranks, n_ranks)
    if new_dbs != dbs:
        config.batch_sz = new_dbs * config.num_dataloaders
        config.dataloader_batch_sz = new_dbs
        _log(f"mesh({n_ranks}): adjusted batch_sz to {config.batch_sz} "
             f"(dataloader_batch_sz {new_dbs})")
    return True


def mesh_drop_last(config, sharded):
    """Whether the pipelines drop a ragged final batch: in a sharded
    parity run (a padded batch can leave a rank all padding, whose own
    joint would normalise zero). Global mode pads it and weights (or masks)
    the padding out."""
    return sharded and config.joint_mode == "parity"


def shard_of(mesh):
    """A pipeline's ``process_shard`` on ``mesh``: (rank, world) when the
    batch is sharded over more than one rank, else None."""
    return (mesh.rank, mesh.size) if mesh is not None and mesh.size > 1 \
        else None


def head_order(config):
    """The seg scripts train head A first; --head_B_first flips."""
    return ["B", "A"] if config.head_B_first else ["A", "B"]


def make_history():
    history = {"eval": EvalHistory()}
    for head in ("A", "B"):
        for key in ("epoch_loss_head_", "epoch_loss_no_lamb_head_",
                    "step_seconds_head_"):
            history[key + head] = []
    return history


def truncate_history(history, next_epoch):
    """Drop the eval entries and epoch losses past epoch next_epoch - 1
    (the step times stay: they log the steps that ran)."""
    history["eval"].truncate(next_epoch - 1)
    for head in ("A", "B"):
        for key in ("epoch_loss_head_", "epoch_loss_no_lamb_head_"):
            del history[key + head][next_epoch - 1:]


def resume(config, net, optimizer, device):
    """``--restart``: restore net and optimiser from latest.pytorch (or
    best.pytorch under ``--restart_from_best``) and the history from
    config.pickle. Returns (history, next_epoch): the epoch after the saved
    one, or after the best eval's."""
    history, last_epoch = ckpt.load_checkpoint(
        config, net, optimizer, device,
        name="best" if config.restart_from_best else "latest")
    next_epoch = (int(np.argmax(history["eval"].epoch_acc)) + 1
                  if config.restart_from_best else last_epoch + 1)
    truncate_history(history, next_epoch)
    _log(f"restarting from epoch {next_epoch}")
    return history, next_epoch


def start_epoch_trace(config, e_i, next_epoch, main_rank, device):
    """``--profile_dir``: start a ``torch.profiler`` trace of epoch ``e_i``
    if it is the first the run trains (``next_epoch``) and this process
    writes the run's files (``main_rank``): CPU activity and, on a CUDA
    device, CUDA's. Returns the running profiler, or None."""
    if not config.profile_dir or e_i != next_epoch or not main_rank:
        return None
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_epoch_trace(config, prof, e_i):
    """Stop ``prof`` (None: nothing to do) and write its chrome trace to
    ``<profile_dir>/trace_epoch_<e_i>.json``. Returns the path, or None."""
    if prof is None:
        return None
    prof.stop()
    os.makedirs(config.profile_dir, exist_ok=True)
    path = os.path.join(config.profile_dir, f"trace_epoch_{e_i}.json")
    prof.export_chrome_trace(path)
    _log(f"profile: epoch {e_i}'s trace written to {path}")
    return path


def train_segmentation_twohead(config, device=None):
    """Two-head unsupervised segmentation (IIC). Returns (net, history).
    ``device`` defaults to cuda:0; the tests pass "cpu". With
    ``--n_devices N > 1`` it runs N ranks (``run_data_parallel``: spawned
    here, or the ranks of ``torchrun`` or of a caller's process group) and
    returns rank 0's net (on the CPU where spawned) and history."""
    if not config.twohead:
        raise ValueError("a single-head config: use "
                         "train_segmentation_single")
    return run_data_parallel(_train, config, device)


def train_segmentation_single(config, device=None):
    """Single-head IID+ segmentation (overclustering). Returns (net,
    history). ``device`` defaults to cuda:0; the tests pass "cpu";
    ``--n_devices`` as ``train_segmentation_twohead``."""
    if config.twohead:
        raise ValueError("a two-head config: use train_segmentation_twohead")
    return run_data_parallel(_train, config, device)


def _train(config, device, mesh):
    check_supported(config)
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    main_rank = mesh is None or mesh.is_main
    sharded = adjust_batch_for_mesh(config, mesh.size if mesh else 1)
    _log(config_to_str(config))
    _log(f"device: {device}" + (f", rank {mesh.rank} of {mesh.size}"
                                if mesh else ""))

    torch.manual_seed(config.seed)  # weight init
    pipe, map_assign, map_test = segmentation_create_dataloaders(
        config, seed=config.seed, device=device,
        drop_last=mesh_drop_last(config, sharded),
        process_shard=shard_of(mesh))
    net = models.build(config.arch, config).to(device)
    if config.bn_sync:
        sync_batch_norm(net, mesh)
    optimizer = make_optimizer(net, config)

    common = dict(
        half_T_side_dense=config.half_T_side_dense,
        half_T_side_sparse_min=config.half_T_side_sparse_min,
        half_T_side_sparse_max=config.half_T_side_sparse_max,
        sobel=config.sobel, include_rgb=config.include_rgb,
        using_IR=config.using_IR,
        use_uncollapsed_loss=config.use_uncollapsed_loss,
        augment=pipe.augment, joint_impl=config.joint_impl, mesh=mesh,
        joint_mode=config.joint_mode)
    if config.twohead:
        lambs = {"A": config.lamb_A, "B": config.lamb_B}
        head_epochs = {"A": config.head_A_epochs, "B": config.head_B_epochs}
        # (history slot, step, passes an epoch) in training order
        passes = [(h, make_seg_train_step(net, optimizer, lamb=lambs[h],
                                          head=h, **common), head_epochs[h])
                  for h in head_order(config)]
        eval_head = "B"
    else:
        passes = [("B", make_seg_train_step(net, optimizer, lamb=config.lamb,
                                            head=None, **common), 1)]
        eval_head = None
    apply_fn = make_apply_fn(net, head=eval_head, sobel=config.sobel,
                             include_rgb=config.include_rgb,
                             using_IR=config.using_IR)
    if shard_of(mesh) is not None:
        apply_fn = make_sharded_eval(apply_fn, net, mesh)

    def evaluate():
        return segmentation_eval(config, apply_fn, map_assign, map_test,
                                 history=history["eval"])

    history, next_epoch = (resume(config, net, optimizer, device)
                           if config.restart else (make_history(), 1))
    broadcast_state(net, optimizer, mesh)  # every rank from rank 0's state
    if not config.restart:
        if not config.no_pre_eval:
            evaluate()
            _log(f"Pre: {history['eval'].epoch_stats[-1]}")
        else:
            history["eval"].epoch_acc.append(0.0)
            history["eval"].epoch_avg_subhead_acc.append(0.0)
            history["eval"].epoch_stats.append({})

    last_saved = next_epoch - 1  # epoch of the on-disk latest weights
    for e_i in range(next_epoch, config.num_epochs):
        _log(f"Starting e_i: {e_i} {datetime.now()}")
        prof = start_epoch_trace(config, e_i, next_epoch, main_rank, device)
        if e_i in set(config.lr_schedule):
            set_lr_mult(optimizer, config.lr_mult)

        for head, step, repeats in passes:
            avg_loss = avg_loss_nl = 0.0
            count = 0
            for _ in range(repeats):
                it = host_prefetch_iter(pipe.epoch(e_i), config)
                for b_i, (imgs, masks, gen) in enumerate(it):
                    t0 = time.perf_counter()
                    with record_function(f"step_head_{head}"):
                        loss, loss_nl = step((imgs, masks), gen)
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
        _log(f"Epoch {e_i}: acc {history['eval'].epoch_acc[-1]:.6f} "
             f"loss B {history['epoch_loss_head_B'][-1]:.5f}")
        stop_epoch_trace(config, prof, e_i)

        last_saved = ckpt.save_epoch(config, net, optimizer, history, e_i,
                                     is_best, last_saved, main_rank)
        if config.test_code:
            break
    return net, history
