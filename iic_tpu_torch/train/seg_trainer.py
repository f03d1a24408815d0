"""Segmentation trainers (``iic_tpu/train/seg_trainer.py``:
``train_segmentation_twohead``, ``train_segmentation_single``).

The epoch / head / batch loops of the reference's segmentation_twohead and
segmentation (single-head IID+ overclustering) scripts on one GPU: head A
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
"""

import sys
import time
from datetime import datetime

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.data.prefetch import host_prefetch_iter
from iic_tpu_torch.data.seg_pipeline import segmentation_create_dataloaders
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.evals.cluster_eval import EvalHistory
from iic_tpu_torch.evals.segmentation_eval import segmentation_eval
from iic_tpu_torch.models.layers import compute_dtype
from iic_tpu_torch.parallel.train_step import (
    make_apply_fn, make_optimizer, make_seg_train_step, set_lr_mult)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import SegConfig, config_to_str

# Flags outside the ported slice: each is refused when it differs from its
# default, never ignored. The baselines' flags are read by
# ``seg_baseline_trainers`` alone, as in the JAX package.
_REFUSED = ("bn_sync", "epoch_scan", "resident_data", "fused_pair_forward",
            "use_orbax", "profile_dir", "select_sub_head_on_loss",
            "use_doersch_datasets", "doersch_stats", "save_multiple",
            "per_sample_patches", "max_num_kmeans_samples", "verbose",
            "doersch_patch_side", "isola_patch_side")


def _log(msg):
    print(msg)
    sys.stdout.flush()


def check_supported(config, refused=_REFUSED):
    """Raise ``NotImplementedError`` naming each flag of ``refused`` that
    differs from its default (and ``ValueError`` for a ``--model_dtype``
    other than float32 or bfloat16)."""
    compute_dtype(config.model_dtype)
    defaults = SegConfig()
    for name in refused:
        if getattr(config, name) != getattr(defaults, name):
            raise NotImplementedError(f"--{name} is not ported")
    if config.n_devices is not None and config.n_devices > 1:
        raise NotImplementedError("--n_devices > 1 is not ported (one GPU)")
    if config.joint_mode != "global":
        raise NotImplementedError(f"--joint_mode {config.joint_mode} is not "
                                  "ported")
    if config.joint_impl not in ("pallas", "conv"):
        raise NotImplementedError(f"--joint_impl {config.joint_impl} is not "
                                  "ported")


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


def train_segmentation_twohead(config, device=None):
    """Two-head unsupervised segmentation (IIC). Returns (net, history).
    ``device`` defaults to cuda:0; the tests pass "cpu"."""
    if not config.twohead:
        raise ValueError("a single-head config: use "
                         "train_segmentation_single")
    return _train(config, device)


def train_segmentation_single(config, device=None):
    """Single-head IID+ segmentation (overclustering). Returns (net,
    history). ``device`` defaults to cuda:0; the tests pass "cpu"."""
    if config.twohead:
        raise ValueError("a two-head config: use train_segmentation_twohead")
    return _train(config, device)


def _train(config, device):
    check_supported(config)
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    _log(config_to_str(config))
    _log(f"device: {device}")

    torch.manual_seed(config.seed)  # weight init
    pipe, map_assign, map_test = segmentation_create_dataloaders(
        config, seed=config.seed, device=device)
    net = models.build(config.arch, config).to(device)
    optimizer = make_optimizer(net, config)

    common = dict(
        half_T_side_dense=config.half_T_side_dense,
        half_T_side_sparse_min=config.half_T_side_sparse_min,
        half_T_side_sparse_max=config.half_T_side_sparse_max,
        sobel=config.sobel, include_rgb=config.include_rgb,
        using_IR=config.using_IR,
        use_uncollapsed_loss=config.use_uncollapsed_loss,
        augment=pipe.augment, joint_impl=config.joint_impl)
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

    def evaluate():
        return segmentation_eval(config, apply_fn, map_assign, map_test,
                                 history=history["eval"])

    if config.restart:
        history, next_epoch = resume(config, net, optimizer, device)
    else:
        history, next_epoch = make_history(), 1
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
        if e_i in set(config.lr_schedule):
            set_lr_mult(optimizer, config.lr_mult)

        for head, step, repeats in passes:
            avg_loss = avg_loss_nl = 0.0
            count = 0
            for _ in range(repeats):
                it = host_prefetch_iter(pipe.epoch(e_i), config)
                for b_i, (imgs, masks, gen) in enumerate(it):
                    t0 = time.perf_counter()
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

        ckpt.save_plots(config, history)
        if e_i % config.save_freq == 0 or e_i == config.num_epochs - 1:
            ckpt.save_checkpoint(config, net, optimizer, history, "latest",
                                 last_epoch=e_i)
            last_saved = e_i
        if is_best:
            ckpt.save_checkpoint(config, net, optimizer, history, "best",
                                 last_epoch=last_saved)
        ckpt.save_meta(config, history, last_saved)
        if config.test_code:
            break
    return net, history
