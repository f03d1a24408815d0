"""Two-head segmentation trainer (``iic_tpu/train/seg_trainer.py``:
``train_segmentation_twohead``).

The epoch / head / batch loop of the reference's segmentation_twohead
script on one GPU: head A first (``--head_B_first`` flips), the NaN exit,
a Hungarian eval before training and after every epoch, latest / best
checkpoints, and the ``--test_code`` mode of two batches per head and one
epoch.

Precision: cuDNN convolutions (the trunk) run in TF32 and matmuls in full
f32; both flags are set here. The heads' 1x1 convs and the plain joint
stay full f32, like the JAX package's HIGHEST-precision einsums.
"""

import sys
import time
from datetime import datetime

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.data.seg_pipeline import segmentation_create_dataloaders
from iic_tpu_torch.evals.cluster_eval import EvalHistory
from iic_tpu_torch.evals.segmentation_eval import segmentation_eval
from iic_tpu_torch.parallel.train_step import (
    make_optimizer, make_seg_apply_fn, make_seg_train_step, set_lr_mult)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import SegConfig, config_to_str

# Flags outside the ported slice: each is refused when it differs from its
# default, never ignored.
_REFUSED = ("bn_sync", "epoch_scan", "resident_data", "fused_pair_forward",
            "use_orbax", "restart", "restart_from_best", "profile_dir",
            "prefetch_depth", "select_sub_head_on_loss",
            "use_doersch_datasets", "doersch_stats", "save_multiple",
            "per_sample_patches", "max_num_kmeans_samples", "verbose",
            "doersch_patch_side", "isola_patch_side")


def _log(msg):
    print(msg)
    sys.stdout.flush()


def check_supported(config):
    """Raise ``NotImplementedError`` naming each flag the port lacks."""
    defaults = SegConfig()
    for name in _REFUSED:
        if getattr(config, name) != getattr(defaults, name):
            raise NotImplementedError(f"--{name} is not ported")
    if config.n_devices is not None and config.n_devices > 1:
        raise NotImplementedError("--n_devices > 1 is not ported (one GPU)")
    if config.joint_mode != "global":
        raise NotImplementedError(f"--joint_mode {config.joint_mode} is not "
                                  "ported")
    if config.model_dtype != "float32":
        raise NotImplementedError(f"--model_dtype {config.model_dtype} is "
                                  "not ported (the port runs float32)")
    if config.joint_impl not in ("pallas", "conv"):
        raise NotImplementedError(f"--joint_impl {config.joint_impl} is not "
                                  "ported")
    if not config.twohead:
        raise NotImplementedError("the single-head segmentation script is "
                                  "not ported")


def resolve_device(device=None):
    """``cuda:0`` unless a device is given; no GPU is an error."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the trainer runs on cuda:0 and found no GPU")
    return torch.device("cuda:0")


def head_order(config):
    """The seg scripts train head A first; --head_B_first flips."""
    return ["B", "A"] if config.head_B_first else ["A", "B"]


def _make_history():
    history = {"eval": EvalHistory()}
    for head in ("A", "B"):
        for key in ("epoch_loss_head_", "epoch_loss_no_lamb_head_",
                    "step_seconds_head_"):
            history[key + head] = []
    return history


def train_segmentation_twohead(config, device=None):
    """Two-head unsupervised segmentation (IIC). Returns (net, history).
    ``device`` defaults to cuda:0; the tests pass "cpu"."""
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
    lambs = {"A": config.lamb_A, "B": config.lamb_B}
    steps = {h: make_seg_train_step(net, optimizer, lamb=lambs[h], head=h,
                                    **common) for h in ("A", "B")}
    apply_fn = make_seg_apply_fn(net, head="B", sobel=config.sobel,
                                 include_rgb=config.include_rgb,
                                 using_IR=config.using_IR)

    def evaluate():
        return segmentation_eval(config, apply_fn, map_assign, map_test,
                                 history=history["eval"])

    heads = head_order(config)
    head_epochs = {"A": config.head_A_epochs, "B": config.head_B_epochs}
    history = _make_history()
    if not config.no_pre_eval:
        evaluate()
        _log(f"Pre: {history['eval'].epoch_stats[-1]}")
    else:
        history["eval"].epoch_acc.append(0.0)
        history["eval"].epoch_avg_subhead_acc.append(0.0)
        history["eval"].epoch_stats.append({})

    last_saved = 0  # epoch of the on-disk latest weights
    for e_i in range(1, config.num_epochs):
        _log(f"Starting e_i: {e_i} {datetime.now()}")
        if e_i in set(config.lr_schedule):
            set_lr_mult(optimizer, config.lr_mult)

        for head in heads:
            avg_loss = avg_loss_nl = 0.0
            count = 0
            for _ in range(head_epochs[head]):
                for b_i, (imgs, masks, gen) in enumerate(pipe.epoch(e_i)):
                    t0 = time.perf_counter()
                    loss, loss_nl = steps[head]((imgs, masks), gen)
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
            history[f"epoch_loss_head_{head}"].append(avg_loss / count)
            history[f"epoch_loss_no_lamb_head_{head}"].append(
                avg_loss_nl / count)

        is_best = evaluate()
        _log(f"Epoch {e_i}: acc {history['eval'].epoch_acc[-1]:.6f} "
             f"loss B {history['epoch_loss_head_B'][-1]:.5f}")

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
