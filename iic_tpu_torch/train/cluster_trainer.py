"""Two-head clustering trainer (``iic_tpu/train/cluster_trainer.py``:
``train_cluster_twohead``).

The epoch / head / batch loop of the reference's cluster_sobel_twohead
script on one GPU: head B first unless ``--head_A_first`` (the opposite of
the segmentation scripts), ``head_X_epochs`` passes per head, the
multiplicative lr schedule with Adam's moments kept, the NaN exit, a
Hungarian eval (with double eval) before training and after every epoch,
optional sub-head selection by loss, latest / best checkpoints, plots.png,
``--restart`` / ``--restart_from_best``, and the ``--test_code`` mode of
two batches per head pass and one epoch.

Precision: the trunk runs in ``--model_dtype`` (float32 or bfloat16;
parameters, BN statistics, the heads, the loss and Adam stay f32). f32
cuDNN convolutions run in TF32 and matmuls (the heads, the plain loss) in
full f32; both flags are set here.

Input: each head pass's epoch runs behind the host prefetch thread
(``--prefetch_depth``, 8) unless ``--no_host_prefetch``.
"""

import sys
import time
from datetime import datetime

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
from iic_tpu_torch.data.prefetch import host_prefetch_iter
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.evals.cluster_eval import (
    cluster_eval, get_subhead_using_loss)
from iic_tpu_torch.models.layers import compute_dtype
from iic_tpu_torch.parallel.train_step import (
    make_apply_fn, make_cluster_train_step, make_optimizer, set_lr_mult)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import ClusterConfig, config_to_str
from iic_tpu_torch.train.seg_trainer import make_history, resume

# Flags outside the ported slice: each is refused when it differs from its
# default, never ignored.
_REFUSED = ("bn_sync", "epoch_scan", "resident_data", "fused_pair_forward",
            "use_orbax", "profile_dir", "save_progression", "lazy_images", "kmeans_on_features",
            "mix_train", "stl_leave_out_unlabelled")


def _log(msg):
    print(msg)
    sys.stdout.flush()


def check_supported(config):
    """Raise ``NotImplementedError`` naming each flag the port lacks (and
    ``ValueError`` for a ``--model_dtype`` other than float32 or
    bfloat16)."""
    compute_dtype(config.model_dtype)
    defaults = ClusterConfig()
    for name in _REFUSED:
        if getattr(config, name) != getattr(defaults, name):
            raise NotImplementedError(f"--{name} is not ported")
    if config.n_devices is not None and config.n_devices > 1:
        raise NotImplementedError("--n_devices > 1 is not ported (one GPU)")
    if config.joint_mode != "global":
        raise NotImplementedError(f"--joint_mode {config.joint_mode} is not "
                                  "ported")
    if not (config.twohead and config.sobel):
        raise NotImplementedError("only the two-head sobel clustering script "
                                  "is ported")


def head_order(config):
    """The cluster scripts train head B first; --head_A_first flips."""
    return ["A", "B"] if config.head_A_first else ["B", "A"]


def _select_sub_head_on_loss(config, net, pipe_b):
    """The sub-head of lowest IID loss over head B's epoch-0 batches, with
    eval-mode BN."""
    apply_fn = make_apply_fn(net, head="B", sobel=config.sobel,
                             include_rgb=config.include_rgb)

    def pairs():
        for imgs, imgs_tf in pipe_b.epoch(0, augmented=True):
            yield apply_fn(imgs), apply_fn(imgs_tf)

    return get_subhead_using_loss(config, pairs(), lamb=config.lamb_B)


def train_cluster_twohead(config, device=None):
    """Two-head unsupervised clustering (IIC). Returns (net, history).
    ``device`` defaults to cuda:0; the tests pass "cpu"."""
    check_supported(config)
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    _log(config_to_str(config))
    _log(f"device: {device}")

    torch.manual_seed(config.seed)  # weight init
    pipe_a, pipe_b, map_assign, map_test = \
        cluster_twohead_create_dataloaders(config, seed=config.seed,
                                           device=device)
    net = models.build(config.arch, config).to(device)
    optimizer = make_optimizer(net, config)

    pipes = {"A": pipe_a, "B": pipe_b}
    lambs = {"A": config.lamb_A, "B": config.lamb_B}
    loss_impl = "fused" if config.fused_loss else "xla"
    steps = {h: make_cluster_train_step(
        net, optimizer, pipes[h].augment_pair, lamb=lambs[h], head=h,
        sobel=config.sobel, include_rgb=config.include_rgb,
        loss_impl=loss_impl) for h in ("A", "B")}
    apply_kw = dict(head="B", sobel=config.sobel,
                    include_rgb=config.include_rgb)
    def evaluate(use_sub_head=None):
        double = (make_apply_fn(net, train_mode=True, **apply_kw)
                  if config.double_eval else None)
        is_best, _ = cluster_eval(
            config, make_apply_fn(net, **apply_kw), map_assign, map_test,
            history=history["eval"], double_eval_apply_fn=double,
            use_sub_head=use_sub_head)
        return is_best

    if config.restart:
        history, next_epoch = resume(config, net, optimizer, device)
    else:
        history, next_epoch = make_history(), 1
        sub_head = None
        if config.select_sub_head_on_loss:
            sub_head = _select_sub_head_on_loss(config, net, pipe_b)
        evaluate(sub_head)
        _log(f"Pre: {history['eval'].epoch_stats[-1]}")

    heads = head_order(config)
    head_epochs = {"A": config.head_A_epochs, "B": config.head_B_epochs}
    last_saved = next_epoch - 1  # epoch of the on-disk latest weights
    for e_i in range(next_epoch, config.num_epochs):
        _log(f"Starting e_i: {e_i} {datetime.now()}")
        if e_i in set(config.lr_schedule):
            set_lr_mult(optimizer, config.lr_mult)

        for head in heads:
            avg_loss = avg_loss_nl = 0.0
            count = 0
            for _ in range(head_epochs[head]):
                it = host_prefetch_iter(pipes[head].epoch(e_i), config)
                for b_i, (base, gen) in enumerate(it):
                    t0 = time.perf_counter()
                    loss, loss_nl = steps[head](base, gen)
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
        ev = history["eval"]
        _log(f"Epoch {e_i}: acc {ev.epoch_acc[-1]:.6f} "
             f"avg {ev.epoch_avg_subhead_acc[-1]:.6f} "
             f"loss A {history['epoch_loss_head_A'][-1]:.5f} "
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
