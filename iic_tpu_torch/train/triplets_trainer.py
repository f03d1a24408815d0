"""The triplets baseline trainer (``iic_tpu/train/triplets_trainer.py``:
``triplets_eval``, ``train_triplets``) on one GPU.

Anchor tf1(x), positive tf2(x), negative tf1(x') of the batch's images in
a shuffled order, each through its own forward (BN's running statistics
move three times a step, as in the JAX step), the KL triplet loss on the
logits, Adam. The eval Hungarian-matches the argmax over ``output_k`` to
the classes, or, under ``--kmeans_on_features``, the clusters of the
port's k-means (``evals.kmeans_eval``, gt_k clusters) on the trunk's
features, and records the masses and per-class hits. ``--restart``
resumes from latest.pytorch with the history cut back to its epoch.

Precision: the trunk runs in ``--model_dtype``; the Linear head, the loss
and Adam stay f32. cuDNN convolutions run in TF32, matmuls in full f32.
"""

import sys
import time
from datetime import datetime

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.data.pipeline import (
    ClusterTrainPipeline, MappingLoader, _twohead_partitions)
from iic_tpu_torch.data.prefetch import host_prefetch_iter
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.evals.kmeans_eval import KMeans
from iic_tpu_torch.evals.metrics import (
    accuracy, hungarian_match, reorder_preds)
from iic_tpu_torch.ops.baselines import triplets_loss
from iic_tpu_torch.ops.sobel import sobel_process
from iic_tpu_torch.parallel.train_step import (
    _optimizer_step, make_apply_fn, make_optimizer)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.cluster_trainer import _REFUSED as _CLUSTER_REFUSED
from iic_tpu_torch.train.cluster_trainer import check_supported
from iic_tpu_torch.train.config import config_to_str

# The IIC trainer's refusals but the flag this trainer reads, the
# progression plots and the epoch trace, which the JAX triplets trainer
# never reads, and --bn_sync (one device)
_REFUSED = tuple(f for f in _CLUSTER_REFUSED
                 if f != "kmeans_on_features") + ("save_progression",
                                                  "profile_dir", "bn_sync")


def _log(msg):
    print(msg)
    sys.stdout.flush()


def negative_order(seed, e_i, n):
    """Epoch ``e_i``'s order of the negatives: ``np.random.default_rng(
    SeedSequence([seed, e_i, 77])).permutation(n)``, the JAX trainer's."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, e_i, 77])).permutation(n)


def make_triplets_train_step(net, optimizer, sobel=False, include_rgb=False,
                             augment_pair=None, augment_tf1=None):
    """Returns ``step(batch, generator=None) -> loss`` (a detached 0-d
    tensor).

    With the augmentations: batch = (base uint8, negatives uint8), (b, H,
    W, C) each; the anchor and positive are ``augment_pair(base)``, the
    negative ``augment_tf1(negatives)``, drawn in that order from
    ``generator``. Without: batch = (orig, pos, neg), NCHW, augmented."""
    params = list(net.parameters())

    def step(batch, generator=None):
        if augment_pair is not None:
            base, negs = batch
            orig, pos = augment_pair(base, generator)
            neg = augment_tf1(negs, generator)
        else:
            orig, pos, neg = batch
        if sobel:
            orig, pos, neg = (sobel_process(t, include_rgb)
                              for t in (orig, pos, neg))
        net.train()
        loss = triplets_loss(net(orig), net(pos), net(neg))
        _optimizer_step(optimizer, params, loss)
        return loss.detach()

    return step


def triplets_eval(config, apply_fn, test_loader, history, features_fn=None):
    """Argmax predictions over the test loader (or, with ``features_fn``,
    k-means with gt_k clusters on the features, on their device), the
    Hungarian match, accuracy, masses and per-class hits appended to
    ``history``. Returns whether this is the best epoch so far."""
    targets_l = []
    if features_fn is not None:
        feats_l = []
        for imgs, targets in test_loader:
            feats_l.append(features_fn(imgs).float())
            targets_l.append(np.asarray(targets))
        km = KMeans(config.gt_k, seed=config.seed)
        flat_preds = km.fit_predict(torch.cat(feats_l)).cpu().numpy()
        preds_k = config.gt_k
    else:
        preds_l = []
        for imgs, targets in test_loader:
            preds_l.append(apply_fn(imgs).argmax(dim=1).cpu().numpy())
            targets_l.append(np.asarray(targets))
        flat_preds = np.concatenate(preds_l)
        preds_k = config.output_k
    flat_preds = flat_preds.astype(np.int32)
    flat_targets = np.concatenate(targets_l).astype(np.int32)

    match = hungarian_match(flat_preds, flat_targets, preds_k=preds_k,
                            targets_k=config.gt_k)
    reordered = reorder_preds(flat_preds, match)
    assert len({p for p, _ in match}) == config.gt_k

    mass = np.zeros(config.gt_k)
    per_class_acc = np.zeros(config.gt_k)
    for c in range(config.gt_k):
        flags = reordered == c
        mass[c] = flags.sum()
        per_class_acc[c] = (flags & (flat_targets == c)).sum()

    acc = accuracy(reordered, flat_targets, config.gt_k)
    is_best = (len(history["epoch_acc"]) > 0
               and acc > max(history["epoch_acc"]))
    history["epoch_acc"].append(acc)
    history["masses"].append(mass.tolist())
    history["per_class_acc"].append(per_class_acc.tolist())
    return is_best


def _with_negatives(pipe, e_i, order):
    """``pipe.epoch(e_i)``'s batches with their negatives, the images of
    ``order``'s matching slice, uploaded beside them: ((base, negs),
    generator)."""
    bsz = pipe.dataloader_batch_sz
    for b_i, (base, gen) in enumerate(pipe.epoch(e_i)):
        idx = order[b_i * bsz:b_i * bsz + base.shape[0]]
        negs, = pipe.upload(np.ascontiguousarray(pipe.images[idx]))
        yield (base, negs), gen


def make_history():
    return {"epoch_acc": [], "epoch_loss": [], "masses": [],
            "per_class_acc": [], "step_seconds": []}


def train_triplets(config, device=None):
    """The triplets baseline. Returns (net, history). ``device`` defaults
    to cuda:0; the tests pass "cpu"."""
    check_supported(config, refused=_REFUSED, one_device=True)
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    _log(config_to_str(config))
    _log(f"device: {device}")

    train_parts, _, _, map_test_parts = _twohead_partitions(config)
    config.train_partitions_head_A = train_parts
    config.mapping_test_partitions = map_test_parts
    torch.manual_seed(config.seed)  # weight init
    pipe = ClusterTrainPipeline(config, train_parts, seed=config.seed,
                                device=device)
    test_loader = MappingLoader(
        config, map_test_parts, device=device,
        preloaded=((pipe.images, pipe.labels)
                   if map_test_parts == train_parts else None))
    net = models.build(config.arch, config).to(device)
    optimizer = make_optimizer(net, config)
    common = dict(sobel=config.sobel, include_rgb=config.include_rgb)
    step = make_triplets_train_step(net, optimizer,
                                    augment_pair=pipe.augment_pair,
                                    augment_tf1=pipe.augment_tf1, **common)
    apply_fn = make_apply_fn(net, **common)
    features_fn = (make_apply_fn(net, kmeans_use_features=True, **common)
                   if config.kmeans_on_features else None)

    def evaluate():
        return triplets_eval(config, apply_fn, test_loader, history,
                             features_fn=features_fn)

    if config.restart:
        history, last_epoch = ckpt.load_checkpoint(config, net, optimizer,
                                                   device, name="latest")
        next_epoch = last_epoch + 1
        # the pre-train eval is "epoch 0": epoch e's eval at index e, its
        # loss at e - 1
        for k in ("epoch_acc", "masses", "per_class_acc"):
            del history[k][last_epoch + 1:]
        del history["epoch_loss"][last_epoch:]
        _log(f"restarting from epoch {next_epoch}")
    else:
        history, next_epoch = make_history(), 1
        evaluate()
        _log(f"Pre: acc {history['epoch_acc'][-1]:.6f}")

    n = len(pipe.images)
    last_saved = next_epoch - 1  # epoch of the on-disk latest weights
    for e_i in range(next_epoch, config.num_epochs):
        _log(f"Starting e_i: {e_i} {datetime.now()}")
        avg_loss = 0.0
        count = 0
        it = host_prefetch_iter(
            _with_negatives(pipe, e_i, negative_order(config.seed, e_i, n)),
            config)
        for b_i, (batch, gen) in enumerate(it):
            t0 = time.perf_counter()
            loss = float(step(batch, gen))  # syncs
            history["step_seconds"].append(time.perf_counter() - t0)
            if not np.isfinite(loss):
                _log(f"Loss is NaN/inf ({loss}). Exiting.")
                sys.exit(1)
            avg_loss += loss
            count += 1
            if b_i % 100 == 0:
                _log(f"  batch {b_i} loss {loss:.5f} {datetime.now()}")
            if config.test_code and b_i >= 1:
                break
        it.close()  # stops the thread after --test_code's break
        history["epoch_loss"].append(avg_loss / count)

        is_best = evaluate()
        _log(f"Epoch {e_i}: acc {history['epoch_acc'][-1]:.6f} "
             f"loss {avg_loss / count:.5f}")
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
