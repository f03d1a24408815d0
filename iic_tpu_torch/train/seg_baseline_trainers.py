"""The Doersch and Isola segmentation baseline trainers
(``iic_tpu/train/seg_baseline_trainers.py``) on one GPU.

They train the siamese patch heads of ``models.seg_baselines`` with
self-supervised patch-pair objectives (9-way relative position
cross-entropy, adjacency binary cross-entropy), and evaluate by k-means on
the upsampled trunk features with a Hungarian match
(``evals.kmeans_eval.kmeans_segmentation_eval``).

By default one (centre, other, label) pair serves the whole batch, drawn
on the host with the reference's polar geometry from
``SeedSequence([seed, epoch, batch])`` (the JAX trainer's numpy draws, bit
for bit), and the loss is relevancy-masked per sample: a pair counts iff
either centre lies in the mask. ``--per_sample_patches`` draws an
independent pair per image on the device instead. Doersch's colour
dropping (``--use_doersch_datasets`` with ``--include_rgb``; the Doersch
CLI sets it) keeps one rgb channel per image and replaces the other two
with noise at that channel's mean and std / 100, before sobel.

The nets run in float32 whatever ``--model_dtype`` says (the JAX factories
pass no dtype); cuDNN convolutions in TF32, matmuls in full f32. Dropout
draws from the device's default generator, seeded with ``--seed`` before
the weights are made.
"""

import os
import pickle
import sys
import time
from datetime import datetime

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.data.prefetch import host_prefetch_iter
from iic_tpu_torch.data.seg_pipeline import segmentation_create_dataloaders
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.evals.kmeans_eval import kmeans_segmentation_eval
from iic_tpu_torch.ops.baselines import doersch_loss, isola_loss
from iic_tpu_torch.ops.sobel import sobel_process
from iic_tpu_torch.parallel.train_step import (
    _optimizer_step, make_apply_fn, make_optimizer)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import config_to_str
from iic_tpu_torch.train.seg_trainer import check_supported

# The IIC seg trainer's refusals that are no baseline flags
_REFUSED = ("bn_sync", "epoch_scan", "resident_data", "fused_pair_forward",
            "use_orbax", "profile_dir")

# 3x3 grid of relative positions (incl. centre): the 9 Doersch classes.
_POSITIONS = np.array([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                      np.int64)


def _log(msg):
    print(msg)
    sys.stdout.flush()


def _pol2cart(r, phi):
    """(y, x) = (r sin phi, r cos phi)."""
    return r * np.sin(phi), r * np.cos(phi)


def compute_doersch_rgb_stats(config, pipe, max_imgs=2000):
    """Masked rgb pixel mean and standard deviation over the raw train
    frames in [0, 1] (datasets of more than ``max_imgs`` images: a seeded
    subsample), the stats Doersch's noise draws from. Cached as
    ``<doersch_stats>/<dataset>_stats.pickle`` when ``--doersch_stats`` is
    set, and read from there (a file the JAX trainer wrote too). Returns
    (mean (3,), stddev (3,)) float32."""
    cache = None
    stats_dir = getattr(config, "doersch_stats", "")
    if stats_dir:
        os.makedirs(stats_dir, exist_ok=True)
        cache = os.path.join(stats_dir, f"{config.dataset}_stats.pickle")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                stats = pickle.load(f)
            return (np.asarray(stats["mean"], np.float32),
                    np.asarray(stats["stddev"], np.float32))

    _log("computing Doersch rgb stats over the train set")
    tot = np.zeros(3, np.float64)
    tot_sq = np.zeros(3, np.float64)
    count = 0
    for d in pipe.datasets:
        n = len(d)
        idxs = range(n)
        if n > max_imgs:
            idxs = np.random.default_rng(config.seed).choice(
                n, max_imgs, replace=False)
        for i in idxs:
            img, label = d._load_raw(i)
            if label is not None:
                _, mask = d._filter_label(np.asarray(label))
            else:
                mask = np.ones(np.asarray(img).shape[:2], bool)
            rgb = np.asarray(img, np.float32)[..., :3] / 255.0
            sel = rgb[mask]  # (n_relevant, 3)
            tot += sel.sum(axis=0)
            tot_sq += (sel.astype(np.float64) ** 2).sum(axis=0)
            count += sel.shape[0]
    if count == 0:
        raise ValueError("no relevant pixels for the Doersch stats")
    mean = tot / count
    stddev = np.sqrt(np.maximum(tot_sq / count - mean ** 2, 0.0))
    _log(f"Doersch rgb stats: mean {mean} stddev {stddev}")
    if cache:
        with open(cache, "wb") as f:
            pickle.dump({"mean": mean, "stddev": stddev}, f)
    return mean.astype(np.float32), stddev.astype(np.float32)


def doersch_channel_noise(generator, img, mean3, std3):
    """Colour dropping: per image keep ONE random rgb channel of the NCHW
    batch and replace the other two with Gaussian noise of the kept
    channel's mean and stddev / 100. Channels past the first 3 pass
    through."""
    b = img.shape[0]
    keep = torch.randint(0, 3, (b,), generator=generator, device=img.device)
    noise = (torch.randn((b, 3) + tuple(img.shape[2:]), generator=generator,
                         device=img.device, dtype=img.dtype)
             * (std3[keep] / 100.0)[:, None, None, None]
             + mean3[keep][:, None, None, None])
    replaced = torch.arange(3, device=img.device)[None, :] != keep[:, None]
    rgb = torch.where(replaced[:, :, None, None], noise, img[:, :3])
    return torch.cat([rgb, img[:, 3:]], dim=1)


def _check_geometry(input_sz, patch_side):
    if input_sz <= 3 * patch_side:
        raise ValueError(f"--input_sz {input_sz} must exceed 3 patch sides "
                         f"({patch_side})")


def doersch_set_patches(rng, input_sz, patch_side):
    """One shared (centre (2,), other (2,), position_gt) per batch, the
    reference's geometry: position_gt in 0..8 at angle position_gt * pi/4
    (classes 0 and 8 alias at phi = 0; there is no centre class), radius
    uniform in [1.5, 2) * patch_side, centre uniform in [1.5p, sz - 1.5p),
    re-drawn until ``other`` clears the floor(p / 2) border."""
    _check_geometry(input_sz, patch_side)
    img_sz = np.array([input_sz, input_sz])
    d_border = np.floor(patch_side / 2.0) * np.ones(2)
    patch = np.array([patch_side, patch_side], np.float64)
    while True:
        position_gt = int(rng.integers(9))
        start, end = 1.5 * patch, img_sz - 1.5 * patch
        centre = np.floor(rng.random(2) * (end - start) + start).astype(int)
        r = rng.random() * (2.0 - 1.5) * patch_side + 1.5 * patch_side
        dh, dw = _pol2cart(r, position_gt * np.pi / 4.0)
        other = (centre + np.array([dh, dw])).astype(np.int32)
        if (other >= d_border).all() and (other < img_sz - d_border).all():
            return centre.astype(np.int32), other, position_gt


def isola_set_patches(rng, input_sz, patch_side):
    """One shared (centre, other, adjacent) per batch, the reference's
    geometry: adjacent pairs are diagonal block neighbours (both offsets
    +-patch_side); non-adjacent ones sit at radius [2p, sz) in a uniform
    direction. On a tight geometry (sz < 4p) ``adjacent`` is re-drawn
    every 100 attempts, where a non-adjacent placement may not exist."""
    _check_geometry(input_sz, patch_side)
    img_sz = np.array([input_sz, input_sz])
    d_border = np.floor(patch_side / 2.0) * np.ones(2)
    patch = np.array([patch_side, patch_side], np.float64)
    adjacent = bool(rng.random() < 0.5)
    tight = input_sz < 4 * patch_side
    attempt = 0
    while True:
        attempt += 1
        if tight and attempt % 100 == 0:
            adjacent = bool(rng.random() < 0.5)
        start, end = 1.5 * patch, img_sz - 1.5 * patch
        centre = np.floor(rng.random(2) * (end - start) + start).astype(int)
        if adjacent:
            d = np.array([rng.choice([-1, 1]) * patch_side,
                          rng.choice([-1, 1]) * patch_side])
            other = np.floor(centre + d).astype(np.int32)
        else:
            r = rng.random() * (input_sz - 2.0 * patch_side) \
                + 2.0 * patch_side
            dh, dw = _pol2cart(r, rng.random() * 2.0 * np.pi)
            other = (centre + np.array([dh, dw])).astype(np.int32)
        if (other >= d_border).all() and (other < img_sz - d_border).all():
            return centre.astype(np.int32), other, int(adjacent)


def sample_doersch_pairs(generator, batch, input_sz, patch_side, device):
    """``--per_sample_patches``: per sample (centre, other, label), the
    label uniform over the 3x3 grid of offsets (centre included), other =
    centre + offset * patch_side."""
    margin = patch_side // 2 + patch_side + 1
    centre = torch.randint(margin, input_sz - margin, (batch, 2),
                           generator=generator, device=device)
    labels = torch.randint(0, 9, (batch,), generator=generator,
                           device=device)
    offsets = torch.as_tensor(_POSITIONS, device=device)[labels]
    return centre, centre + offsets * patch_side, labels


def sample_isola_pairs(generator, batch, input_sz, patch_side, device):
    """``--per_sample_patches``: per sample (centre, other, is_adjacent):
    half adjacent (patch_side away in one of the 8 compass directions),
    half distant (3 or 4 patch sides away in one)."""
    margin = patch_side // 2 + 4 * patch_side + 1
    centre = torch.randint(margin, input_sz - margin, (batch, 2),
                           generator=generator, device=device)
    is_adj = torch.rand((batch,), generator=generator, device=device) < 0.5
    dir_idx = torch.randint(0, 8, (batch,), generator=generator,
                            device=device)
    far = torch.randint(3, 5, (batch, 1), generator=generator, device=device)
    dirs = torch.as_tensor(np.concatenate([_POSITIONS[:4], _POSITIONS[5:]]),
                           device=device)[dir_idx] * patch_side
    other = torch.where(is_adj[:, None], centre + dirs, centre + dirs * far)
    return centre, other, is_adj.long()


def _index(i, size):
    """A JAX gather index: negative counts from the end, then clamped."""
    return torch.where(i < 0, i + size, i).clamp(0, size - 1)


def pair_relevance(mask, centre, other):
    """(b,) float32: 1 where the mask (b, h, w) is set at either centre."""
    b, h, w = mask.shape
    rows = torch.arange(b, device=mask.device)

    def at(c):
        return mask[rows, _index(c[:, 0], h), _index(c[:, 1], w)]

    return ((at(centre) + at(other)) > 0).to(torch.float32)


def make_seg_baseline_train_step(net, optimizer, kind, input_sz, patch_side,
                                 sobel=False, include_rgb=False,
                                 using_IR=False, augment=None,
                                 noise_stats=None, per_sample=False):
    """Returns ``step(batch, generator=None, pair=None) -> loss`` (a
    detached 0-d tensor), ``kind`` "doersch" or "isola".

    With ``augment``: batch = (imgs_u8, masks_u8) and the augmentation
    draws from ``generator``; without: batch = (img1 NCHW, mask), img1
    sobel-ready. Then the colour noise (``noise_stats`` = (mean3, std3)
    tensors), sobel, the pairs (``pair`` = (centre, other, label) for the
    batch, or drawn per sample under ``per_sample``), the relevancy mask
    per pair, the loss and one Adam step."""
    loss_fn = doersch_loss if kind == "doersch" else isola_loss
    sample_fn = (sample_doersch_pairs if kind == "doersch"
                 else sample_isola_pairs)
    params = list(net.parameters())

    def step(batch, generator=None, pair=None):
        if augment is not None:
            imgs_u8, masks_u8 = batch
            img1, _, _, mask = augment(imgs_u8, masks_u8, generator)
        else:
            img1, mask = batch
        if noise_stats is not None:
            img1 = doersch_channel_noise(generator, img1, *noise_stats)
        if sobel:
            img1 = sobel_process(img1, include_rgb, using_IR=using_IR)
        b, dev = img1.shape[0], img1.device
        if per_sample:
            centre, other, labels = sample_fn(generator, b, input_sz,
                                              patch_side, dev)
        else:
            c, o, lab = pair
            centre = torch.as_tensor(c, device=dev).long().expand(b, 2)
            other = torch.as_tensor(o, device=dev).long().expand(b, 2)
            labels = torch.as_tensor(lab, device=dev)
        relevant = pair_relevance(mask, centre, other)
        net.train()
        loss = loss_fn(net(img1, centre, other), labels, relevant)
        _optimizer_step(optimizer, params, loss)
        return loss.detach()

    return step


def train_seg_baseline(config, kind, device=None):
    """``kind``: "doersch" | "isola". Returns (net, history). ``device``
    defaults to cuda:0; the tests pass "cpu"."""
    if kind not in ("doersch", "isola"):
        raise ValueError(f"unknown baseline {kind!r}")
    check_supported(config, refused=_REFUSED, one_device=True)
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    _log(config_to_str(config))
    _log(f"device: {device}; the {kind} net runs in float32 (--model_dtype "
         f"{config.model_dtype} is not read, as in the JAX package)")

    pipe, map_assign, _ = segmentation_create_dataloaders(
        config, seed=config.seed, device=device)
    torch.manual_seed(config.seed)  # weight init and dropout
    net = models.build(config.arch, config).to(device)
    optimizer = make_optimizer(net, config)
    patch_side = (config.doersch_patch_side if kind == "doersch"
                  else config.isola_patch_side)
    noise_stats = None
    if config.use_doersch_datasets and config.include_rgb:
        noise_stats = tuple(torch.from_numpy(s).to(device) for s in
                            compute_doersch_rgb_stats(config, pipe))
    per_sample = config.per_sample_patches
    set_fn = doersch_set_patches if kind == "doersch" else isola_set_patches
    common = dict(sobel=config.sobel, include_rgb=config.include_rgb,
                  using_IR=config.using_IR)
    step = make_seg_baseline_train_step(
        net, optimizer, kind, config.input_sz, patch_side,
        augment=pipe.augment, noise_stats=noise_stats,
        per_sample=per_sample, **common)
    # the k-means eval's features: the upsampled trunk's, eval-mode BN
    features_fn = make_apply_fn(net, penultimate=True, **common)
    kmeans_kwargs = {"verbose": config.verbose}
    if config.max_num_kmeans_samples > 0:
        kmeans_kwargs["max_num_samples"] = config.max_num_kmeans_samples

    def evaluate():
        return kmeans_segmentation_eval(features_fn, map_assign, config.gt_k,
                                        **kmeans_kwargs)["acc"]

    if config.restart:
        history, last_epoch = ckpt.load_checkpoint(config, net, optimizer,
                                                   device, name="latest")
        next_epoch = last_epoch + 1
        # the pre-train eval is "epoch 0": epoch e's acc at index e, its
        # loss at e - 1
        del history["epoch_acc"][last_epoch + 1:]
        del history["epoch_loss"][last_epoch:]
        _log(f"restarting from epoch {next_epoch}")
    else:
        history = {"epoch_acc": [], "epoch_loss": [], "step_seconds": []}
        next_epoch = 1
        history["epoch_acc"].append(evaluate())
        _log(f"Pre: kmeans acc {history['epoch_acc'][-1]:.6f}")

    last_saved = next_epoch - 1  # epoch of the on-disk latest weights
    for e_i in range(next_epoch, config.num_epochs):
        _log(f"Starting e_i: {e_i} {datetime.now()}")
        avg_loss = 0.0
        count = 0
        it = host_prefetch_iter(pipe.epoch(e_i), config)
        for b_i, (imgs, masks, gen) in enumerate(it):
            pair = None if per_sample else set_fn(
                np.random.default_rng(np.random.SeedSequence(
                    [config.seed, e_i, b_i])), config.input_sz, patch_side)
            t0 = time.perf_counter()
            loss = float(step((imgs, masks), gen, pair))  # syncs
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

        acc = evaluate()
        is_best = acc > max(history["epoch_acc"])
        history["epoch_acc"].append(acc)
        _log(f"Epoch {e_i}: kmeans acc {acc:.6f} "
             f"loss {avg_loss / count:.5f}")
        if e_i % config.save_freq == 0 or e_i == config.num_epochs - 1:
            ckpt.save_checkpoint(config, net, optimizer, history, "latest",
                                 last_epoch=e_i)
            last_saved = e_i
        if is_best:
            ckpt.save_checkpoint(config, net, optimizer, history, "best",
                                 last_epoch=last_saved)
        if config.save_multiple and e_i % 3 == 0:
            ckpt.save_checkpoint(config, net, optimizer, history, f"e_{e_i}",
                                 last_epoch=e_i)
        ckpt.save_meta(config, history, last_saved)
        if config.test_code:
            break
    return net, history
