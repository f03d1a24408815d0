"""Rendering utilities (``iic_tpu/utils/render.py``).

Segmentation render (reference: code/utils/segmentation/render.py:11-149):
save images / relevancy masks / label maps / prediction maps / affine
matrices to PNG (label colour maps via a consistent palette).

MNIST progression rendering (reference: code/utils/cluster/render.py:
13-170): per-epoch convex-combination point cloud of soft predictions with
the fixed GT_TO_ORDER colour permutation, plus per-cluster average images.
"""

import os
from colorsys import hsv_to_rgb

import numpy as np
import torch

# consistent colour permutation for MNIST progression
# (code/utils/cluster/render.py:13)
GT_TO_ORDER = [2, 5, 3, 8, 6, 7, 0, 9, 1, 4]


def _palette(k):
    hues = np.linspace(0.0, 1.0, k + 1)[:-1]
    return np.array([(np.array(hsv_to_rgb(h, 0.8, 0.8)) * 255)
                     for h in hues], dtype=np.uint8)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def render(data, mode, name, colour_map=None, offset=0, out_dir=""):
    """Save data to ``out_dir/name[...].png``. Modes: image | image_ir |
    image_as_feat | mask | label | matrix | preds."""
    from PIL import Image

    data = _np(data)
    if mode.startswith("image") or mode == "label":
        if data.ndim == 4:
            for i in range(data.shape[0]):
                render(data[i], mode, f"{name}_{i + offset}",
                       colour_map=colour_map, out_dir=out_dir)
            return
    else:
        if data.ndim == 3:
            for i in range(data.shape[0]):
                render(data[i], mode, f"{name}_{i + offset}",
                       colour_map=colour_map, out_dir=out_dir)
            return

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    out_handle = os.path.join(out_dir, name)

    if mode == "image":
        img = np.transpose(data, (1, 2, 0))
        if img.shape[2] >= 3:
            img = img[:, :, :3]
        else:
            img = img[:, :, 0]
        Image.fromarray(
            (np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                out_handle + ".png")
    elif mode == "image_ir":
        ir = data[-1]
        Image.fromarray(
            (np.clip(ir, 0, 1) * 255).astype(np.uint8)).save(
                out_handle + "_ir.png")
    elif mode == "image_as_feat":
        # render each channel of a feature/heat map
        for c in range(data.shape[0]):
            ch = data[c]
            rng_ = ch.max() - ch.min()
            norm = (ch - ch.min()) / (rng_ + 1e-8)
            Image.fromarray((norm * 255).astype(np.uint8)).save(
                f"{out_handle}_c{c}.png")
    elif mode == "mask":
        Image.fromarray(
            (data.astype(np.float32) * 255).astype(np.uint8)).save(
                out_handle + ".png")
    elif mode in ("label", "preds"):
        lab = data if data.ndim == 2 else data[0]
        k = int(lab.max()) + 1 if lab.size else 1
        cmap = colour_map if colour_map is not None else _palette(max(k, 1))
        rgb = np.zeros(lab.shape + (3,), np.uint8)
        for c in range(len(cmap)):
            rgb[lab == c] = cmap[c]
        rgb[lab < 0] = 0
        Image.fromarray(rgb).save(out_handle + ".png")
    elif mode == "matrix":
        with open(out_handle + ".txt", "w") as f:
            f.write(str(data))
    else:
        raise ValueError(mode)


def _anchor_points(num_classes):
    """(k, 2) class anchors on the unit circle: (sin, cos) of 2*pi*c/k
    (reference render.py:158-170 axis convention: row = sin, col = cos)."""
    ang = 2.0 * np.pi * (np.arange(num_classes) / float(num_classes))
    return np.stack([np.sin(ang), np.cos(ang)], axis=1)


def get_coord(probs, num_classes):
    """Convex-combination coordinate of a probability vector over the
    class anchor circle — reference render.py:158-170 verbatim math: the
    probs-weighted (sum-normalised) average of the anchors."""
    probs = np.asarray(probs, np.float64)
    return (probs / probs.sum()) @ _anchor_points(num_classes)


def save_progress(config, apply_fn, mapping_assignment_dataloader,
                  mapping_test_dataloader, index, render_count=50,
                  out_dir=None):
    """MNIST progression point cloud (reference code/utils/cluster/
    render.py:16-156), reference layout: a 148x148 canvas
    (scale 50, border 24) with each test image drawn as a 2x2 point at the
    convex combination of its reordered soft prediction, coloured by its
    GROUND-TRUTH class through GT_TO_ORDER, and the soft-weighted average
    image of every cluster embedded in the border at that cluster's anchor
    direction (16x16, bilinear)."""
    from PIL import Image

    from iic_tpu_torch.evals.cluster_eval import get_assignment_data_matches

    out_dir = out_dir or os.path.join(config.out_root,
                                      str(config.model_ind), "progression")
    os.makedirs(out_dir, exist_ok=True)

    all_matches, train_accs = get_assignment_data_matches(
        config, apply_fn, mapping_assignment_dataloader)
    best_sub_head = int(np.argmax(train_accs))
    match = all_matches[best_sub_head]

    # soft predictions over the test set
    softs, targets, imgs_all = [], [], []
    for batch in mapping_test_dataloader:
        imgs, tgts = batch[0], batch[1]
        outs = _np(apply_fn(imgs))  # (H, bn, k)
        softs.append(outs[best_sub_head])
        targets.append(_np(tgts))
        imgs_all.append(_np(imgs))
    soft_preds = np.concatenate(softs)
    targets = np.concatenate(targets)
    imgs_all = np.concatenate(imgs_all)

    k = config.gt_k
    order_map = (GT_TO_ORDER if k == 10
                 else list(range(k)))  # reference is MNIST-only
    reordered = np.zeros_like(soft_preds)
    for pred_i, target_i in match:
        reordered[:, order_map[target_i]] += soft_preds[:, pred_i]

    # canvas geometry (reference render.py:66-77)
    scale, border, point_half_side = 50, 24, 1
    half_border = int(border * 0.5)
    average_half_side = int(half_border * np.cos(np.radians(45)))
    average_side = average_half_side * 2
    side = 2 * (scale + border)
    canvas = np.full((side, side, 3), 255, np.uint8)
    colours = _palette(k)

    # points: [-1, 1] -> [border, 2*scale + border], 2x2, coloured by the
    # GROUND-TRUTH class (render.py:80-92)
    anchors = _anchor_points(k)
    points = (reordered / reordered.sum(axis=1, keepdims=True)) @ anchors
    coords = (points * scale + scale).astype(np.int32) + border
    for (cy, cx), tgt in zip(coords, targets):
        colour = colours[order_map[int(tgt)]]
        canvas[cy - point_half_side:cy + point_half_side,
               cx - point_half_side:cx + point_half_side] = colour

    # per-cluster soft-weighted average images embedded in the border at
    # each cluster's anchor direction (render.py:95-151)
    hard = reordered.argmax(axis=1)
    weight = reordered[np.arange(len(hard)), hard]
    grey = imgs_all[:, 0] * 255.0  # (N, H, W) in [0, 255]
    for c in range(k):
        sel = hard == c
        norm = weight[sel].sum()
        if norm > np.finfo(np.float64).eps:
            avg = (weight[sel, None, None] * grey[sel]).sum(axis=0) / norm
        else:
            avg = np.zeros(grey.shape[1:])
        tile = Image.fromarray(avg.astype(np.uint8)).resize(
            (average_side, average_side), Image.BILINEAR)
        tile = np.repeat(np.array(tile)[:, :, None], 3, axis=2)
        onehot = np.zeros(k)
        onehot[c] = 1.0
        coord = get_coord(onehot, k)
        coord = (coord * (scale + half_border)
                 + (scale + half_border)).astype(np.int32) + half_border
        canvas[coord[0] - average_half_side:coord[0] + average_half_side,
               coord[1] - average_half_side:coord[1] + average_half_side] \
            = tile

    Image.fromarray(canvas).save(os.path.join(
        out_dir, "%d_run_%d_colour_0_pointcloud_%s.png"
                 % (config.model_ind, render_count, index)))
    return out_dir
