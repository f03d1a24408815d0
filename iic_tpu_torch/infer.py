"""Inference / serving path (``iic_tpu/infer.py``): a trained run directory
becomes a predictor, and the predictor a ``torch.export`` artifact.

- ``load_weights``: the run's config, its best (or latest) weights on the
  device and its stored history, for any run of the port (the analysis
  CLIs read runs through it); ``load_run`` adds the stats of the weights'
  own epoch (best sub-head and its Hungarian match).
- ``make_cluster_predictor`` / ``make_seg_predictor``: ``nn.Module``s that
  take raw uint8 images and return int32 final class ids: tf3 (clustering)
  or the channel preparation (segmentation), sobel, the eval forward of
  the best sub-head, argmax and the stored match, in one forward.
- ``export_predictor`` / ``load_exported``: the predictor through
  ``torch.export`` with a symbolic batch, so that one artifact serves any
  batch size in a process that imports ``torch`` alone.

BatchNorm follows the run: running statistics in eval when it tracked
them, the batch's own statistics otherwise (``batchnorm_track=False``), in
the predictor and in its artifact alike. The artifact holds the graph of
operators, not the process's TF32 settings: served in a process with
PyTorch's defaults (cuDNN TF32 on, cuBLAS TF32 off) it computes what the
eager predictor computes there, the trunk's convolutions in TF32 and the
heads, which are matmuls, in full f32.
"""

import io
import os

import numpy as np
import torch
import torch.nn as nn

from iic_tpu_torch import models
from iic_tpu_torch.data.pipeline import _pair_transforms
from iic_tpu_torch.data.transforms import append_grey, to_grey
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.ops.sobel import sobel_process
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import config_from_dict


def load_weights(out_root, model_ind, name="best", device=None):
    """Reload a trained run's weights: (config, net, meta, name).

    ``net`` holds the ``name`` weights (``best``, or ``latest`` where the
    run has no best; ``name`` is the one read) on ``device`` (cuda:0
    unless given), in eval mode. ``meta`` is the run's config.pickle
    (``history``, ``last_epoch``). ``config.out_root`` is ``out_root``,
    where the caller found the run, not where it was trained."""
    device = resolve_device(device)
    meta = ckpt.read_meta(out_root, model_ind)
    config = config_from_dict(meta["config"])
    config.out_root = out_root
    net = models.build(config.arch, config)
    name = ckpt.load_run_net(out_root, model_ind, net, device, name=name)
    return config, net.to(device).eval(), meta, name


def load_run(out_root, model_ind, name="best", device=None):
    """Reload a trained run: (config, net, stats), as ``load_weights``.
    ``stats`` are the eval stats of the weights' own epoch: the best
    epoch's for ``best``, epoch ``last_epoch`` for ``latest``, since
    cluster identities drift between epochs. Raises on a run with no eval
    history."""
    config, net, meta, name = load_weights(out_root, model_ind, name,
                                           device)
    history = meta["history"]
    ev = history.get("eval") if isinstance(history, dict) else None
    if ev is None or not list(ev.epoch_acc):
        raise ValueError(f"run {os.path.join(out_root, str(model_ind))} "
                         "has no eval history")
    if name == "latest":
        stats = ev.epoch_stats[min(int(meta["last_epoch"]),
                                   len(ev.epoch_stats) - 1)]
    else:
        stats = ev.epoch_stats[int(np.argmax(ev.epoch_acc))]
    return config, net, stats


def _match_table(match, output_k, device="cpu"):
    """(pred, target) pairs -> a dense int32 lookup vector."""
    table = np.zeros(output_k, np.int32)
    for pred, target in match:
        table[pred] = target
    return torch.from_numpy(table).to(device)


class _Predictor(nn.Module):
    """The shared tail: the best sub-head's argmax through the match
    table. The net is put in eval mode and its parameters stop requiring
    gradients."""

    def __init__(self, config, net, stats):
        super().__init__()
        self.net = net
        self.sub_head = int(stats["best_train_sub_head"])
        self.head_kw = {"head": "B"} if config.twohead else {}
        device = next(net.parameters()).device
        self.register_buffer("table", _match_table(
            stats["best_train_sub_head_match"], config.output_k, device))
        self.eval()
        self.requires_grad_(False)

    def _ids(self, x, class_dim):
        out = self.net(x, **self.head_kw)  # (num_sub_heads, b, k, ...)
        return self.table[out[self.sub_head].argmax(dim=class_dim)]


class ClusterPredictor(_Predictor):
    """uint8 (b, H, W, C) raw images -> (b,) int32 final class ids: tf3
    (the deterministic centre crop and resize), sobel channels when the run
    used them, the eval forward of the best sub-head (head B of a two-head
    net), argmax and the match."""

    def __init__(self, config, net, stats):
        super().__init__(config, net, stats)
        _, _, self.tf3 = _pair_transforms(config)
        self.sobel = config.sobel
        self.include_rgb = config.include_rgb

    def forward(self, imgs_u8):
        x = self.tf3(imgs_u8.float() / 255.0).permute(0, 3, 1, 2)
        x = x.contiguous()  # NCHW, as the mapping loaders give it
        if self.sobel:
            x = sobel_process(x, self.include_rgb)
        return self._ids(x, class_dim=-1)


class SegPredictor(_Predictor):
    """uint8 (b, sz, sz, C_raw) prepared images (geometry already at
    input_sz, as the mapping loaders give them; rgb, then IR on Potsdam)
    -> (b, sz, sz) int32 final per-pixel class ids: grey appended under
    sobel (or grey alone without rgb), the IR channel last, sobel, the
    eval forward of the best sub-head, argmax over classes and the
    match."""

    def __init__(self, config, net, stats):
        super().__init__(config, net, stats)
        self.sobel = config.sobel
        self.include_rgb = config.include_rgb
        self.using_IR = config.using_IR

    def forward(self, imgs_u8):
        imgs = imgs_u8.float() / 255.0
        rgb, ir = ((imgs[..., :3], imgs[..., 3:4]) if self.using_IR
                   else (imgs, None))
        if self.sobel:
            out = append_grey(rgb, self.include_rgb)
        elif not self.include_rgb:
            out = to_grey(rgb)
        else:
            out = rgb
        if ir is not None:
            out = torch.cat([out, ir], dim=-1)
        x = out.permute(0, 3, 1, 2).contiguous()
        if self.sobel:
            x = sobel_process(x, self.include_rgb, using_IR=self.using_IR)
        return self._ids(x, class_dim=1)


def make_cluster_predictor(config, net, stats):
    return ClusterPredictor(config, net, stats)


def make_seg_predictor(config, net, stats):
    return SegPredictor(config, net, stats)


def make_predictor(config, net, stats):
    """The predictor of the run's family."""
    if "Segmentation" in config.arch:
        return make_seg_predictor(config, net, stats)
    return make_cluster_predictor(config, net, stats)


def export_predictor(predict, example_u8, path=None, symbolic_batch=True):
    """Serialize a predictor with ``torch.export``; returns the bytes (also
    written to ``path`` when given).

    ``example_u8``: one input batch; its non-batch dims fix the served
    shape, and it is moved to the predictor's device. With
    ``symbolic_batch`` the batch dim is dynamic from 1 up to the largest
    batch the traced kernels take (``range_constraints`` holds it; 65 535
    on an H100), so any batch size is served from the one artifact.
    ``torch.export`` specialises a dim traced at size 0 or 1, so a smaller
    example is tiled to a batch of 2 for the trace; a named
    ``Dim(min=1)`` fails there (torch 2.11: its guards start at 2), and
    ``Dim.DYNAMIC(min=1)`` serves batch 1."""
    device = predict.table.device
    ex = torch.as_tensor(example_u8).to(device)
    dynamic = None
    if symbolic_batch:
        if ex.shape[0] == 0:
            ex = ex.new_zeros((2, *ex.shape[1:]))
        elif ex.shape[0] == 1:
            ex = ex.expand(2, *ex.shape[1:]).contiguous()
        dynamic = ({0: torch.export.Dim.DYNAMIC(min=1)},)
    with torch.no_grad():
        exported = torch.export.export(predict, (ex,),
                                       dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def _traced_device(exported):
    for t in list(exported.state_dict.values()) + list(
            exported.constants.values()):
        if torch.is_tensor(t):
            return t.device
    return None


def _same_device(a, b):
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def load_exported(path_or_bytes, device=None):
    """Load an exported predictor onto ``device`` (cuda:0 unless given);
    returns a callable module. An artifact traced on another device is
    moved there, and this prints so."""
    device = resolve_device(device)
    src = (io.BytesIO(bytes(path_or_bytes))
           if isinstance(path_or_bytes, (bytes, bytearray))
           else path_or_bytes)
    exported = torch.export.load(src)
    traced = _traced_device(exported)
    if traced is not None and not _same_device(traced, device):
        from torch.export.passes import move_to_device_pass
        print(f"load_exported: the artifact was traced on {traced}; "
              f"placing it on {device}")
        exported = move_to_device_pass(exported, device)
    return exported.module()
