"""Device-side image transforms for the segmentation pipeline
(``iic_tpu/data/transforms.py``: grey conversion and colour jitter).

Images are float32 (B, H, W, C) in [0, 1], the JAX layout, batched. The
adjust functions take their factors as per-sample tensors (B,), so the
tests can feed both packages the same draws; ``color_jitter`` draws them
from an explicit ``torch.Generator``.
"""

import torch

# PIL ``to_grayscale`` / cv2 COLOR_RGB2GRAY weights.
_GREY_W = (0.299, 0.587, 0.114)


def to_grey(img):
    """(..., 3) -> (..., 1) luma."""
    w = torch.tensor(_GREY_W, dtype=img.dtype, device=img.device)
    return (img * w).sum(dim=-1, keepdim=True)


def append_grey(img, include_rgb):
    """Grey only, or rgb with grey appended last."""
    grey = to_grey(img)
    return torch.cat([img, grey], dim=-1) if include_rgb else grey


def _per_sample(f, img):
    return f.reshape(-1, *([1] * (img.ndim - 1))).to(img.dtype)


def adjust_brightness(img, f):
    return (img * _per_sample(f, img)).clamp(0.0, 1.0)


def adjust_contrast(img, f):
    """Blend with the per-image mean of the grey image."""
    src = to_grey(img) if img.shape[-1] == 3 else img
    mean = src.mean(dim=tuple(range(1, img.ndim)), keepdim=True)
    return ((img - mean) * _per_sample(f, img) + mean).clamp(0.0, 1.0)


def adjust_saturation(img, f):
    if img.shape[-1] != 3:
        return img
    grey = to_grey(img)
    return (grey + (img - grey) * _per_sample(f, img)).clamp(0.0, 1.0)


def adjust_hue(img, d):
    """Shift hue by d (turns, in [-0.5, 0.5]) through RGB <-> HSV."""
    if img.shape[-1] != 3:
        return img
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    s = torch.where(maxc > 0, c / maxc.clamp_min(1e-12),
                    torch.zeros_like(maxc))
    safe_c = c.clamp_min(1e-12)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(c > 0, h, torch.zeros_like(h))
    h = torch.remainder(h + _per_sample(d, h), 1.0)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)
    table = torch.stack([
        torch.stack([v, q, p, p, t, v]),
        torch.stack([t, v, v, q, p, p]),
        torch.stack([p, p, t, v, v, q])])  # (3 out, 6 sectors, ...)
    idx = i.unsqueeze(0).unsqueeze(0).expand(3, 1, *i.shape)
    return torch.gather(table, 1, idx)[:, 0].movedim(0, -1)


_ADJUST = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter_with(img, factors, order):
    """Apply the four adjustments with given per-sample factors (B, 4) =
    (brightness, contrast, saturation, hue shift) in per-sample order
    (B, 4), a permutation of 0..3 each."""
    out = img
    for step in range(4):
        stage = out
        for op in range(4):
            sel = (order[:, step] == op).reshape(-1, *([1] * (img.ndim - 1)))
            stage = torch.where(sel, _ADJUST[op](out, factors[:, op]), stage)
        out = stage
    return out


def draw_jitter(b, generator, device, brightness=0.4, contrast=0.4,
                saturation=0.4, hue=0.125):
    """torchvision ColorJitter's draws for a batch: factors (B, 4) uniform
    in their ranges and a random order (B, 4) of the four adjustments."""
    lo = torch.tensor([max(0.0, 1 - brightness), max(0.0, 1 - contrast),
                       max(0.0, 1 - saturation), -hue])
    hi = torch.tensor([1 + brightness, 1 + contrast, 1 + saturation, hue])
    u = torch.rand((b, 4), generator=generator, device=device)
    factors = lo.to(device) + u * (hi - lo).to(device)
    order = torch.argsort(
        torch.rand((b, 4), generator=generator, device=device), dim=1)
    return factors, order


def color_jitter(img, generator, brightness=0.4, contrast=0.4,
                 saturation=0.4, hue=0.125):
    factors, order = draw_jitter(img.shape[0], generator, img.device,
                                 brightness, contrast, saturation, hue)
    return color_jitter_with(img, factors, order)
