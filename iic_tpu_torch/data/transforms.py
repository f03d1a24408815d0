"""Device-side image transforms (``iic_tpu/data/transforms.py``): grey
conversion, colour jitter, crops, resize, flip, and the clustering sobel
path's tf1 / tf2 / tf3.

Images are float32 (B, H, W, C) in [0, 1], the JAX layout, batched. Random
transforms draw per-sample parameters from an explicit ``torch.Generator``
and apply them in a separate, deterministic step, so the tests can feed
both packages the same draws.
"""

import torch
import torch.nn.functional as F

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


# --------------------------------------------------- crops, resize, flip

def center_crop(img, crop_sz):
    """torchvision CenterCrop: the offset rounds half UP (py2
    ``round(3.5) = 4``), so an odd size difference shifts by +1."""
    h, w = img.shape[-3:-1]
    top = (h - crop_sz + 1) // 2
    left = (w - crop_sz + 1) // 2
    return img[..., top:top + crop_sz, left:left + crop_sz, :]


def draw_crop(b, h, w, crop_sz, generator, device):
    """torchvision RandomCrop's draw: top-left corners (B,), uniform over
    the valid positions."""
    top = torch.randint(0, h - crop_sz + 1, (b,), generator=generator,
                        device=device)
    left = torch.randint(0, w - crop_sz + 1, (b,), generator=generator,
                         device=device)
    return top, left


def crop_at(img, top, left, crop_sz):
    """Per-sample crops of (B, H, W, C) at corners top, left (B,)."""
    ar = torch.arange(crop_sz, device=img.device)
    rows = (top[:, None] + ar)[:, :, None]
    cols = (left[:, None] + ar)[:, None, :]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[b, rows, cols]


def random_crop(img, crop_sz, generator):
    top, left = draw_crop(img.shape[0], img.shape[1], img.shape[2], crop_sz,
                          generator, img.device)
    return crop_at(img, top, left, crop_sz)


def resize(img, out_sz):
    """Bilinear with half-pixel centres, antialiased on downscale (PIL, and
    ``jax.image.resize(method="bilinear")``)."""
    x = img.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out_sz, out_sz), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).contiguous()


def flip_where(img, flip):
    """Horizontal flip of the samples where ``flip`` (B,) is true."""
    return torch.where(flip[:, None, None, None], img.flip(2), img)


def per_img_demean(img):
    """Subtract each image's per-channel spatial mean."""
    return img - img.mean(dim=(1, 2), keepdim=True)


# ------------------------------------------------------- composed pipelines

def make_sobel_pair_transforms(config):
    """tf1 / tf2 / tf3 of the colour (sobel) clustering path, batched. The
    sobel filtering itself happens later, in the training step.

    Each maps (B, H, W, 3) float32 in [0, 1] -> (B, input_sz, input_sz, C')
    with C' = 4 if include_rgb else 1:

      tf1(img, generator): random crop -> resize; tf2(img, generator):
        random crop -> resize -> random flip -> colour jitter; tf3(img):
        centre crop -> resize. Each ends in ``append_grey`` (and the
        optional demeaning). Without ``crop_orig``, tf1 and tf3 do not crop
        or resize.

    ``tf2.draw(b, h, w, generator, device)`` returns the per-sample draws
    and ``tf2.apply(img, draws)`` applies them. The flags the path does not
    take raise ``NotImplementedError``.
    """
    for flag in ("fluid_warp", "cutout", "use_random_affine", "rot_val",
                 "rand_crop_szs_tf"):
        if getattr(config, flag, None):  # each is off when falsy
            raise NotImplementedError(f"--{flag} is not ported")
    include_rgb = config.include_rgb
    crop_orig = getattr(config, "crop_orig", True)
    crop_sz = config.rand_crop_sz
    input_sz = config.input_sz
    demean = getattr(config, "demean", False)
    data_mean = tuple(getattr(config, "data_mean", ()) or ())
    data_std = tuple(getattr(config, "data_std", ()) or ())
    do_per_img_demean = getattr(config, "per_img_demean", False)

    def finish(img):
        out = append_grey(img, include_rgb)
        if demean and data_mean:
            mean = torch.tensor(data_mean, dtype=out.dtype, device=out.device)
            std = torch.tensor(data_std, dtype=out.dtype, device=out.device)
            out = (out - mean) / std
        if do_per_img_demean:
            out = per_img_demean(out)
        return out

    def tf1(img, generator):
        if crop_orig:
            img = resize(random_crop(img, crop_sz, generator), input_sz)
        return finish(img)

    def draw_tf2(b, h, w, generator, device):
        top, left = draw_crop(b, h, w, crop_sz, generator, device)
        flip_u = torch.rand((b,), generator=generator, device=device)
        # the reference's ColorJitter(0.4, 0.4, 0.4, 0.125): the defaults
        factors, order = draw_jitter(b, generator, device)
        # RandomHorizontalFlip, p = 0.5
        return dict(top=top, left=left, flip=flip_u < 0.5,
                    jitter_factors=factors, jitter_order=order)

    def apply_tf2(img, draws):
        img = resize(crop_at(img, draws["top"], draws["left"], crop_sz),
                     input_sz)
        img = flip_where(img, draws["flip"])
        img = color_jitter_with(img, draws["jitter_factors"],
                                draws["jitter_order"])
        return finish(img)

    def tf2(img, generator):
        return apply_tf2(img, draw_tf2(*img.shape[:3], generator, img.device))

    def tf3(img):
        if crop_orig:
            img = resize(center_crop(img, crop_sz), input_sz)
        return finish(img)

    tf2.draw, tf2.apply = draw_tf2, apply_tf2
    return tf1, tf2, tf3
