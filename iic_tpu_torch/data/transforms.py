"""Device-side image transforms (``iic_tpu/data/transforms.py``): grey
conversion, colour jitter, crops, resize, flip, rotation, the random
affine and the cutout, and the clustering paths' tf1 / tf2 / tf3: the
sobel (colour) path's and the greyscale (MNIST) path's.

Images are float32 (B, H, W, C) in [0, 1], the JAX layout, batched. Random
transforms draw per-sample parameters from an explicit ``torch.Generator``
and apply them in a separate, deterministic step, so the tests can feed
both packages the same draws.
"""

import math

import torch
import torch.nn.functional as F

from iic_tpu_torch.ops.affine import affine_grid, grid_sample

# PIL ``to_grayscale`` / cv2 COLOR_RGB2GRAY weights.
_GREY_W = (0.299, 0.587, 0.114)


def to_grey(img):
    """(..., 3) -> (..., 1) luma: r w_r, then + g w_g and + b w_b as fused
    multiply-adds, the order and roundings XLA compiles the JAX package's
    weighted sum into, so that a grey image equals its bit for bit. The
    channel axis is added last, with stride 1, whatever the input's layout
    (the hue adjustment returns channel planes): an NCHW view of a grey
    batch is then channels-last, as the trainers' first image of a pair is,
    and both images of a pair reach the net in one memory format."""
    w = torch.tensor(_GREY_W, dtype=img.dtype, device=img.device)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return torch.addcmul(torch.addcmul(r * w[0], g, w[1]), b,
                         w[2]).unsqueeze(-1)


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
    the valid positions (``draw_crop_mode``'s "random" at one size)."""
    return draw_crop_mode(b, h, w, torch.full((b,), crop_sz, device=device),
                          "random", generator, device)


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


def draw_rotation(b, max_deg, generator, device, p=0.5, always=False):
    """torchvision RandomApply([RandomRotation(max_deg)], p)'s draws: angles
    (B,) uniform in [-max_deg, max_deg] degrees, and whether each sample
    rotates (all of them when ``always``)."""
    angle = (torch.rand((b,), generator=generator, device=device)
             * (2.0 * max_deg) - max_deg)
    do = torch.rand((b,), generator=generator, device=device) < p
    return angle, (torch.ones_like(do) if always else do)


def rotate_where(img, angle, do):
    """Rotate each sample of (B, H, W, C) about its centre by ``angle`` (B,)
    degrees where ``do`` (B,) is true: bilinear, zero fill, through the
    exact ``affine_grid`` / ``grid_sample`` (align_corners=True), the op
    the JAX ``random_rotation`` runs."""
    a = angle.float() * (math.pi / 180.0)
    cos, sin, zero = torch.cos(a), torch.sin(a), torch.zeros_like(a)
    theta = torch.stack([torch.stack([cos, -sin, zero], dim=-1),
                         torch.stack([sin, cos, zero], dim=-1)], dim=1)
    data = img.permute(0, 3, 1, 2)
    rotated = grid_sample(data, affine_grid(theta, data.shape))
    return torch.where(do[:, None, None, None], rotated.permute(0, 2, 3, 1),
                       img)


def random_rotation(img, generator, max_deg, p=0.5, always=False):
    """RandomApply([RandomRotation(max_deg)], p) (always under
    ``always``): ``draw_rotation``, then ``rotate_where``. The JAX
    function's counterpart, for callers and tests: the pipeline's tf2
    draws and applies in two steps (``tf2.draw`` / ``tf2.apply``)."""
    angle, do = draw_rotation(img.shape[0], max_deg, generator, img.device,
                              p, always)
    return rotate_where(img, angle, do)


def draw_affine(b, generator, device, max_rot=18.0, scale_min=0.9,
                scale_max=1.1, max_shear=10.0, max_translate=0.1, p=0.5):
    """torchvision RandomApply([RandomAffine(18, translate=(.1, .1),
    scale=(.9, 1.1), shear=10)], p)'s draws for a batch, each (B,): the
    rotation and the shear in degrees, the scale, the translations in
    grid units (twice the fraction of the side) and whether each sample
    warps."""
    def uniform(lo, hi):
        return lo + torch.rand((b,), generator=generator,
                               device=device) * (hi - lo)

    return dict(affine_angle=uniform(-max_rot, max_rot),
                affine_shear=uniform(-max_shear, max_shear),
                affine_scale=uniform(scale_min, scale_max),
                affine_tx=uniform(-max_translate, max_translate) * 2.0,
                affine_ty=uniform(-max_translate, max_translate) * 2.0,
                affine=torch.rand((b,), generator=generator,
                                  device=device) < p)


def affine_where(img, draws):
    """Warp each sample of (B, H, W, C) by the affine map of its
    ``draw_affine`` draws (rotate by the angle, shear, magnify by the
    scale, translate) where ``draws["affine"]`` is true: bilinear, zero
    fill, through the exact ``affine_grid`` / ``grid_sample``.
    ``grid_sample``'s theta maps output to input coordinates, so it gets
    the forward map's inverse (torchvision's
    ``_get_inverse_affine_matrix`` does the same): with the forward map a
    scale above 1 would shrink the content instead of magnifying it."""
    a = draws["affine_angle"].float() * (math.pi / 180.0)
    a_sh = a + draws["affine_shear"].float() * (math.pi / 180.0)
    s = draws["affine_scale"].float()
    tx, ty = draws["affine_tx"].float(), draws["affine_ty"].float()
    m00, m01 = torch.cos(a) * s, -torch.sin(a_sh) * s
    m10, m11 = torch.sin(a) * s, torch.cos(a_sh) * s
    det = m00 * m11 - m01 * m10
    i00, i01, i10, i11 = m11 / det, -m01 / det, -m10 / det, m00 / det
    theta = torch.stack([
        torch.stack([i00, i01, -(i00 * tx + i01 * ty)], dim=-1),
        torch.stack([i10, i11, -(i10 * tx + i11 * ty)], dim=-1)], dim=1)
    data = img.permute(0, 3, 1, 2)
    warped = grid_sample(data, affine_grid(theta, data.shape))
    return torch.where(draws["affine"][:, None, None, None],
                       warped.permute(0, 2, 3, 1), img)


def draw_cutout(b, h, w, min_box, max_box, generator, device, p=1.0):
    """The reference's ``custom_cutout`` draws for a batch, each (B,): the
    box side, uniform in [min_box, max_box]; its centre, uniform over the
    positions that keep the box inside the image, drawn as the JAX
    function draws it (half + floor(U[0, 1) * (side - 2 * half))), not as
    ``randint``; and whether each sample is cut (rate ``p``)."""
    box = min_box + _uniform_index(
        torch.full((b,), max_box - min_box + 1, device=device), generator,
        device)
    half = box // 2

    def centre(side):
        n = (side - 2 * half).clamp_min(1)
        u = torch.rand((b,), generator=generator, device=device)
        return half + torch.minimum((u * n).long(), n - 1)

    x_c = centre(w)
    y_c = centre(h)
    return dict(cut_box=box, cut_x=x_c, cut_y=y_c,
                cutout=torch.rand((b,), generator=generator,
                                  device=device) < p)


def cutout_where(img, draws):
    """Zero each sample's box (side ``cut_box``, centre ``cut_x``,
    ``cut_y``: the columns and rows from centre - side // 2 up to, not
    including, centre + side // 2) where ``draws["cutout"]`` is true."""
    h, w = img.shape[1:3]
    half = (draws["cut_box"] // 2)[:, None]
    x_c, y_c = draws["cut_x"][:, None], draws["cut_y"][:, None]
    xs = torch.arange(w, device=img.device)[None]
    ys = torch.arange(h, device=img.device)[None]
    cols = (xs >= x_c - half) & (xs < x_c + half)  # (B, W)
    rows = (ys >= y_c - half) & (ys < y_c + half)  # (B, H)
    rows = rows & draws["cutout"][:, None]
    return img.masked_fill((rows[:, :, None] & cols[:, None, :])[..., None],
                           0.0)


def _uniform_index(n, generator, device):
    """Integers uniform in [0, n) for a (B,) tensor of bounds ``n``."""
    u = torch.rand(n.shape, generator=generator, device=device)
    return torch.minimum((u * n).long(), n - 1)


def draw_crop_mode(b, h, w, sz, mode, generator, device):
    """Corners (top, left) (B,) of a ``mode`` crop of sizes ``sz`` (B,):
    "random" uniform over the valid positions (torchvision RandomCrop),
    "centre" the centre crop's (CenterCrop), "centre_half" either, 50/50."""
    centre = ((h - sz + 1) // 2, (w - sz + 1) // 2)
    if mode == "centre":
        return centre
    top = _uniform_index(h - sz + 1, generator, device)
    left = _uniform_index(w - sz + 1, generator, device)
    if mode == "random":
        return top, left
    if mode != "centre_half":
        raise ValueError(f"crop mode {mode!r}")
    coin = torch.rand((b,), generator=generator, device=device) < 0.5
    return (torch.where(coin, top, centre[0]),
            torch.where(coin, left, centre[1]))


def crop_half_or_centre(img, crop_sz, generator):
    """The "centre_half" crop: RandomCrop or CenterCrop, 50/50. The JAX
    function's counterpart, for callers and tests: tf1 draws and applies in
    two steps."""
    b, h, w = img.shape[:3]
    sz = torch.full((b,), crop_sz, device=img.device)
    top, left = draw_crop_mode(b, h, w, sz, "centre_half", generator,
                               img.device)
    return crop_at(img, top, left, crop_sz)


def draw_choice_crop(b, h, w, crop_szs, mode, generator, device):
    """torchvision RandomChoice over ``mode`` crops of the sizes
    ``crop_szs``: each sample's choice (B,) (an index into ``crop_szs``) and
    its corner (top, left)."""
    choice = torch.randint(0, len(crop_szs), (b,), generator=generator,
                           device=device)
    sz = torch.tensor(crop_szs, device=device)[choice]
    top, left = draw_crop_mode(b, h, w, sz, mode, generator, device)
    return choice, top, left


def choice_crop_resize_at(img, crop_szs, choice, top, left, out_sz):
    """Crop each sample at its corner to its chosen size, then resize to
    ``out_sz``. The samples are grouped by size: one crop and one resize a
    size, none for a size no sample chose."""
    b, _, _, c = img.shape
    out = img.new_empty((b, out_sz, out_sz, c))
    order = torch.argsort(choice, stable=True)
    counts = torch.bincount(choice, minlength=len(crop_szs)).tolist()
    for sz, idx in zip(crop_szs, torch.split(order, counts)):
        if len(idx):
            out[idx] = resize(crop_at(img[idx], top[idx], left[idx], sz),
                              out_sz)
    return out


def random_choice_crop_resize(img, crop_szs, out_sz, generator,
                              crop_mode="random"):
    """RandomChoice over RandomCrop(sz) for sz in ``crop_szs`` (or centre
    crops, or centre_half), then Resize(out_sz): the greyscale tf2's. The
    JAX function's counterpart, for callers and tests: tf2 draws and
    applies in two steps."""
    draws = draw_choice_crop(*img.shape[:3], tuple(crop_szs), crop_mode,
                             generator, img.device)
    return choice_crop_resize_at(img, tuple(crop_szs), *draws, out_sz)


def per_img_demean(img):
    """Subtract each image's per-channel spatial mean."""
    return img - img.mean(dim=(1, 2), keepdim=True)


# ------------------------------------------------------- composed pipelines

def make_sobel_pair_transforms(config):
    """tf1 / tf2 / tf3 of the colour (sobel) clustering path, batched. The
    sobel filtering itself happens later, in the training step.

    Each maps (B, H, W, 3) float32 in [0, 1] -> (B, input_sz, input_sz, C')
    with C' = 4 if include_rgb else 1:

      tf1(img, generator): random crop -> resize; tf2(img, generator): a
        random crop of rand_crop_sz, the random affine under
        ``use_random_affine`` (rate ``affine_p``), the cutout under
        ``cutout`` (rate ``cutout_p``, box side in [int(0.2 *
        rand_crop_sz), int(cutout_max_box * rand_crop_sz)]), the resize,
        a random flip, colour jitter. Under ``fluid_warp`` a rotation by
        U(-rot_val, rot_val) degrees (rate 0.5; none when rot_val is 0)
        and a random crop of a size drawn from ``rand_crop_szs_tf`` (or
        rand_crop_sz), resized, take the place of the crop and the resize;
        cutout with fluid_warp raises, as in the reference. tf3(img):
        centre crop -> resize. Each ends in ``append_grey`` (and the
        optional demeaning). Without ``crop_orig``, tf1 and tf3 do not crop
        or resize.

    ``tf2.draw(b, h, w, generator, device)`` returns the per-sample draws
    and ``tf2.apply(img, draws)`` applies them.
    """
    include_rgb = config.include_rgb
    crop_orig = getattr(config, "crop_orig", True)
    crop_sz = config.rand_crop_sz
    input_sz = config.input_sz
    fluid_warp = getattr(config, "fluid_warp", False)
    rot_val = getattr(config, "rot_val", 0.0)
    crop_szs_tf = tuple(getattr(config, "rand_crop_szs_tf", ()) or ()) \
        or (crop_sz,)
    cutout = getattr(config, "cutout", False)
    if cutout and fluid_warp:
        # the reference refuses it: its boxes are sized against the crop,
        # which fluid_warp replaces
        raise ValueError("--cutout with --fluid_warp is not supported")
    cutout_p = getattr(config, "cutout_p", 0.5)
    cut_min = int(crop_sz * 0.2)
    cut_max = int(crop_sz * getattr(config, "cutout_max_box", 0.7))
    use_random_affine = getattr(config, "use_random_affine", False)
    affine_p = getattr(config, "affine_p", 0.5)
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
        draws = {}
        if fluid_warp:
            if rot_val > 0:
                draws["angle"], draws["rotate"] = draw_rotation(
                    b, rot_val, generator, device)
            draws["choice"], draws["top"], draws["left"] = draw_choice_crop(
                b, h, w, crop_szs_tf, "random", generator, device)
        else:
            draws["top"], draws["left"] = draw_crop(b, h, w, crop_sz,
                                                    generator, device)
        if use_random_affine:
            draws.update(draw_affine(b, generator, device, p=affine_p))
        if cutout:
            draws.update(draw_cutout(b, crop_sz, crop_sz, cut_min, cut_max,
                                     generator, device, p=cutout_p))
        # RandomHorizontalFlip, p = 0.5
        draws["flip"] = torch.rand((b,), generator=generator,
                                   device=device) < 0.5
        # the reference's ColorJitter(0.4, 0.4, 0.4, 0.125): the defaults
        draws["jitter_factors"], draws["jitter_order"] = draw_jitter(
            b, generator, device)
        return draws

    def apply_tf2(img, draws):
        if fluid_warp:
            if rot_val > 0:
                img = rotate_where(img, draws["angle"], draws["rotate"])
            img = choice_crop_resize_at(img, crop_szs_tf, draws["choice"],
                                        draws["top"], draws["left"],
                                        input_sz)
        else:
            img = crop_at(img, draws["top"], draws["left"], crop_sz)
        if use_random_affine:
            img = affine_where(img, draws)
        if cutout:
            img = cutout_where(img, draws)
        if not fluid_warp:
            img = resize(img, input_sz)
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


def make_greyscale_pair_transforms(config):
    """tf1 / tf2 / tf3 of the greyscale (MNIST) clustering path, batched,
    on (B, H, W, 1) float32 in [0, 1] -> (B, input_sz, input_sz, 1):

      tf1(img, generator): a ``tf1_crop`` crop ("random", "centre" or
        "centre_half") of ``tf1_crop_sz`` under ``crop_orig``, then the
        resize; tf2(img, generator): a rotation by U(-rot_val, rot_val)
        degrees (with p 0.5, or always under ``always_rot``; none when
        rot_val is 0), then a ``tf2_crop`` crop of a size drawn from
        ``tf2_crop_szs`` and the resize under ``crop_other`` (else the
        resize alone), a flip unless ``no_flip``, colour jitter unless
        ``no_jitter`` (brightness and contrast: saturation and hue leave a
        grey image as it is); tf3(img): the centre crop of tf1_crop_sz (or
        ``tf3_crop_sz`` under ``tf3_crop_diff``) under ``crop_orig``, then
        the resize. Each ends in the optional demeaning.

    ``tf1.draw(b, h, w, generator, device)`` / ``tf1.apply(img, draws)``
    and the same for tf2 split each into its per-sample draws and their
    deterministic application.
    """
    crop_orig = config.crop_orig
    crop_other = config.crop_other
    tf1_crop = config.tf1_crop
    tf1_crop_sz = config.tf1_crop_sz
    tf2_crop = config.tf2_crop
    tf2_crop_szs = tuple(config.tf2_crop_szs)
    tf3_sz = config.tf3_crop_sz if config.tf3_crop_diff else tf1_crop_sz
    input_sz = config.input_sz
    rot_val = config.rot_val
    always_rot = config.always_rot
    no_flip = config.no_flip
    no_jitter = config.no_jitter
    demean = config.demean
    data_mean = tuple(config.data_mean or ())
    data_std = tuple(config.data_std or ())
    do_per_img_demean = config.per_img_demean

    def finish(img):
        if demean and data_mean:
            mean = torch.tensor(data_mean, dtype=img.dtype, device=img.device)
            std = torch.tensor(data_std, dtype=img.dtype, device=img.device)
            img = (img - mean) / std
        if do_per_img_demean:
            img = per_img_demean(img)
        return img

    def draw_tf1(b, h, w, generator, device):
        if not crop_orig:
            return {}
        sz = torch.full((b,), tf1_crop_sz, device=device)
        top, left = draw_crop_mode(b, h, w, sz, tf1_crop, generator, device)
        return dict(top=top, left=left)

    def apply_tf1(img, draws):
        if crop_orig:
            img = crop_at(img, draws["top"], draws["left"], tf1_crop_sz)
        return finish(resize(img, input_sz))

    def tf1(img, generator):
        return apply_tf1(img, draw_tf1(*img.shape[:3], generator, img.device))

    def draw_tf2(b, h, w, generator, device):
        draws = {}
        if rot_val > 0:
            draws["angle"], draws["rotate"] = draw_rotation(
                b, rot_val, generator, device, always=always_rot)
        if crop_other:
            draws["choice"], draws["top"], draws["left"] = draw_choice_crop(
                b, h, w, tf2_crop_szs, tf2_crop, generator, device)
        if not no_flip:  # RandomHorizontalFlip, p = 0.5
            draws["flip"] = torch.rand((b,), generator=generator,
                                       device=device) < 0.5
        if not no_jitter:
            draws["jitter_factors"], draws["jitter_order"] = draw_jitter(
                b, generator, device)
        return draws

    def apply_tf2(img, draws):
        if rot_val > 0:
            img = rotate_where(img, draws["angle"], draws["rotate"])
        if crop_other:
            img = choice_crop_resize_at(img, tf2_crop_szs, draws["choice"],
                                        draws["top"], draws["left"],
                                        input_sz)
        else:
            img = resize(img, input_sz)
        if not no_flip:
            img = flip_where(img, draws["flip"])
        if not no_jitter:
            img = color_jitter_with(img, draws["jitter_factors"],
                                    draws["jitter_order"])
        return finish(img)

    def tf2(img, generator):
        return apply_tf2(img, draw_tf2(*img.shape[:3], generator, img.device))

    def tf3(img):
        if crop_orig:
            img = center_crop(img, tf3_sz)
        return finish(resize(img, input_sz))

    tf1.draw, tf1.apply = draw_tf1, apply_tf1
    tf2.draw, tf2.apply = draw_tf2, apply_tf2
    return tf1, tf2, tf3
