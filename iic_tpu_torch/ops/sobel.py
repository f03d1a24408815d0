"""Sobel edge filtering on the device (``iic_tpu/ops/sobel.py``).

The grey channel is convolved with fixed 3x3 Sobel dx/dy kernels (padding 1)
and the two resulting channels replace it, with the RGB / IR channels put
back in the reference's channel order.
"""

import torch
import torch.nn.functional as F

# dx and dy kernels as (O=2, I=1, 3, 3)
_SOBEL_KERNEL = torch.tensor(
    [[[[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]]],
     [[[1.0, 2.0, 1.0], [0.0, 0.0, 0.0], [-1.0, -2.0, -1.0]]]])


def sobel_filter(grey_imgs):
    """(N, 1, H, W) grey images -> (N, 2, H, W) [dx, dy]."""
    x = grey_imgs.float()
    return F.conv2d(x, _SOBEL_KERNEL.to(x.device), padding=1)


def sobel_process(imgs, include_rgb, using_IR=False):
    """Channel layouts of the reference ``sobel_process``:

      no IR, no rgb:  in (N,1) grey            -> out (N,2) [dx,dy]
      no IR, rgb:     in (N,4) [r,g,b,grey]    -> out (N,5) [r,g,b,dx,dy]
      IR, no rgb:     in (N,2) [grey,ir]       -> out (N,3) [dx,dy,ir]
      IR, rgb:        in (N,5) [r,g,b,grey,ir] -> out (N,6) [r,g,b,dx,dy,ir]
    """
    c = imgs.shape[1]
    expected = {(False, False): 1, (False, True): 4, (True, False): 2,
                (True, True): 5}[(bool(using_IR), bool(include_rgb))]
    if c != expected:
        raise ValueError(f"sobel_process: expected {expected} channels, "
                         f"got {c}")
    grey_at = 0 if (using_IR and not include_rgb) else c - 1 - int(using_IR)
    pre = imgs[:, :3] if include_rgb else None
    post = imgs[:, c - 1:] if using_IR else None
    sobel = sobel_filter(imgs[:, grey_at:grey_at + 1])
    parts = [p for p in (pre, sobel, post) if p is not None]
    return torch.cat(parts, dim=1) if len(parts) > 1 else sobel
