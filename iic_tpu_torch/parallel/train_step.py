"""Segmentation training step and eval forward on one GPU
(``iic_tpu/parallel/train_step.py``: ``make_seg_train_step``,
``make_seg_apply_fn``).

The network and its optimiser are updated in place. One step: optional
device augmentation -> sobel -> two forwards (BN running stats update
twice, as in the JAX step) -> the loss per sub-head, averaged -> backward
-> Adam. Only the trained head receives gradients; the other head's
parameters get zero gradients, as ``jax.grad`` gives them, so Adam decays
their moments and counts the step exactly as optax does.
"""

import torch

from iic_tpu_torch.ops.iid_seg_loss import (
    IID_segmentation_loss, IID_segmentation_loss_uncollapsed)
from iic_tpu_torch.ops.sobel import sobel_process


def make_optimizer(net, config):
    """``optax.inject_hyperparams(optax.adam)(learning_rate=lr)``: the same
    betas (0.9, 0.999) and eps (1e-8)."""
    if config.opt != "Adam":
        raise NotImplementedError(f"optimiser {config.opt!r}: the reference "
                                  "supports Adam only")
    return torch.optim.Adam(net.parameters(), lr=config.lr)


def set_lr_mult(optimizer, lr_mult):
    """Multiply the learning rate in place, keeping Adam's moments."""
    for group in optimizer.param_groups:
        group["lr"] *= lr_mult


def make_seg_train_step(net, optimizer, lamb, head, half_T_side_dense,
                        half_T_side_sparse_min, half_T_side_sparse_max,
                        sobel=False, include_rgb=False, using_IR=False,
                        use_uncollapsed_loss=False, augment=None,
                        joint_impl="pallas"):
    """Returns ``step(batch, generator=None) -> (loss, loss_no_lamb)``
    (detached 0-d tensors).

    Without ``augment``: batch = (img1, img2, affine2_to_1, mask).
    With ``augment``: batch = (imgs_u8, masks_u8) and the paired
    augmentation draws from ``generator``.
    """
    if use_uncollapsed_loss:
        def loss_impl(*a, **kw):
            return IID_segmentation_loss_uncollapsed(
                *a, joint_impl=joint_impl, **kw)
    else:
        loss_impl = IID_segmentation_loss
    head_kw = {} if head is None else {"head": head}
    params = list(net.parameters())

    def step(batch, generator=None):
        if augment is not None:
            imgs_u8, masks_u8 = batch
            img1, img2, affine2_to_1, mask = augment(imgs_u8, masks_u8,
                                                     generator)
        else:
            img1, img2, affine2_to_1, mask = batch
        if sobel:
            img1 = sobel_process(img1, include_rgb, using_IR=using_IR)
            img2 = sobel_process(img2, include_rgb, using_IR=using_IR)

        net.train()
        out1 = net(img1, **head_kw)  # (num_sub_heads, b, k, h, w)
        out2 = net(img2, **head_kw)
        pairs = [loss_impl(out1[s], out2[s], affine2_to_1, mask, lamb=lamb,
                           half_T_side_dense=half_T_side_dense,
                           half_T_side_sparse_min=half_T_side_sparse_min,
                           half_T_side_sparse_max=half_T_side_sparse_max,
                           generator=generator)
                 for s in range(out1.shape[0])]
        loss = torch.stack([p[0] for p in pairs]).mean()
        loss_nl = torch.stack([p[1] for p in pairs]).mean()

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach(), loss_nl.detach()

    return step


def make_seg_apply_fn(net, head=None, sobel=False, include_rgb=False,
                      using_IR=False):
    """Eval forward: ``apply(imgs) -> (num_sub_heads, b, k, h, w)`` with BN
    in eval mode (batch statistics when it tracks none), no gradients."""
    head_kw = {} if head is None else {"head": head}

    @torch.no_grad()
    def apply(imgs):
        if sobel:
            imgs = sobel_process(imgs, include_rgb, using_IR=using_IR)
        was_training = net.training
        net.eval()
        try:
            return net(imgs, **head_kw)
        finally:
            net.train(was_training)

    return apply
