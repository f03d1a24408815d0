"""Training steps and eval forwards (``iic_tpu/parallel/train_step.py``:
``make_cluster_train_step``, ``make_seg_train_step``,
``make_semisup_train_step``, ``make_apply_fn``, whose ``using_IR`` covers
``make_seg_apply_fn``).

The network and its optimiser are updated in place. One step: optional
device augmentation -> sobel -> two forwards (BN running stats update
twice, as in the JAX step) -> the loss per sub-head, averaged -> backward
-> Adam. Only the trained head receives gradients; the other head's
parameters get zero gradients, as ``jax.grad`` gives them, so Adam decays
their moments and counts the step exactly as optax does.

Under a ``mesh`` (``parallel/mesh.py``) each rank steps on its shard of
the batch, with the JAX step's two modes: ``joint_mode="global"`` sums the
unnormalised joint over ranks before the log terms (the global-batch MI
estimator) and sums the gradients, each rank's being its share of the one
global loss's; ``"parity"`` keeps each rank's joint and averages the
losses and the gradients. The gradients go over in one flattened
all-reduce after the backward, and BatchNorm's running statistics are
averaged over ranks after the step. The JAX package's global-mode
gradients are the world size times these: its psum transposes to a psum
of a cotangent every shard already holds. Adam is blind to that factor
but for its eps.

The net runs in its own compute dtype (``model_dtype``; see
``models.layers``): its heads return f32, so the loss, the gradients that
reach the f32 parameters and the Adam update stay f32 in either dtype.
"""

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from iic_tpu_torch.data.semisup import PAD_LABEL
from iic_tpu_torch.ops.iid_loss import IID_loss
from iic_tpu_torch.ops.iid_seg_loss import (
    IID_segmentation_loss, IID_segmentation_loss_uncollapsed)
from iic_tpu_torch.ops.sobel import sobel_process
from iic_tpu_torch.parallel.mesh import (
    all_reduce_joint, average_buffers, global_mean, reduce_gradients)


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


def _optimizer_step(optimizer, params, loss, mesh=None, joint_mode="global",
                    module=None):
    """Backward and Adam, with zero gradients for parameters the loss does
    not reach (the other head), as ``jax.grad`` gives them. Under a mesh
    the gradients are reduced over ranks before Adam (summed in global
    mode, averaged in parity mode) and ``module``'s running statistics
    averaged after it."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    reduce_gradients(params, mesh, joint_mode)
    optimizer.step()
    if module is not None:
        average_buffers(module, mesh)


def _check_mode(mesh, joint_mode):
    if joint_mode not in ("global", "parity"):
        raise ValueError(f"unknown joint_mode {joint_mode!r}")
    return mesh if joint_mode == "global" else None


def make_cluster_train_step(net, optimizer, augment_pair, lamb, head,
                            sobel=False, include_rgb=False, loss_impl="xla",
                            mesh=None, joint_mode="global", weighted=False):
    """Returns ``step(batch, generator=None) -> (loss, loss_no_lamb)``
    (detached 0-d tensors), the hot loop of cluster_sobel_twohead.py.

    With ``augment_pair``: batch = base uint8 (b, H, W, C) and the pair
    augmentation draws from ``generator``. Without (``augment_pair=None``):
    batch = (imgs, imgs_tf), NCHW, already augmented. ``loss_impl="fused"``
    runs every sub-head's loss through K3 in one launch; ``"xla"`` is the
    plain torch loss. K3 computes one rank's joint, so a mesh refuses it,
    as the JAX step does.

    ``weighted``: batch = (base, weights (b,)), and each sample's outer
    product in the joint is weighted (0 masks a padded row out exactly; the
    weights tile over the pair's r repeats as the images do). Global mode
    only: a parity rank whose rows were all padding would normalise a zero
    joint. BatchNorm's batch statistics still see the padded rows, the JAX
    package's documented deviation."""
    if loss_impl == "fused" and mesh is not None:
        raise ValueError("the fused loss computes one rank's joint; use "
                         "loss_impl='xla' with a mesh")
    if weighted and joint_mode != "global":
        raise ValueError("weighted (padded-batch) steps need "
                         "joint_mode='global'")
    joint_mesh = _check_mode(mesh, joint_mode)
    head_kw = {} if head is None else {"head": head}
    params = list(net.parameters())

    def step(batch, generator=None):
        weights = None
        if weighted:
            batch, weights = batch
        if augment_pair is not None:
            imgs, imgs_tf = augment_pair(batch, generator)
        else:
            imgs, imgs_tf = batch
        if sobel:
            imgs = sobel_process(imgs, include_rgb)
            imgs_tf = sobel_process(imgs_tf, include_rgb)

        net.train()
        out = net(imgs, **head_kw)  # (num_sub_heads, bn, k)
        out_tf = net(imgs_tf, **head_kw)
        if weights is not None:
            weights = weights.repeat(out.shape[1] // weights.shape[0])
        losses, losses_nl = IID_loss(out, out_tf, lamb=lamb, impl=loss_impl,
                                     weights=weights, mesh=joint_mesh)
        loss, loss_nl = losses.mean(), losses_nl.mean()
        _optimizer_step(optimizer, params, loss, mesh, joint_mode, net)
        return _logged(loss, loss_nl, mesh, joint_mode)

    return step


def _logged(loss, loss_nl, mesh, joint_mode):
    """The step's detached losses: the one global loss in global mode, the
    mean over ranks in parity mode."""
    loss, loss_nl = loss.detach(), loss_nl.detach()
    if joint_mode == "parity":
        loss, loss_nl = global_mean(loss, mesh), global_mean(loss_nl, mesh)
    return loss, loss_nl


def make_seg_train_step(net, optimizer, lamb, head, half_T_side_dense,
                        half_T_side_sparse_min, half_T_side_sparse_max,
                        sobel=False, include_rgb=False, using_IR=False,
                        use_uncollapsed_loss=False, augment=None,
                        joint_impl="pallas", mesh=None, joint_mode="global"):
    """Returns ``step(batch, generator=None) -> (loss, loss_no_lamb)``
    (detached 0-d tensors).

    Without ``augment``: batch = (img1, img2, affine2_to_1, mask).
    With ``augment``: batch = (imgs_u8, masks_u8) and the paired
    augmentation draws from ``generator``. Under a mesh a padded row
    carries a zero relevancy mask, which takes it out of the joint.
    """
    joint_mesh = _check_mode(mesh, joint_mode)
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
                           generator=generator, mesh=joint_mesh)
                 for s in range(out1.shape[0])]
        loss = torch.stack([p[0] for p in pairs]).mean()
        loss_nl = torch.stack([p[1] for p in pairs]).mean()

        _optimizer_step(optimizer, params, loss, mesh, joint_mode, net)
        return _logged(loss, loss_nl, mesh, joint_mode)

    return step


def make_semisup_optimizer(model, trunk_lr, head_lr):
    """The reference's two Adams (trunk and head) as one ``torch.optim.Adam``
    with a parameter group each: the JAX package's ``multi_transform`` of
    two Adams, the same betas and eps. ``set_lr_mult`` multiplies both
    groups' rates. The old net's clustering heads, which the finetune
    never reaches, are in neither group (Adam would not move them)."""
    return torch.optim.Adam([
        {"params": list(model.net.trunk.parameters()), "lr": trunk_lr},
        {"params": list(model.head.parameters()), "lr": head_lr}])


def make_semisup_train_step(model, optimizer, augment=None, mesh=None):
    """Returns ``step(batch, generator=None) -> loss`` (a detached 0-d
    tensor), the semisup finetune's step: tf2 augmentation (and sobel) ->
    trunk features -> SupHead5 -> mean cross-entropy -> one Adam step of
    both groups.

    With ``augment``: batch = (images uint8 (b, H, W, C), labels (b,)) and
    ``augment(images, generator)`` returns the NCHW float32 net input.
    Without: batch = (net input, labels).

    Under a mesh the loss is the mean cross-entropy over the global batch:
    each rank's summed cross-entropy over the global count, the gradients
    summed (on equal shards, the JAX step's pmean of the shards' means).
    A padded row's label is ``data.semisup.PAD_LABEL`` (its weight 0)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch, generator=None):
        imgs, labels = batch
        if augment is not None:
            imgs = augment(imgs, generator)
        model.train()
        labels = labels.long()
        if mesh is None:
            loss = F.cross_entropy(model(imgs), labels)
            _optimizer_step(optimizer, params, loss)
            return loss.detach()
        count = all_reduce_joint((labels != PAD_LABEL).sum().float(), mesh)
        loss = F.cross_entropy(model(imgs), labels, ignore_index=PAD_LABEL,
                               reduction="sum") / count
        _optimizer_step(optimizer, params, loss, mesh, "global", model)
        return all_reduce_joint(loss.detach(), mesh)

    return step



@contextmanager
def frozen_batch_stats(net):
    """Run ``net`` in train mode (BatchNorm on batch statistics) inside the
    block, and put its running statistics and batch counts back after it:
    the JAX package's train-mode apply with the updated ``batch_stats``
    thrown away. A train-mode torch forward updates them in place, even
    under ``no_grad``."""
    saved = [(b, b.clone()) for b in net.buffers()]
    was_training = net.training
    net.train()
    try:
        yield
    finally:
        net.train(was_training)
        with torch.no_grad():
            for b, copy in saved:
                b.copy_(copy)


def make_apply_fn(net, head=None, sobel=False, include_rgb=False,
                  using_IR=False, train_mode=False, **net_kw):
    """Eval forward: ``apply(imgs) -> (num_sub_heads, bn, k[, h, w])``, no
    gradients. BN runs in eval mode (batch statistics when it tracks none),
    or with ``train_mode`` (the reference's "double eval") on the batch's
    statistics, leaving the running statistics as they were. ``net_kw``
    goes to the net's forward (the baselines' nets: their features)."""
    head_kw = dict(net_kw) if head is None else {"head": head, **net_kw}

    @torch.no_grad()
    def apply(imgs):
        if sobel:
            imgs = sobel_process(imgs, include_rgb, using_IR=using_IR)
        if train_mode:
            with frozen_batch_stats(net):
                return net(imgs, **head_kw)
        was_training = net.training
        net.eval()
        try:
            return net(imgs, **head_kw)
        finally:
            net.train(was_training)

    return apply
