"""The semi-supervised finetune (``iic_tpu/train/semisup_trainer.py``: the
reference's IID_semisup_STL10 script) on one GPU or on several ranks
(``--n_devices``: each rank steps on its shard of the batch, which is
rounded down to a multiple of the ranks; the cross-entropy is the global
batch's mean, a ragged final batch padded with rows it ignores; every
rank evaluates, rank 0 alone writes the run's files).

Reads a pretrained IID+ overclustering run by ``--old_model_ind`` (its
config.pickle and best.pytorch, or latest.pytorch when no epoch beat its
pre-train eval), reads its net as a feature trunk (``--penultimate_features``:
the ResNet's features before layer4), puts ``SupHead5Head`` on it and
trains both with cross-entropy under the old run's tf2 (on the sobel path
with ``--random_affine`` and ``--cutout``; a greyscale old run finetunes
through the greyscale tf2 with no sobel), at two learning rates (trunk and
head: one Adam with a group each). The eval averages each test image's
logits over its 10 crops (``assess_acc_block``) before training and after
every epoch. ``latest`` is saved every 10 epochs and at the last, ``best``
when an eval beats every earlier one; ``--restart`` resumes from
``latest`` (``--restart_new_model_ind`` under a new run id), and
``--test_code`` runs two batches and one epoch.

Precision: the trunk runs in the old run's ``--model_dtype``; the head,
the loss and Adam stay f32. f32 cuDNN convolutions run in TF32 and
matmuls (the head) in full f32; both flags are set here.

Input: each epoch's batches run behind the host prefetch thread
(``--prefetch_depth``, 8).
"""

import dataclasses
import sys
import time
from datetime import datetime
from types import SimpleNamespace

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.data import readers
from iic_tpu_torch.data.pipeline import _is_greyscale
from iic_tpu_torch.data.prefetch import host_prefetch_iter
from iic_tpu_torch.data.semisup import (
    SemisupTrainLoader, make_tencrop_batch_fn)
from iic_tpu_torch.data.transforms import (
    make_greyscale_pair_transforms, make_sobel_pair_transforms)
from iic_tpu_torch.device import resolve_device
from iic_tpu_torch.models.semisup import SemisupNet, SupHead5Head
from iic_tpu_torch.ops.sobel import sobel_process
from iic_tpu_torch.parallel.mesh import broadcast_state, run_data_parallel
from iic_tpu_torch.parallel.train_step import (
    make_semisup_optimizer, make_semisup_train_step, set_lr_mult)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train.config import ClusterConfig, config_to_str


def _log(msg):
    print(msg)
    sys.stdout.flush()


def load_old_run(config, device):
    """The old run's ``ClusterConfig`` (from its config.pickle) and its net
    on ``device``, filled from best.pytorch, or latest.pytorch when it has
    no best. Returns (old config, net, the checkpoint's name)."""
    meta = ckpt.read_meta(config.out_root, config.old_model_ind)
    fields = {f.name for f in dataclasses.fields(ClusterConfig)}
    old = ClusterConfig(**{
        k: tuple(v) if isinstance(v, list) else v  # lists pickled as such
        for k, v in meta["config"].items() if k in fields})
    if old.model_ind != config.old_model_ind:
        raise ValueError(f"run {config.old_model_ind}'s config.pickle is "
                         f"model {old.model_ind}'s")
    net = models.build(old.arch, old).to(device)
    name = ckpt.load_run_net(config.out_root, config.old_model_ind, net,
                             device)
    return old, net, name


@torch.no_grad()
def get_dlen(net, dummy_imgs, penultimate_features=False):
    """The width of ``net``'s trunk features on images like
    ``dummy_imgs`` (eval-mode BN, so no statistics move)."""
    was_training = net.training
    net.eval()
    try:
        feats = net(dummy_imgs, trunk_features=True,
                    penultimate_features=penultimate_features)
    finally:
        net.train(was_training)
    return int(np.prod(feats.shape[1:]))


@torch.no_grad()
def block_logits(apply_fn, imgs_u8, tencrop_fn):
    """(b, H, W, C) uint8 images on the device -> (b, gt_k) logits, the mean
    over each image's 10 crops."""
    logits = apply_fn(tencrop_fn(imgs_u8))
    return logits.reshape(len(imgs_u8), 10, -1).mean(dim=1)


def assess_acc_block(apply_fn, test_images_u8, test_labels, tencrop_fn,
                     device, batch_images=64):
    """The 10-crop block-averaged accuracy: each image's logits averaged
    over its crops, then the argmax against its label, over the test set in
    batches of ``batch_images`` images (numpy uint8 and labels in)."""
    n = len(test_images_u8)
    correct = torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, n, batch_images):
        stop = start + batch_images
        imgs = torch.from_numpy(np.ascontiguousarray(
            test_images_u8[start:stop])).to(device)
        labels = torch.from_numpy(np.asarray(
            test_labels[start:stop], np.int64)).to(device)
        preds = block_logits(apply_fn, imgs, tencrop_fn).argmax(dim=1)
        correct += (preds == labels).sum()
    return int(correct) / float(n)


def _supervised_tf2(config, old_config):
    """The old run's tf2 with the finetune's --random_affine / --cutout
    flags (the sobel path's; the greyscale tf2 takes neither), and whether
    the path is greyscale."""
    sup = SimpleNamespace(**dataclasses.asdict(old_config))
    sup.cutout = config.cutout
    sup.cutout_p = config.cutout_p
    sup.cutout_max_box = config.cutout_max_box
    sup.use_random_affine = config.random_affine
    sup.affine_p = config.affine_p
    grey = _is_greyscale(old_config)
    make = make_greyscale_pair_transforms if grey else \
        make_sobel_pair_transforms
    return make(sup)[1], grey


def make_finetune(config, device, mesh=None):
    """The finetune's parts on ``device``: reads the old run, builds the
    head, the ``SemisupNet`` and its optimiser, the train loader, the step
    and the 10-crop eval. Returns a namespace of them: ``model``,
    ``optimizer``, ``loader``, ``step`` (``step((images, labels),
    generator)``) and ``evaluate()`` (the test accuracy). On a ``mesh`` of
    several ranks the loader yields the rank's shard of a batch rounded
    down to a multiple of the ranks."""
    old_config, net, name = load_old_run(config, device)
    _log(f"old model {config.old_model_ind}: {name}.pytorch")
    if config.new_batch_sz == -1:
        config.new_batch_sz = old_config.batch_sz

    tf2, grey = _supervised_tf2(config, old_config)
    parts = (("train", "test") if old_config.dataset == "STL10"
             else (True, False))
    train_d, test_d = (readers.load_dataset(
        old_config.dataset, old_config.dataset_root, p) for p in parts)
    train_imgs, train_labels = train_d["images"], train_d["labels"]
    if config.train_label_pc < 1.0:  # a fixed random fraction of labels
        keep = np.random.default_rng(config.seed).permutation(
            len(train_imgs))[:int(len(train_imgs) * config.train_label_pc)]
        train_imgs, train_labels = train_imgs[keep], train_labels[keep]
        _log(f"train_label_pc {config.train_label_pc}: {len(train_imgs)} "
             "labelled samples")
    batch_sz = min(config.new_batch_sz, len(train_imgs))
    shard = None
    if mesh is not None and mesh.size > 1:
        shard = (mesh.rank, mesh.size)
        if batch_sz % mesh.size:
            rounded = max((batch_sz // mesh.size) * mesh.size, mesh.size)
            _log(f"mesh({mesh.size}): adjusted semisup batch_sz {batch_sz} "
                 f"-> {rounded}")
            batch_sz = rounded
    loader = SemisupTrainLoader(train_imgs, train_labels, batch_sz,
                                seed=config.seed, device=device,
                                process_shard=shard)
    tencrop_fn = make_tencrop_batch_fn(old_config.input_sz,
                                       old_config.include_rgb,
                                       grey_append=not grey)

    sz = old_config.input_sz
    dlen = get_dlen(net, torch.zeros((2, old_config.in_channels, sz, sz),
                                     device=device),
                    config.penultimate_features)
    _log(f"dlen: {dlen}")
    torch.manual_seed(config.seed)  # the head's init
    head = SupHead5Head(dlen, old_config.gt_k,
                        old_config.batchnorm_track).to(device)
    model = SemisupNet(net, head, config.penultimate_features)
    optimizer = make_semisup_optimizer(model, config.trunk_lr,
                                       config.head_lr)
    include_rgb = old_config.include_rgb

    def augment(imgs_u8, generator):
        imgs = tf2(imgs_u8.float() / 255.0, generator)
        imgs = imgs.permute(0, 3, 1, 2).contiguous()
        return imgs if grey else sobel_process(imgs, include_rgb)

    @torch.no_grad()
    def apply_fn(imgs):
        if not grey:
            imgs = sobel_process(imgs, include_rgb)
        model.eval()
        return model(imgs)

    def evaluate():
        return assess_acc_block(apply_fn, test_d["images"], test_d["labels"],
                                tencrop_fn, device)

    return SimpleNamespace(
        model=model, optimizer=optimizer, loader=loader,
        step=make_semisup_train_step(model, optimizer, augment, mesh=mesh),
        evaluate=evaluate)


def train_semisup(config, device=None):
    """Run the finetune. Returns (model, history): the ``SemisupNet`` and
    {"epoch_acc" (the pre-train eval first), "epoch_loss", "step_seconds",
    "eval_seconds"}. ``device`` defaults to cuda:0; the tests pass "cpu".
    ``--n_devices N > 1`` runs N ranks (``run_data_parallel``) and returns
    rank 0's model (on the CPU where spawned) and history."""
    return run_data_parallel(_train, config, device)


def _train(config, device, mesh):
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    main_rank = mesh is None or mesh.is_main
    _log(config_to_str(config))
    _log(f"device: {device}" + (f", rank {mesh.rank} of {mesh.size}"
                                if mesh else ""))
    ft = make_finetune(config, device, mesh)
    model, optimizer, loader, step = (ft.model, ft.optimizer, ft.loader,
                                      ft.step)

    def evaluate():
        t0 = time.perf_counter()
        acc = ft.evaluate()
        history["eval_seconds"].append(time.perf_counter() - t0)
        return acc

    if config.restart:
        history, last_epoch = ckpt.load_checkpoint(config, model, optimizer,
                                                   device, name="latest")
        start_epoch = last_epoch + 1
        # config.pickle is written every epoch, latest.pytorch every 10:
        # drop the history past the restored weights (epoch e's acc sits
        # at index e + 1, after the pre-train eval's)
        del history["epoch_acc"][last_epoch + 2:]
        del history["epoch_loss"][last_epoch + 1:]
        if config.restart_new_model_ind:
            config.model_ind = config.new_model_ind
            _log(f"restarting as model {config.model_ind}")
        _log(f"restarting from epoch {start_epoch}")
    else:
        history = {"epoch_acc": [], "epoch_loss": [], "step_seconds": [],
                   "eval_seconds": []}
        start_epoch = 0
        acc = evaluate()
        _log(f"pre: model {config.model_ind} old model "
             f"{config.old_model_ind}, acc {acc:.6f} {datetime.now()}")
        history["epoch_acc"].append(acc)
    broadcast_state(model, optimizer, mesh)  # every rank from rank 0's

    last_saved = start_epoch - 1  # epoch of the on-disk latest weights
    for e_i in range(start_epoch, config.num_epochs):
        if e_i in set(config.lr_schedule):
            set_lr_mult(optimizer, config.lr_mult)
            _log(f"e_i {e_i}, multiplying trunk and head lr by "
                 f"{config.lr_mult}")
        avg_loss, count = 0.0, 0
        it = host_prefetch_iter(loader.epoch(e_i), config)
        for b_i, (imgs, labels, gen) in enumerate(it):
            t0 = time.perf_counter()
            loss = float(step((imgs, labels), gen))  # syncs
            history["step_seconds"].append(time.perf_counter() - t0)
            if not np.isfinite(loss):
                _log(f"Loss is NaN/inf ({loss}). Exiting.")
                sys.exit(1)
            avg_loss += loss
            count += 1
            if b_i % 100 == 0:
                _log(f"batch {b_i} of {len(loader)}, loss {loss:.5f} "
                     f"{datetime.now()}")
            if config.test_code and b_i >= 1:
                break
        it.close()  # stops the thread after --test_code's break
        avg_loss /= count

        acc = evaluate()
        _log(f"model {config.model_ind} old model {config.old_model_ind} "
             f"epoch {e_i} acc {acc:.6f} {datetime.now()}")
        is_best = acc > max(history["epoch_acc"])
        history["epoch_acc"].append(acc)
        history["epoch_loss"].append(avg_loss)

        if e_i % 10 == 0 or e_i == config.num_epochs - 1:
            last_saved = e_i
            if main_rank:
                ckpt.save_checkpoint(config, model, optimizer, history,
                                     "latest", last_epoch=e_i)
        if main_rank:
            if is_best:
                ckpt.save_checkpoint(config, model, optimizer, history,
                                     "best", last_epoch=last_saved)
            ckpt.save_meta(config, history, last_saved)
        if config.test_code:
            break
    return model, history
