"""Restart in both two-head CLIs and the single-head segmentation path:
a run cut after epoch 2 and resumed with ``--restart`` equals one
uninterrupted run bit for bit on the CPU (epoch losses, eval accuracies
and final weights: the data order and every augmentation draw are seeded
by epoch and batch, and the checkpoint carries Adam's moments and the
learning rate); ``--restart_from_best`` resumes after the best eval with
the history truncated as the JAX package truncates it; a four-step
lockstep of the single-head step (``head=None``) against the JAX one; and
the single-head CLI's run directory."""

import copy
import pickle
import shutil
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel import make_seg_train_step as jax_seg_step
from iic_tpu.train.cluster_trainer import _truncate_history as jax_truncate
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.cli import (
    cluster_sobel_twohead, segmentation, segmentation_twohead)
from iic_tpu_torch.cli._args import parse_cluster_args, parse_seg_args
from iic_tpu_torch.compat.flax_bridge import load_seg_net
from iic_tpu_torch.parallel.train_step import (
    make_optimizer, make_seg_train_step)
from iic_tpu_torch.train import checkpoint as ckpt
from iic_tpu_torch.train import seg_trainer

from test_torch_train import _batches

SEG = ["--mode", "IID", "--dataset", "SyntheticSeg3x36x8",
       "--dataset_root", "", "--arch", "SegmentationNet10aTwoHead",
       "--lamb_A", "1.0", "--lamb_B", "1.5", "--num_sub_heads", "1",
       "--batch_sz", "4", "--num_dataloaders", "1", "--output_k_A", "5",
       "--output_k_B", "3", "--gt_k", "3", "--input_sz", "32",
       "--half_T_side_sparse_min", "0", "--half_T_side_sparse_max", "0",
       "--half_T_side_dense", "2", "--include_rgb", "--use_uncollapsed_loss",
       "--batchnorm_track", "--lr", "0.001"]
CLUSTER = ["--arch", "ClusterNet5gTwoHead", "--mode", "IID",
           "--dataset", "Synthetic3x32x3x4", "--gt_k", "3",
           "--output_k_A", "5", "--output_k_B", "3", "--lamb", "1.0",
           "--lr", "0.0001", "--batch_sz", "24", "--num_dataloaders", "3",
           "--num_sub_heads", "1", "--crop_orig", "--rand_crop_sz", "20",
           "--input_sz", "32", "--batchnorm_track"]
FAMILIES = {"seg": (segmentation_twohead.main, SEG),
            "cluster": (cluster_sobel_twohead.main, CLUSTER)}
LOSSES = ("epoch_loss_head_A", "epoch_loss_no_lamb_head_A",
          "epoch_loss_head_B", "epoch_loss_no_lamb_head_B")


@pytest.fixture(autouse=True)
def _drop_run_dirs(request):
    """Removes a test's temporary directory (its CLI runs' directories,
    each a checkpoint or more) once the test is done: pytest keeps the
    temporary directories of its last runs."""
    root = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if root is not None:
        shutil.rmtree(root, ignore_errors=True)


def _run(family, out_root, epochs, extra=()):
    main, argv = FAMILIES[family]
    return main(argv + ["--num_epochs", str(epochs), "--out_root",
                        str(out_root)] + list(extra), device="cpu")


def _saved(out_root, name="latest"):
    return torch.load(out_root / "0" / f"{name}.pytorch", weights_only=True)


def _lr(out_root):
    return _saved(out_root)["optimiser"]["param_groups"][0]["lr"]


SCHEDULE = ["--lr_schedule", "1", "3", "--lr_mult", "0.5"]


@pytest.mark.parametrize("family,schedule", [
    ("seg", []), ("seg", SCHEDULE), ("cluster", SCHEDULE)])
def test_restart_equals_an_uninterrupted_run(tmp_path, family, schedule):
    """Epochs 1-3 in one run against epochs 1-2, then --restart for epoch
    3: equal epoch losses, eval accuracies and weights, bit for bit. With
    lr steps at epochs 1 and 3, the step at 1 is taken once (the saved
    Adam state carries it) and the step at 3 after the restart."""
    full, cut = tmp_path / "full", tmp_path / "cut"
    net_full, h_full = _run(family, full, 4, schedule)
    _run(family, cut, 3, schedule)
    lr_saved = _lr(cut)
    net_cut, h_cut = _run(family, cut, 4, schedule + ["--restart"])
    for key in LOSSES:
        assert len(h_cut[key]) == 3 and h_cut[key] == h_full[key], key
    assert h_cut["eval"].epoch_acc == h_full["eval"].epoch_acc
    assert len(h_cut["eval"].epoch_acc) == 4
    full_sd, cut_sd = net_full.state_dict(), net_cut.state_dict()
    assert full_sd.keys() == cut_sd.keys()
    for k, v in full_sd.items():
        assert torch.equal(v, cut_sd[k]), k
    lr = 0.001 if family == "seg" else 0.0001
    if schedule:
        assert lr_saved == lr * 0.5
        assert _lr(cut) == _lr(full) == lr * 0.5 * 0.5
    else:
        assert lr_saved == _lr(cut) == _lr(full) == lr
    with open(cut / "0" / "config.pickle", "rb") as f:
        assert pickle.load(f)["last_epoch"] == 3


@pytest.mark.parametrize("family", ["seg", "cluster"])
def test_restored_lr_is_the_saved_one(tmp_path, family):
    """Past an lr step (epoch 1) the restored optimiser has the saved
    learning rate: resume does not take the step again."""
    _run(family, tmp_path, 3, ["--lr_schedule", "1", "--lr_mult", "0.1"])
    argv = FAMILIES[family][1] + ["--out_root", str(tmp_path), "--restart"]
    if family == "seg":
        cfg = parse_seg_args(argv).finalize(twohead=True)
    else:
        cfg = parse_cluster_args(argv).finalize(twohead=True, sobel=True)
    net = tmodels.build(cfg.arch, cfg)
    opt = make_optimizer(net, cfg)
    assert opt.param_groups[0]["lr"] == cfg.lr
    history, next_epoch = seg_trainer.resume(cfg, net, opt, "cpu")
    assert next_epoch == 3
    assert opt.param_groups[0]["lr"] == _lr(tmp_path) == cfg.lr * 0.1
    assert len(history["epoch_loss_head_A"]) == 2


@pytest.mark.parametrize("family", ["seg", "cluster"])
def test_restart_from_best_resumes_after_the_best_eval(tmp_path, family,
                                                       monkeypatch):
    """The best eval is made epoch 1's in config.pickle: --restart_from_best
    loads best.pytorch, resumes at epoch 2 and keeps the history JAX's
    _truncate_history keeps (pre-eval and epoch 1), then trains 2 and 3."""
    _run(family, tmp_path, 4)
    path = tmp_path / "0" / "config.pickle"
    with open(path, "rb") as f:
        meta = pickle.load(f)
    meta["history"]["eval"].epoch_acc[:] = [0.1, 0.9, 0.2, 0.3]
    with open(path, "wb") as f:
        pickle.dump(meta, f)
    kept = copy.deepcopy(meta["history"])
    jax_truncate(kept, 2)
    ours = copy.deepcopy(meta["history"])
    seg_trainer.truncate_history(ours, 2)
    for key in LOSSES:
        assert ours[key] == kept[key] and len(ours[key]) == 1
    assert ours["eval"] == kept["eval"]

    names = []
    load = ckpt.load_checkpoint
    monkeypatch.setattr(ckpt, "load_checkpoint",
                        lambda *a, **kw: names.append(kw["name"])
                        or load(*a, **kw))
    _, history = _run(family, tmp_path, 4, ["--restart",
                                            "--restart_from_best"])
    assert names == ["best"]
    for key in LOSSES:
        assert history[key][:1] == kept[key] and len(history[key]) == 3
    assert history["eval"].epoch_acc[:2] == [0.1, 0.9]
    assert len(history["eval"].epoch_acc) == 4


SZ, HALF_T = 24, 2


@pytest.mark.parametrize("uncollapsed", [True, False])
def test_single_head_lockstep_with_jax(uncollapsed):
    """Four steps of the single-head step (head=None, the IID+ script's)
    from the same weights on the same batches: the JAX step (exact gather
    warp, conv joint, optax adam) and the port's. The loss differs by at
    most 1e-4 at every step."""
    cfg = SimpleNamespace(in_channels=5, output_k=6, num_sub_heads=2,
                          input_sz=SZ, batchnorm_track=True, opt="Adam",
                          lr=1e-3)
    jnet = jmodels.build("SegmentationNet10a", cfg)
    variables = jmodels.init_variables(
        jnet, jax.random.PRNGKey(0), jnp.zeros((2, 5, SZ, SZ)), heads=None)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=cfg.lr)
    state = create_train_state(variables, tx)
    tnet = load_seg_net(jax.device_get(variables),
                        tmodels.build("SegmentationNet10a", cfg))
    opt = make_optimizer(tnet, cfg)
    common = dict(half_T_side_dense=HALF_T, half_T_side_sparse_min=0,
                  half_T_side_sparse_max=0, sobel=True, include_rgb=True,
                  use_uncollapsed_loss=uncollapsed)
    jstep = jax_seg_step(jnet, tx, lamb=1.0, head=None, warp_impl="gather",
                         joint_impl="conv", **common)
    tstep = make_seg_train_step(tnet, opt, lamb=1.0, head=None, **common)
    key = jax.random.PRNGKey(0)
    for batch in _batches(4, seed=1):
        state, jloss, jloss_nl = jstep(
            state, tuple(jnp.asarray(x) for x in batch), key)
        tloss, tloss_nl = tstep(tuple(torch.from_numpy(x) for x in batch))
        assert abs(float(tloss) - float(jloss)) <= 1e-4, (tloss, jloss)
        assert abs(float(tloss_nl) - float(jloss_nl)) <= 1e-4


def test_single_head_cli_trains_evaluates_and_checkpoints(tmp_path):
    """cli.segmentation (IID+, one head, losses in the B slots) writes the
    reference's run directory: latest / best weights, config.pickle and
    plots.png (--no_pre_eval records the pre-eval as 0, so epoch 1 is the
    best)."""
    argv = [a for a in SEG if a != "--use_uncollapsed_loss"]
    argv[argv.index("SegmentationNet10aTwoHead")] = "SegmentationNet10a"
    net, history = segmentation.main(
        argv + ["--output_k", "6", "--num_epochs", "2", "--test_code",
                "--no_pre_eval", "--out_root", str(tmp_path)], device="cpu")
    assert isinstance(net, tmodels.SegmentationNet10a)
    assert history["epoch_loss_head_A"] == []
    assert len(history["epoch_loss_head_B"]) == 1
    assert np.isfinite(history["epoch_loss_head_B"]).all()
    assert len(history["step_seconds_head_B"]) == 2
    assert len(history["eval"].epoch_acc) == 2
    run = tmp_path / "0"
    for name in ("latest.pytorch", "best.pytorch", "config.pickle",
                 "plots.png"):
        assert (run / name).exists(), name
    with open(run / "config.pickle", "rb") as f:
        meta = pickle.load(f)
    assert meta["config"]["mode"] == "IID+" and not meta["config"]["twohead"]
    assert meta["last_epoch"] == 1
    assert any(k.startswith("head.") for k in _saved(tmp_path)["net"])


def test_trainers_refuse_the_other_head_count():
    cfg = SimpleNamespace(twohead=False)
    with pytest.raises(ValueError, match="single-head"):
        seg_trainer.train_segmentation_twohead(cfg, device="cpu")
    with pytest.raises(ValueError, match="two-head"):
        seg_trainer.train_segmentation_single(SimpleNamespace(twohead=True),
                                              device="cpu")
