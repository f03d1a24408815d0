"""The single-head IID+ clustering path (``train_cluster_single``,
``cli/cluster_sobel.py``, ``cli/cluster_greyscale.py``) against the JAX
package: a four-step lockstep of the single-head step (``head=None``, the
plain loss) from bridged weights; ``cluster_create_dataloaders``'s batches
on a greyscale set and on an STL10 tree under ``--mix_train``; both CLIs
with ``--test_code`` on the CPU (the many-to-one eval, the losses in the
head-B slots, no K3 even under ``--fused_loss``); no GPU without a device;
and ``--restart`` bit-equal to an uninterrupted run."""

import pickle
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.data import pipeline as jpipe
from iic_tpu.parallel import create_train_state
from iic_tpu.parallel import make_cluster_train_step as jax_cluster_step
from iic_tpu.train.config import ClusterConfig as JaxClusterConfig
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.cli import cluster_greyscale, cluster_sobel
from iic_tpu_torch.cli._args import parse_cluster_args
from iic_tpu_torch.compat.flax_bridge import load_cluster_net
from iic_tpu_torch.data import pipeline as tpipe
from iic_tpu_torch.parallel.train_step import (
    make_cluster_train_step, make_optimizer)
from iic_tpu_torch.train import cluster_trainer
from iic_tpu_torch.train.config import ClusterConfig
from test_torch_cluster_grey import (
    ATOL, LOCKSTEP_LR, LOCKSTEP_TOL, _batches, _counting_fused, _net_cfg,
    write_stl10)
from test_torch_cluster_models import random_flax_variables

GREY = ["--arch", "ClusterNet6c", "--dataset", "Synthetic10x28x1x32",
        "--gt_k", "10", "--output_k", "20", "--lr", "0.0001",
        "--batch_sz", "12", "--num_dataloaders", "3", "--num_sub_heads", "2",
        "--crop_orig", "--crop_other", "--tf1_crop", "centre_half",
        "--tf2_crop", "random", "--tf1_crop_sz", "20", "--tf2_crop_szs",
        "16", "20", "24", "--input_sz", "24", "--rot_val", "25", "--no_flip",
        "--batchnorm_track"]
# model 653's flags (examples/commands.md:60-64) at a small batch
SOBEL = ["--arch", "ClusterNet5g", "--dataset", "STL10", "--gt_k", "10",
         "--output_k", "14", "--lr", "0.0001", "--lamb", "1.0",
         "--num_sub_heads", "2", "--batch_sz", "6", "--num_dataloaders", "3",
         "--mix_train", "--crop_orig", "--rand_crop_sz", "64",
         "--input_sz", "64", "--mode", "IID+", "--batchnorm_track"]


def test_single_head_lockstep_with_jax():
    """Four steps of the single-head net6c step (no head argument, the
    plain loss) from the same weights on the same batches: the loss and
    the loss without lambda within ``LOCKSTEP_TOL`` of JAX's at every step
    (lr as in the two-head lockstep)."""
    cfg = _net_cfg("ClusterNet6c")
    jnet = jmodels.build(cfg.arch, cfg)
    variables = random_flax_variables(jnet, 1, heads=None, seed=4,
                                      head_std=0.1, sz=24)
    tnet = load_cluster_net(variables, tmodels.build(cfg.arch, cfg))
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LOCKSTEP_LR)
    state = create_train_state(variables, tx)
    opt = make_optimizer(tnet, SimpleNamespace(opt="Adam", lr=LOCKSTEP_LR))
    jstep = jax_cluster_step(jnet, tx, lambda batch, key: batch, lamb=1.2,
                             head=None)
    tstep = make_cluster_train_step(tnet, opt, None, lamb=1.2, head=None)
    losses = []
    for batch in _batches(4, seed=2):
        state, jloss, jloss_nl = jstep(
            state, tuple(jnp.asarray(x) for x in batch),
            jax.random.PRNGKey(0))
        tloss, tloss_nl = tstep(tuple(torch.from_numpy(x) for x in batch))
        assert abs(float(tloss) - float(jloss)) <= LOCKSTEP_TOL
        assert abs(float(tloss_nl) - float(jloss_nl)) <= LOCKSTEP_TOL
        losses.append(float(jloss))
    assert max(abs(v) for v in losses) > 1e-2


def _single_cfgs(argv):
    tcfg = parse_cluster_args(argv, defaults={"mode": "IID+"})
    jcfg = JaxClusterConfig(**{f: getattr(tcfg, f) for f in (
        "dataset", "dataset_root", "batch_sz", "num_dataloaders", "mix_train",
        "crop_orig", "crop_other", "tf1_crop", "tf1_crop_sz", "tf2_crop",
        "tf2_crop_szs", "rand_crop_sz", "input_sz", "rot_val", "no_flip",
        "mode")})
    return tcfg, jcfg


@pytest.mark.parametrize("family", ["grey", "stl10"])
def test_single_head_dataloaders_yield_the_jax_batches(tmp_path, family):
    """The IID+ train pipeline's sequential batches (ragged last kept) and
    the mapping loaders' tf3 batches equal JAX's: net6c's set (train
    trains and maps, test is held out) and an STL10 tree (train+unlabeled
    interleaved by --mix_train trains, train maps, test is held out)."""
    if family == "grey":
        tcfg, jcfg = _single_cfgs(GREY)
        tcfg.finalize(twohead=False, sobel=False)
        jcfg.finalize(twohead=False, sobel=False)
    else:
        write_stl10(str(tmp_path))
        tcfg, jcfg = _single_cfgs(SOBEL + ["--dataset_root", str(tmp_path)])
        tcfg.finalize(twohead=False, sobel=True)
        jcfg.finalize(twohead=False, sobel=True)
    got = tpipe.cluster_create_dataloaders(tcfg, seed=2)
    ref = jpipe.cluster_create_dataloaders(jcfg, seed=2)
    gb = [b.numpy() for b, _ in got[0].epoch(1)]
    rb = [np.asarray(b) for b, _ in ref[0].epoch(1, augmented=False)]
    assert [len(b) for b in gb] == [len(b) for b in rb] == (
        [4] * 8 if family == "grey" else [2] * 6)
    assert all(np.array_equal(g, r) for g, r in zip(gb, rb))
    if family == "stl10":  # each labelled image, then its 2 unlabelled
        assert got[0].labels.tolist()[:6] == [
            ref[0].labels[0], -1, -1, ref[0].labels[3], -1, -1]
    for g, r in zip(got[1:], ref[1:]):
        assert len(g) == len(r)
        for (gi, gl), (ri, rl) in zip(g, r):
            np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=ATOL)
            assert np.array_equal(gl, np.asarray(rl))
    if family == "grey":
        assert got[1].images is got[0].images


@pytest.mark.parametrize("cli,argv,stl", [
    (cluster_greyscale, GREY, False),
    (cluster_greyscale, GREY + ["--model_dtype", "bfloat16"], False),
    (cluster_sobel, SOBEL, True)])
def test_single_head_clis_on_cpu(tmp_path, monkeypatch, cli, argv, stl):
    """--test_code (with --fused_loss, which the single-head path does not
    take to K3, as in the JAX package): finite losses in the head-B slots
    from two steps, head A's empty, a pre-train and an epoch eval in mode
    IID+ (the many-to-one match), the run directory's files."""
    calls = _counting_fused(monkeypatch)
    root = tmp_path / "data"
    if stl:
        write_stl10(str(root))
    net, history = cli.main(argv + [
        "--dataset_root", str(root), "--num_epochs", "2", "--test_code",
        "--fused_loss", "--out_root", str(tmp_path)], device="cpu")
    assert np.isfinite(history["epoch_loss_head_B"]).all()
    assert len(history["step_seconds_head_B"]) == 2
    assert history["epoch_loss_head_A"] == []
    ev = history["eval"]
    assert len(ev.epoch_acc) == 2 and all(0 <= a <= 1 for a in ev.epoch_acc)
    assert ev.epoch_stats[-1]["train_accs"] is not None
    assert calls == []
    with open(tmp_path / "0" / "config.pickle", "rb") as f:
        meta = pickle.load(f)
    assert meta["last_epoch"] == 1
    assert meta["config"]["mode"] == "IID+"
    assert meta["config"]["eval_mode"] == "orig"
    assert (tmp_path / "0" / "latest.pytorch").exists()


@pytest.mark.parametrize("name", ["cluster_greyscale", "cluster_sobel",
                                  "cluster_greyscale_twohead",
                                  "cluster_sobel_twohead"])
def test_cli_config_is_the_jax_clis(monkeypatch, name):
    """Each clustering CLI's ``config`` (the config its ``main`` trains)
    equals the one the JAX CLI of that name hands its trainer, on flags
    that set ``--lamb`` apart from ``--lamb_A`` / ``--lamb_B`` (the sobel
    two-head script takes both from ``--lamb``) and leave ``--mode``
    unset (the single-head scripts default to IID+)."""
    import importlib

    jcli = importlib.import_module(f"iic_tpu.cli.{name}")
    tcli = importlib.import_module(f"iic_tpu_torch.cli.{name}")
    trainer = ("train_cluster_twohead" if name.endswith("twohead")
               else "train_cluster_single")
    seen = []
    monkeypatch.setattr(jcli, trainer, seen.append)
    argv = GREY + ["--output_k_A", "30", "--output_k_B", "10", "--lamb",
                   "2.0", "--lamb_A", "0.5", "--lamb_B", "1.5"]
    jcli.main(argv)
    got, want = vars(tcli.config(argv)), vars(seen[0])
    shared = sorted(set(got) & set(want))
    assert len(shared) > 50
    assert {k: got[k] for k in shared} == {
        k: type(got[k])(want[k]) if isinstance(want[k], (list, tuple))
        else want[k] for k in shared}


@pytest.mark.parametrize("cli", [cluster_greyscale, cluster_sobel])
def test_single_head_clis_need_a_gpu_without_a_device(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(GREY + ["--out_root", str(tmp_path), "--test_code"])


def test_trainers_refuse_the_other_family():
    single = ClusterConfig(mode="IID+").finalize(twohead=False, sobel=False)
    two = ClusterConfig().finalize(twohead=True, sobel=False)
    with pytest.raises(ValueError, match="train_cluster_single"):
        cluster_trainer.train_cluster_twohead(single, device="cpu")
    with pytest.raises(ValueError, match="train_cluster_twohead"):
        cluster_trainer.train_cluster_single(two, device="cpu")


def _run(out_root, epochs, extra=()):
    return cluster_greyscale.main(
        GREY + ["--num_epochs", str(epochs), "--out_root", str(out_root),
                "--lr_schedule", "2", "--lr_mult", "0.5"] + list(extra),
        device="cpu")


def test_single_head_restart_equals_an_uninterrupted_run(tmp_path):
    """Epochs 1-3 in one run against epochs 1-2, then --restart for epoch
    3 (an lr step at 2 taken once): equal epoch losses, eval accuracies and
    weights, bit for bit."""
    full, cut = tmp_path / "full", tmp_path / "cut"
    net_full, h_full = _run(full, 4)
    _run(cut, 3)
    net_cut, h_cut = _run(cut, 4, ["--restart"])
    for key in ("epoch_loss_head_B", "epoch_loss_no_lamb_head_B"):
        assert len(h_cut[key]) == 3 and h_cut[key] == h_full[key], key
    assert h_cut["eval"].epoch_acc == h_full["eval"].epoch_acc
    assert len(h_cut["eval"].epoch_acc) == 4
    for k, v in net_full.state_dict().items():
        assert torch.equal(v, net_cut.state_dict()[k]), k
    saved = torch.load(cut / "0" / "latest.pytorch", weights_only=True)
    assert saved["optimiser"]["param_groups"][0]["lr"] == 0.0001 * 0.5
