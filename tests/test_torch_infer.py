"""The port's serving path (``iic_tpu_torch/infer.py``,
``cli/export_model.py``) against the JAX package's (``iic_tpu/infer.py``).

A fake run is written in each package, as tests/test_infer.py writes the
JAX one: the same random flax variables (from a numpy seed; carried into
the port by ``compat/flax_bridge.py``), the same eval history, no
training. The predictors get the same raw uint8 images.

Tolerances: in f32 the port's ids equal JAX's on every row; the test
asserts that no row of these inputs has a JAX top-2 probability gap
under 1e-5 but the exact ties of the segmentation heads' uniform ring.
In bf16 the JAX side runs without XLA's excess precision (``_nominal``, as in
tests/test_torch_bf16.py) and the ids are compared on the rows whose JAX
top-2 gap is at least twice ``SEG_FWD``'s eval-mode max |d| (4.5e-3 per
probability), the bf16 bound of that file; those rows must be most of
them. The exported artifact is held to the eager predictor bit for bit,
at batches 1, 3 and 7, in a process that imports ``torch`` alone.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu import infer as jinfer
from iic_tpu import models as jmodels
from iic_tpu.evals.cluster_eval import EvalHistory as JaxEvalHistory
from iic_tpu.parallel import create_train_state
from iic_tpu.train import checkpoint as jckpt
from iic_tpu.train.cluster_trainer import make_optimizer as jax_optimizer
from iic_tpu.train.config import ClusterConfig, SegConfig
from iic_tpu_torch import infer
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import load_cluster_net, load_seg_net
from iic_tpu_torch.evals.cluster_eval import EvalHistory
from iic_tpu_torch.parallel.train_step import make_optimizer
from iic_tpu_torch.train import checkpoint as tckpt
from iic_tpu_torch.train.config import config_from_dict
from test_torch_bf16 import SEG_FWD, _nominal
from test_torch_cluster_models import random_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAP_F32 = 1e-5
GAP_BF16 = 2 * SEG_FWD[False][1]
MATCHES = {4: [(i, (i + 1) % 4) for i in range(4)],
           3: [(0, 2), (1, 0), (2, 1)]}
# (epoch_acc, best sub-head per epoch): epoch 1 is the best
ACCS, SUB_HEADS = [0.3, 0.6, 0.5], [0, 1, 0]

# kind -> (config class, fields, finalize kwargs)
KINDS = {
    "cluster_sobel": (ClusterConfig, dict(
        arch="ClusterNet6cTwoHead", dataset="Synthetic4x24x3", gt_k=4,
        output_k_A=8, output_k_B=4, crop_orig=True, rand_crop_sz=18,
        input_sz=20, include_rgb=True), dict(twohead=True, sobel=True)),
    "cluster_grey": (ClusterConfig, dict(
        arch="ClusterNet6cTwoHead", dataset="Synthetic4x24x1", gt_k=4,
        output_k_A=8, output_k_B=4, crop_orig=True, crop_other=True,
        tf1_crop="centre", tf1_crop_sz=18, input_sz=20),
        dict(twohead=True, sobel=False)),
    "seg_sobel_rgb": (SegConfig, dict(
        arch="SegmentationNet10aTwoHead", dataset="SyntheticSeg3x48x16",
        gt_k=3, output_k_A=6, output_k_B=3, input_sz=24, include_rgb=True),
        dict(twohead=True)),
    "seg_rgb_ir": (SegConfig, dict(
        arch="SegmentationNet10aTwoHead",
        dataset="SyntheticSegPotsdam3x48x16", gt_k=3, output_k_A=6,
        output_k_B=3, input_sz=24, include_rgb=True, no_sobel=True),
        dict(twohead=True)),
    "seg_sobel_rgb_ir": (SegConfig, dict(
        arch="SegmentationNet10aTwoHead",
        dataset="SyntheticSegPotsdam3x48x16", gt_k=3, output_k_A=6,
        output_k_B=3, input_sz=24, include_rgb=True), dict(twohead=True)),
}
RAW = {"cluster_sobel": (24, 3), "cluster_grey": (24, 1),
       "seg_sobel_rgb": (24, 3), "seg_rgb_ir": (24, 4),
       "seg_sobel_rgb_ir": (24, 4)}


def _jax_config(kind, out_root, model_ind, track=True, dtype="float32"):
    cls, fields, fin = KINDS[kind]
    cfg = cls(model_ind=model_ind, mode="IID", num_sub_heads=2,
              out_root=out_root, batchnorm_track=track, model_dtype=dtype,
              **fields)
    cfg.finalize(**fin)
    return cfg


def _eval_history(cls, gt_k):
    ev = cls()
    ev.epoch_acc = list(ACCS)
    ev.epoch_avg_subhead_acc = list(ACCS)
    ev.epoch_stats = [{"best_train_sub_head": s,
                       "best_train_sub_head_match": MATCHES[gt_k]}
                      for s in SUB_HEADS]
    return ev


def write_runs(tmp_path, kind, model_ind=7, track=True, dtype="float32",
               names=("best", "latest"), last_epoch=2, seed=0):
    """The same fake run in both packages: (JAX out_root, port out_root).
    The JAX variables are random (numpy ``seed``), their BN statistics
    calibrated on images like the tests'."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = _jax_config(kind, jroot, model_ind, track, dtype)
    jnet = jmodels.build(jcfg.arch, jcfg)
    variables = _calibrated(jcfg, jnet, random_flax_variables(
        jnet, jcfg.in_channels, seed=seed, head_std=0.1, sz=jcfg.input_sz),
        _images(kind, 16, seed=99))
    state = create_train_state(
        jax.tree_util.tree_map(jnp.asarray, variables), jax_optimizer(jcfg))
    tcfg = config_from_dict({**dataclasses.asdict(jcfg), "out_root": troot})
    tnet = tmodels.build(tcfg.arch, tcfg)
    (load_seg_net if "Segmentation" in tcfg.arch else load_cluster_net)(
        variables, tnet)
    for name in names:
        jckpt.save_checkpoint(
            jcfg, state, {"eval": _eval_history(JaxEvalHistory, jcfg.gt_k)},
            name, last_epoch=last_epoch)
        tckpt.save_checkpoint(
            tcfg, tnet, make_optimizer(tnet, tcfg),
            {"eval": _eval_history(EvalHistory, tcfg.gt_k)}, name,
            last_epoch=last_epoch)
    return jroot, troot


def _images(kind, b, seed=0):
    """Blocks of 6 x 6 pixels of random levels, with noise: images that
    differ in more than their noise, so the predictions spread."""
    sz, c = RAW[kind]
    rng = np.random.default_rng(seed)
    blocks = rng.uniform(0, 255, (b, sz // 6, sz // 6, c))
    imgs = np.repeat(np.repeat(blocks, 6, axis=1), 6, axis=2)
    imgs += rng.normal(0, 20, imgs.shape)
    return np.clip(imgs, 0, 255).astype(np.uint8)


def _jax_inputs(config, u8):
    """The JAX predictor's preprocessing: uint8 images -> the net's NCHW
    input."""
    from iic_tpu.data.pipeline import _is_greyscale
    from iic_tpu.data.transforms import (
        append_grey, make_greyscale_pair_transforms,
        make_sobel_pair_transforms, to_grey)
    from iic_tpu.ops.sobel import sobel_process

    imgs = u8.astype(jnp.float32) / 255.0
    if "Segmentation" not in config.arch:
        make = (make_greyscale_pair_transforms if _is_greyscale(config)
                else make_sobel_pair_transforms)
        x = jnp.transpose(jax.vmap(make(config)[2])(imgs), (0, 3, 1, 2))
        return sobel_process(x, config.include_rgb) if config.sobel else x
    rgb, ir = ((imgs[..., :3], imgs[..., 3:4]) if config.using_IR
               else (imgs, None))
    if config.sobel:
        out = jax.vmap(lambda im: append_grey(im, config.include_rgb))(rgb)
    elif not config.include_rgb:
        out = jax.vmap(to_grey)(rgb)
    else:
        out = rgb
    if ir is not None:
        out = jnp.concatenate([out, ir], axis=-1)
    x = jnp.transpose(out, (0, 3, 1, 2))
    if config.sobel:
        x = sobel_process(x, config.include_rgb, using_IR=config.using_IR)
    return x


def _calibrated(config, net, variables, imgs_u8, steps=40):
    """``variables`` with running statistics near the batch statistics of
    ``imgs_u8`` (train-mode forwards at flax's momentum 0.9), as a trained
    net's are: random statistics leave one class ahead on every image."""
    head_kw = {"head": "B"} if config.twohead else {}
    x = _jax_inputs(config, jnp.asarray(imgs_u8))

    @jax.jit
    def step(v):
        if "batch_stats" not in v:
            return v
        _, upd = net.apply(v, x, train=True, mutable=["batch_stats"],
                           **head_kw)
        return {**v, "batch_stats": upd["batch_stats"]}

    v = jax.tree_util.tree_map(jnp.asarray, variables)
    for _ in range(steps):
        v = step(v)
    v = jax.device_get(v)
    if "Segmentation" not in config.arch:
        # the dense head B's biases centre each class's mean log
        # probability over the images, so that no class leads on all
        logp = np.log(np.asarray(net.apply(v, x, train=False, **head_kw)))
        v["params"]["head_B"]["bias"] = (v["params"]["head_B"]["bias"]
                                         - logp.mean(axis=1))
    return v


def _jax_probs(config, net, variables, stats, imgs_u8):
    """The JAX predictor's steps up to the best sub-head's probabilities,
    (b, k) or (b, k, sz, sz), without XLA's excess precision."""
    variables = jinfer._clean_variables(variables)
    head_kw = {"head": "B"} if config.twohead else {}

    def probs(v, u8):
        return net.apply(v, _jax_inputs(config, u8), train=False,
                         **head_kw)[stats["best_train_sub_head"]]
    return np.asarray(_nominal(probs, variables, jnp.asarray(imgs_u8)))


def _top2_gap(probs, class_axis):
    top2 = -np.sort(-np.moveaxis(probs, class_axis, -1), axis=-1)[..., :2]
    return top2[..., 0] - top2[..., 1]


def _predict_both(tmp_path, kind, track=True, dtype="float32", b=6):
    jroot, troot = write_runs(tmp_path, kind, track=track, dtype=dtype)
    jconfig, jnet, jvars, jstats = jinfer.load_run(jroot, 7)
    config, net, stats = infer.load_run(troot, 7, device="cpu")
    assert stats == jstats
    imgs = _images(kind, b)
    with torch.no_grad():
        ids = infer.make_predictor(config, net, stats)(
            torch.from_numpy(imgs)).numpy()
    probs = _jax_probs(jconfig, jnet, jvars, jstats, imgs)
    class_axis = 1
    table = np.asarray(jinfer._match_table(
        jstats["best_train_sub_head_match"], jconfig.output_k))
    want = table[probs.argmax(axis=class_axis)]
    if dtype == "float32":
        predict = (jinfer.make_seg_predictor if "Segmentation" in
                   jconfig.arch else jinfer.make_cluster_predictor)
        jids = np.asarray(jax.jit(predict(jconfig, jnet, jvars, jstats))(
            jnp.asarray(imgs)))
        np.testing.assert_array_equal(jids, want)
    return ids, want, _top2_gap(probs, class_axis)


@pytest.mark.parametrize("kind,track", [
    ("cluster_sobel", True), ("cluster_grey", True),
    ("cluster_sobel", False), ("seg_sobel_rgb", True),
    ("seg_rgb_ir", True), ("seg_sobel_rgb_ir", True),
    ("seg_sobel_rgb", False)])
def test_predictor_ids_equal_jax(tmp_path, kind, track):
    """f32: every id equal to JAX's, and no row near a tie at this size;
    ``track=False`` runs BN on the batch's statistics in both. The
    segmentation heads' zero-logit ring (their 1x1 conv's padding) gives
    pixels an exactly uniform softmax, a gap of 0, where both packages
    take the first class: those are ties, not near ties."""
    ids, want, gap = _predict_both(tmp_path, kind, track=track)
    assert ids.dtype == np.int32 and ids.shape == want.shape
    near = (gap > 0) & (gap < GAP_F32)
    assert not near.any(), gap[near]
    np.testing.assert_array_equal(ids, want)
    assert len(np.unique(ids)) > 1  # the test sees more than one class


@pytest.mark.parametrize("kind", ["cluster_sobel", "seg_sobel_rgb"])
def test_predictor_bf16_matches_jax_bf16(tmp_path, kind):
    ids, want, gap = _predict_both(tmp_path, kind, dtype="bfloat16", b=8)
    clear = gap >= GAP_BF16
    assert clear.mean() > 0.8, clear.mean()
    np.testing.assert_array_equal(ids[clear], want[clear])


def test_latest_fallback_takes_the_weights_own_epoch(tmp_path):
    """No best.pytorch: latest, with epoch last_epoch's stats (the JAX
    rule: min(last_epoch, len(epoch_stats) - 1)), in both packages; with
    best, the best epoch's."""
    jroot, troot = write_runs(tmp_path, "cluster_grey", names=("latest",),
                              last_epoch=2)
    _, _, _, jstats = jinfer.load_run(jroot, 7)
    _, _, stats = infer.load_run(troot, 7, device="cpu")
    assert stats == jstats
    assert stats["best_train_sub_head"] == SUB_HEADS[2]
    _, _, best = infer.load_run(troot, 7, name="latest", device="cpu")
    assert best["best_train_sub_head"] == SUB_HEADS[2]
    jroot, troot = write_runs(tmp_path / "b", "cluster_grey", last_epoch=2)
    _, _, stats = infer.load_run(troot, 7, device="cpu")
    assert stats["best_train_sub_head"] == SUB_HEADS[int(np.argmax(ACCS))]
    assert stats == jinfer.load_run(jroot, 7)[3]


def test_moved_run_directory(tmp_path):
    """The run is read from where the caller found it: config.out_root
    follows, and the old location is not read."""
    _, troot = write_runs(tmp_path, "cluster_grey")
    moved = str(tmp_path / "moved")
    shutil.copytree(troot, moved)
    shutil.rmtree(troot)
    config, net, stats = infer.load_run(moved, 7, device="cpu")
    assert config.out_root == moved
    assert stats["best_train_sub_head"] == 1


def test_empty_eval_history_raises(tmp_path):
    _, troot = write_runs(tmp_path, "cluster_grey")
    tcfg = config_from_dict(tckpt.read_meta(troot, 7)["config"])
    tckpt.save_meta(tcfg, {"eval": EvalHistory()}, 0)
    with pytest.raises(ValueError, match="no eval history"):
        infer.load_run(troot, 7, device="cpu")


def test_load_run_needs_a_gpu_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, troot = write_runs(tmp_path, "cluster_grey")
    with pytest.raises(RuntimeError, match="no GPU"):
        infer.load_run(troot, 7)


CHILD = r"""
import sys
import torch
assert "iic_tpu_torch" not in sys.modules
program = torch.export.load(sys.argv[1]).module()
inputs = torch.load(sys.argv[2])
outs = [program(x) for x in inputs]
assert "iic_tpu_torch" not in sys.modules
torch.save(outs, sys.argv[3])
"""


def serve_in_child(path, inputs, tmp_path):
    """Run the artifact at ``path`` on ``inputs`` in a process that
    imports torch alone (it asserts the port is not loaded); returns the
    outputs."""
    in_path, out_path = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save(inputs, in_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", CHILD, str(path),
                          str(in_path), str(out_path)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return torch.load(out_path)


@pytest.mark.parametrize("kind,track", [
    ("cluster_sobel", True), ("cluster_grey", False),
    ("seg_sobel_rgb", True), ("seg_rgb_ir", False)])
def test_export_round_trip_bit_for_bit(tmp_path, kind, track):
    """Traced at batch 2 with a symbolic batch, served at 1, 3 and 7 by
    torch alone: the eager ids, bit for bit."""
    _, troot = write_runs(tmp_path, kind, track=track)
    config, net, stats = infer.load_run(troot, 7, device="cpu")
    predict = infer.make_predictor(config, net, stats)
    path = tmp_path / "model.pt2"
    data = infer.export_predictor(predict, _images(kind, 1), path=path)
    assert os.path.getsize(path) == len(data) > 0
    inputs = [torch.from_numpy(_images(kind, b, seed=b)) for b in (1, 3, 7)]
    with torch.no_grad():
        eager = [predict(x) for x in inputs]
    for got, want in zip(serve_in_child(path, inputs, tmp_path), eager):
        assert got.dtype == torch.int32
        assert torch.equal(got, want)
    served = infer.load_exported(data, device="cpu")
    assert torch.equal(served(inputs[2]), eager[2])


def test_export_fixed_batch(tmp_path):
    _, troot = write_runs(tmp_path, "cluster_grey")
    config, net, stats = infer.load_run(troot, 7, device="cpu")
    predict = infer.make_predictor(config, net, stats)
    data = infer.export_predictor(predict, _images("cluster_grey", 4),
                                  symbolic_batch=False)
    served = infer.load_exported(data, device="cpu")
    x = torch.from_numpy(_images("cluster_grey", 4, seed=5))
    with torch.no_grad():
        assert torch.equal(served(x), predict(x))
    with pytest.raises(Exception):
        served(torch.from_numpy(_images("cluster_grey", 3)))


def test_export_cli(tmp_path, capsys):
    from iic_tpu_torch.cli import export_model

    _, troot = write_runs(tmp_path, "cluster_grey")
    dest = str(tmp_path / "m.pt2")
    export_model.main(["--out_root", troot, "--model_ind", "7", "--dest",
                       dest, "--raw_sz", "24", "--raw_channels", "1"],
                      device="cpu")
    assert "exported cluster predictor (input (b, 24, 24, 1) uint8)" in \
        capsys.readouterr().out
    served = infer.load_exported(dest, device="cpu")
    config, net, stats = infer.load_run(troot, 7, device="cpu")
    x = torch.from_numpy(_images("cluster_grey", 3))
    with torch.no_grad():
        assert torch.equal(served(x),
                           infer.make_predictor(config, net, stats)(x))


def test_match_table_equals_jax():
    for k, match in MATCHES.items():
        np.testing.assert_array_equal(
            infer._match_table(match, k).numpy(),
            np.asarray(jinfer._match_table(match, k)))
