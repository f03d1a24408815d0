"""The port's measurement tools (``iic_tpu_torch/tools/{joint_kernel_bench,
fused_loss_bench,eval_cost_bench,e2e_gap_trace}.py``) against the JAX
package's (``tools/*.py``, imported by file path) and ``bench.py``, on the
CPU at small sizes.

- joint bench: P and both input gradients of sum(P**2), conv and the
  kernel (its plain version on the CPU), against JAX's
  ``displacement_joint_dense`` (f32: rtol 1e-4) and
  ``displacement_joint_dense_pallas`` (interpret mode, bf16 operands: the
  JAX kernel contract, rtol 5e-3, atol 5e-3 * max), numpy-seeded inputs.
- fused-loss bench: the loss and its gradients, xla and fused, against
  JAX's ``IID_loss`` under ``vmap`` (K3's contract: values rtol = atol =
  1e-5, gradients rtol 1e-3, atol 1e-6); its inputs against the JAX
  tool's draws; the full step's config against the JAX tool's
  ``SimpleNamespace``, captured by replacing the pipeline it builds.
- eval bench: both configs against the JAX tool's (captured by replacing
  the function that builds its net, before anything heavy runs); then
  both tools whole on one small synthetic set with the same weights (flax
  variables carried to the port by ``compat/flax_bridge.py``): the same
  JSON keys and ``best_acc_sanity``.
- gap trace: its config copy against ``bench._config()``; on the CPU its
  separately timed parts tile the wall with one wait a batch, and a
  producer slowed
  by a sleep shows up in wait_data and in the producer's prep times.
- Each tool imports no jax, no iic_tpu, no bench.py and nothing of tools/;
  its helpers run on cuda:0 unless given a device; ``--device`` is taken
  out of a positional argv by ``device.pop_device``.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import numpy as np
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.ops.iid_loss import IID_loss as jax_iid_loss
from iic_tpu.ops.iid_seg_loss import displacement_joint_dense as jax_dense
from iic_tpu.ops.pallas import displacement_joint_dense_pallas
from iic_tpu.train import cluster_trainer as jax_cluster_trainer
from iic_tpu.train import config as jax_config
from iic_tpu.train import seg_trainer as jax_seg_trainer
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import load_cluster_net, load_seg_net
from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
from iic_tpu_torch.device import pop_device
from iic_tpu_torch.tools import e2e_gap_trace as gap
from iic_tpu_torch.tools import eval_cost_bench as ecb
from iic_tpu_torch.tools import fused_loss_bench as flb
from iic_tpu_torch.tools import joint_kernel_bench as jkb

from test_torch_cluster_models import random_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("joint_kernel_bench", "fused_loss_bench", "eval_cost_bench",
         "e2e_gap_trace")


def _by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jflb = _by_path("jax_fused_loss_bench",
                os.path.join(REPO, "tools", "fused_loss_bench.py"))
jecb = _by_path("jax_eval_cost_bench",
                os.path.join(REPO, "tools", "eval_cost_bench.py"))
bench = _by_path("root_bench", os.path.join(REPO, "bench.py"))


class _Captured(Exception):
    """Raised by a stand-in to hand back what the JAX tool built."""


def _capture(*args):
    raise _Captured(*args)


# ------------------------------------------------------------- joint bench

JOINT_SIZE = (2, 3, 16, 2)  # n, k, h, half_t


def _maps(rng, n, k, h):
    z = rng.standard_normal((n, k, h, h)).astype(np.float32)
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("impl,jax_fn,rtol,atol_rel", [
    ("conv", jax_dense, 1e-4, 1e-6),
    ("pallas", displacement_joint_dense_pallas, 5e-3, 5e-3)])
def test_joint_bench_outputs_match_jax(impl, jax_fn, rtol, atol_rel):
    """P, dx1, dx2 of the tool's implementation against the JAX tool's
    (its ``fwd`` and ``jax.grad`` of sum(P**2)); the JAX Pallas kernel
    runs in interpret mode with bf16 operands, so it is held at its own
    contract."""
    n, k, h, half_t = JOINT_SIZE
    rng = np.random.default_rng(5)
    x1, x2 = _maps(rng, n, k, h), _maps(rng, n, k, h)
    p_ref = np.asarray(jax_fn(jnp.asarray(x1), jnp.asarray(x2), half_t))
    g_ref = jax.grad(lambda a, b: jnp.sum(jax_fn(a, b, half_t) ** 2),
                     argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    got = jkb.outputs(jkb.IMPLS[impl], torch.from_numpy(x1),
                      torch.from_numpy(x2), half_t)
    for g, r in zip(got, (p_ref, *map(np.asarray, g_ref))):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=atol_rel * np.abs(r).max())


def test_joint_bench_main_on_cpu(capsys):
    """The tool whole on the CPU: the device line, fft reported as not
    ported (no exception), both ported records finite and within 1e-6 of
    the float64 conv (the kernel's plain version is the f32 conv here),
    and the kernel's distance from its bf16 function that of bf16
    rounding (above 1e-4, below 1e-2)."""
    records = jkb.main([*map(str, JOINT_SIZE), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("device: cpu")
    assert "fft      not ported" in out
    by_name = {r["name"]: r for r in records}
    assert list(by_name) == list(jkb.IMPLS)
    assert by_name["fft"] == {"name": "fft", "ported": False}
    for name in ("pallas", "conv"):
        rec = by_name[name]
        assert np.isfinite([rec["fwd_ms"], rec["grad_ms"]]).all()
        assert rec["err"] < 1e-6
    assert 1e-4 < by_name["pallas"]["err_bf16_f64"] < 1e-2
    assert by_name["pallas"]["form"] == "cuda-core"  # k=3


# -------------------------------------------------------- fused-loss bench

LOSS_SIZE = (40, 5, 2)  # bn, k, sub


def test_fused_loss_inputs_are_the_jax_tools():
    """``loss_inputs``: the JAX tool's softmax of its numpy draws."""
    bn, k, sub = LOSS_SIZE
    rng = np.random.default_rng(0)
    ref = [np.asarray(jax.nn.softmax(jnp.asarray(
        rng.normal(size=(sub, bn, k)).astype(np.float32)), -1))
        for _ in range(2)]
    got = flb.loss_inputs(bn, k, sub, "cpu")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl,jax_impl", [("xla", "xla"),
                                           ("fused", "pallas")])
def test_fused_loss_bench_matches_jax(impl, jax_impl):
    """The tool's loss and gradients against the JAX tool's
    ``value_and_grad`` of the vmapped loss's mean (its Pallas kernel in
    interpret mode)."""
    z, zt = flb.loss_inputs(*LOSS_SIZE, "cpu")

    def f(a, b):
        losses, _ = jax.vmap(lambda x, y: jax_iid_loss(
            x, y, lamb=1.0, impl=jax_impl))(a, b)
        return losses.mean()
    with pltpu.force_tpu_interpret_mode():
        val, grads = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(z.numpy()), jnp.asarray(zt.numpy()))
    loss, got = flb.loss_and_grads(impl, z, zt)
    np.testing.assert_allclose(float(loss), float(val), rtol=1e-5,
                               atol=1e-5)
    for g, r in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-6)


def test_fused_loss_loss_only_on_cpu(capsys):
    """``loss_only`` on the CPU: both impls' losses equal within K3's
    contract, and the device time reported as not measured."""
    out = flb.loss_only(*LOSS_SIZE, "cpu")
    assert abs(out["fused"]["loss"] - out["xla"]["loss"]) <= 1e-5
    assert all(out[i]["device_ms"] is None for i in flb.IMPLS)
    assert capsys.readouterr().out.count("device ms not measured") == 2


@pytest.mark.parametrize("batch,k,sub", [(700, 10, 5), (20, 7, 2)])
def test_full_step_config_matches_jax_tool(monkeypatch, batch, k, sub):
    """``full_step_config`` against the ``SimpleNamespace`` the JAX tool's
    ``full_step`` hands its pipeline, field for field."""
    monkeypatch.setattr(jflb, "ClusterTrainPipeline", _capture)
    with pytest.raises(_Captured) as exc:
        jflb.full_step(batch, k, sub)
    assert vars(exc.value.args[0]) == vars(flb.full_step_config(batch, k,
                                                                sub))


@pytest.mark.parametrize("fn", [flb.loss_inputs, flb.loss_only,
                                flb.full_step])
def test_fused_loss_helpers_default_to_the_card(monkeypatch, fn):
    """Given no device, each measurement helper asks for cuda:0, so with
    no GPU it raises before it measures anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found no GPU"):
        fn()


def test_full_step_runs_on_cpu(capsys):
    """The full step at a small batch: finite times and losses for both
    impls, printed on the JAX tool's lines."""
    out = flb.full_step(batch=20, device="cpu", iters=2)
    for impl in flb.IMPLS:
        assert np.isfinite([out[impl]["ms"], out[impl]["loss"]]).all()
    assert capsys.readouterr().out.count("full train step (MNIST") == 2


# -------------------------------------------------------------- eval bench

EVAL_SMALL = {"cluster": {"dataset": "Synthetic10x96x3x48", "batch_sz": 16},
              "seg": {"dataset": "SyntheticSeg3x32x12", "batch_sz": 4,
                      "input_sz": 32}}


def _jax_eval_config(monkeypatch, which):
    """The config the JAX tool's eval builds, taken from the first
    function it calls, the one that builds its net."""
    if which == "cluster":
        monkeypatch.setattr(jax_cluster_trainer, "build_net_and_state",
                            _capture)
        run = jecb.cluster_eval_cost
    else:
        monkeypatch.setattr(jax_seg_trainer, "build_seg_net_and_state",
                            _capture)
        run = jecb.seg_eval_cost
    with pytest.raises(_Captured) as exc:
        run()
    return exc.value.args[0]


@pytest.mark.parametrize("which", ["cluster", "seg"])
def test_eval_configs_match_jax_tool(monkeypatch, which):
    jcfg = _jax_eval_config(monkeypatch, which)
    cfg = ecb.cluster_config() if which == "cluster" else ecb.seg_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("which", ["cluster", "seg"])
def test_eval_bench_matches_jax_tool(monkeypatch, capsys, which):
    """Both tools whole on one small synthetic set (the configs shrunk in
    data and batch only) with the same random weights: the JAX tool's
    net-building function hands back flax variables from a numpy seed, the
    port's ``build_net`` the port's net filled from them. The printed JSON keys
    equal, and ``best_acc_sanity`` equal (the same argmax predictions:
    head B's outputs are spread by its N(0, 1) kernels, no near ties)."""
    small = EVAL_SMALL[which]
    jcfg = dataclasses.replace(_jax_eval_config(monkeypatch, which), **small)
    jnet = jmodels.build(jcfg.arch, jcfg)
    variables = random_flax_variables(jnet, jcfg.in_channels, seed=3,
                                      head_std=1.0, sz=jcfg.input_sz)
    state = SimpleNamespace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    load = load_cluster_net if which == "cluster" else load_seg_net
    monkeypatch.setattr(ecb, "build_net", lambda cfg, device: load(
        variables, tmodels.build(cfg.arch, cfg)))
    # the JAX tool builds its config itself: shrink it where it finalizes
    name = "ClusterConfig" if which == "cluster" else "SegConfig"
    base = getattr(jax_config, name)

    class Small(base):
        def finalize(self, *a, **kw):
            for key, v in small.items():
                setattr(self, key, v)
            return base.finalize(self, *a, **kw)

    monkeypatch.setattr(jax_config, name, Small)
    if which == "cluster":
        monkeypatch.setattr(jax_cluster_trainer, "build_net_and_state",
                            lambda cfg: (jnet, None, state))
        ref = jecb.cluster_eval_cost()
        cfg = dataclasses.replace(ecb.cluster_config(), **small)
        got = ecb.cluster_eval_cost("cpu", cfg)
    else:
        monkeypatch.setattr(jax_seg_trainer, "build_seg_net_and_state",
                            lambda cfg: (jnet, None, state))
        ref = jecb.seg_eval_cost()
        cfg = dataclasses.replace(ecb.seg_config(), **small)
        got = ecb.seg_eval_cost("cpu", cfg)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == [ref, got]
    assert list(got) == list(ref)
    assert got["measurement"] == ref["measurement"]
    assert got["best_acc_sanity"] == ref["best_acc_sanity"]


# --------------------------------------------------------------- gap trace

def test_gap_trace_config_is_bench_config():
    assert vars(gap.bench_config()) == vars(bench._config())
    assert (gap.BATCH_SZ, gap.INPUT_SZ, gap.RAW_SZ, gap.HEADS, gap.LAMBS) \
        == (bench.BATCH_SZ, bench.INPUT_SZ, bench.RAW_SZ, bench.HEADS,
            bench.LAMBS)


def _small_gap_config():
    cfg = gap.bench_config()
    cfg.dataset = "SyntheticSeg3x40x8"
    cfg.batch_sz = cfg.dataloader_batch_sz = 4
    cfg.input_sz, cfg.half_T_side_dense = 32, 2
    return cfg


def _check_split(rec, batches):
    parts = rec["wait_data"] + rec["dispatch"] + rec["fetch"] + rec["other"]
    assert parts == pytest.approx(rec["wall"], rel=1e-9, abs=1e-12)
    assert len(rec["waits"]) == len(rec["prep"]) == len(rec["upload"]) \
        == batches
    assert rec["n_pairs"] == 4 * batches
    assert rec["wait_data"] == pytest.approx(sum(rec["waits"]))


def test_gap_trace_split_adds_up_on_cpu(tmp_path, capsys):
    """``main`` at a small config on the CPU (one pass, one rep, a
    profiled run): each run's wait_data + dispatch + fetch + other equals
    its wall (each part is timed on its own intervals, so this holds when
    they tile the run: none dropped, none counted twice), with one wait,
    one host prep and one upload a batch; the trace is written; the
    printed lines name the prep that ran."""
    out = gap.main(["--passes", "1", "--reps", "1", "--device", "cpu",
                    "--profile_dir", str(tmp_path)], cfg=_small_gap_config())
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("device: cpu")
    (rec,) = out["runs"]
    _check_split(rec, batches=2)  # one pass of 8 images in batches of 4
    assert "producer: host prep SegTrainPipeline._" in text
    assert "  producer prep (_" in text
    assert "depth=2: wall" in text and "continuous depth=2" in text
    assert (tmp_path / "gap_trace.json").stat().st_size > 0
    (cont,) = out["continuous"]
    assert len(cont["waits"]) == 2 and cont["n_pairs"] == 8
    assert set(out["device_step_only"]) == {"A", "B", "mix"}


SLEEP_S = 0.4


def test_gap_trace_slow_producer_shows_in_wait_data(monkeypatch):
    """A host prep slowed by a sleep: each producer prep time holds the
    sleep, and the consumer's wait for the first batch, which no step
    overlaps, holds it too, in its wait_data, over the same run with the
    plain prep (depth 1, two passes). The later waits are the sleep less
    the consumer's step, which a loaded host makes as long as the sleep,
    so they bound nothing; nor does the plain prep's time, which a loaded
    host stretches to tens of ms."""
    trace = gap.GapTrace(_small_gap_config(), "cpu")
    fast = trace.run(0, 2, depth=1)
    for name in ("_native_batch", "_numpy_batch"):
        orig = getattr(SegTrainPipeline, name)

        def slow(self, *a, orig=orig, **kw):
            time.sleep(SLEEP_S)
            return orig(self, *a, **kw)
        monkeypatch.setattr(SegTrainPipeline, name, slow)
    trace = gap.GapTrace(_small_gap_config(), "cpu")
    rec = trace.run(0, 2, depth=1)
    for r in (fast, rec):
        _check_split(r, batches=4)
    assert min(rec["prep"]) >= SLEEP_S
    # the consumer waits from before the first sleep starts; a loaded host
    # may delay it a little, and the plain run's waits are the host's noise
    assert rec["waits"][0] >= 0.75 * SLEEP_S
    assert rec["wait_data"] - fast["wait_data"] >= 0.5 * SLEEP_S


# ----------------------------------------------------------------- imports

@pytest.mark.parametrize("argv,rest,device", [
    ([], [], None),
    (["seg"], ["seg"], None),
    (["--device", "cpu"], [], "cpu"),
    (["2", "3", "--device", "cuda:1", "16", "2"], ["2", "3", "16", "2"],
     "cuda:1")])
def test_pop_device(argv, rest, device):
    assert pop_device(argv) == (rest, device)
    with pytest.raises(ValueError, match="needs a value"):
        pop_device(rest + ["--device"])


# Modules each tool imports only inside its functions
LAZY = {"joint_kernel_bench": (),
        "fused_loss_bench": ("iic_tpu_torch.data.pipeline",
                             "torch.profiler"),
        "eval_cost_bench": ("iic_tpu_torch.data.pipeline",
                            "iic_tpu_torch.evals.cluster_eval",
                            "iic_tpu_torch.data.seg_pipeline",
                            "iic_tpu_torch.evals.segmentation_eval"),
        "e2e_gap_trace": ("torch.profiler",)}


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_no_jax(tool):
    """Importing the tool, and every module its source imports anywhere
    (found by walking its syntax tree, so the imports inside its
    functions too), loads no jax, flax, optax, iic_tpu, root bench.py or
    module of tools/."""
    code = (
        "import ast, importlib, os, sys\n"
        f"mod = importlib.import_module('iic_tpu_torch.tools.{tool}')\n"
        "tree = ast.parse(open(mod.__file__).read())\n"
        "names = sorted({a.name for n in ast.walk(tree)\n"
        "                if isinstance(n, ast.Import) for a in n.names}\n"
        "               | {n.module for n in ast.walk(tree)\n"
        "                  if isinstance(n, ast.ImportFrom)\n"
        "                  and n.level == 0})\n"
        "for m in names:\n"
        "    importlib.import_module(m)\n"
        "tools = os.path.join(os.getcwd(), 'tools')\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'iic_tpu', 'bench')\n"
        "       if m in sys.modules]\n"
        "bad += [n for n, m in list(sys.modules.items())\n"
        "        if (getattr(m, '__file__', None) or '').startswith(tools)]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert set(LAZY[tool]) <= set(out.stdout.split())
