"""The port's learning-evidence tool
(``iic_tpu_torch/tools/learning_evidence.py``) against the JAX package's
(``tools/tpu_learning_evidence.py``, imported by file path), on the CPU.

Configs: JAX's trainers (``train_cluster_twohead``, ``train_cluster_single``,
``train_semisup``, ``build_net_and_state``) and checkpoint writer are
replaced by recorders that return stand-in histories, which works because
the JAX tool imports them inside each experiment; the port's run functions
are recorded the same way. Each experiment must hand its trainers JAX's
configs, field for field, and print a JSON line with JAX's keys. Then each
experiment runs for real, shrunk through its config functions, with
``device="cpu"``. The digits baselines: the port's PCA-32 is held to
scikit-learn's exact PCA (the JAX call's default solver at this shape is
the randomized one), and its k-means to scikit-learn's inertia within 1.01x,
a bound that a fit stopped after one Lloyd iteration must fail."""

import dataclasses
import importlib.util
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import iic_tpu.train as jax_train
from iic_tpu.train import checkpoint as jax_ckpt
from iic_tpu.train import cluster_trainer as jax_cluster_trainer
from iic_tpu.train import semisup_trainer as jax_semisup_trainer
from iic_tpu_torch.evals.kmeans_eval import KMeans
from iic_tpu_torch.tools import learning_evidence as le

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools",
                     "tpu_learning_evidence.py")
_spec = importlib.util.spec_from_file_location("tpu_learning_evidence",
                                               _TOOL)
jle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jle)

INERTIA_RATIO = 1.01  # the bound tests/test_torch_kmeans_sift.py holds
PCA_RTOL = 1e-5


def _stand_in_cluster_history():
    return {"eval": SimpleNamespace(epoch_acc=[0.1, 0.3, 0.2])}


def _stand_in_semisup_history():
    return {"epoch_acc": [0.1, 0.4], "epoch_loss": [2.0, 1.5]}


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _keys(result):
    """The result's keys, a nested dict's as (key, its keys)."""
    return sorted((k, tuple(sorted(v))) if isinstance(v, dict) else (k, ())
                  for k, v in result.items())


@pytest.fixture
def jax_calls(monkeypatch, tmp_path):
    """Runs JAX's twohead, semisup and nuisance experiments against
    recorders: returns {experiment: ([(trainer, config)...], JSON result)}."""
    calls = []

    def record(name, result):
        def fn(config, *args, **kw):
            calls.append((name, config))
            return result()
        return fn

    monkeypatch.setattr(jle, "OUT", str(tmp_path))
    monkeypatch.setattr(jax_train, "train_cluster_twohead", record(
        "twohead", lambda: (None, _stand_in_cluster_history())))
    monkeypatch.setattr(jax_train, "train_cluster_single", record(
        "single", lambda: (None, _stand_in_cluster_history())))
    monkeypatch.setattr(jax_semisup_trainer, "train_semisup", record(
        "semisup", lambda: (None, _stand_in_semisup_history())))
    monkeypatch.setattr(jax_cluster_trainer, "build_net_and_state", record(
        "random_trunk", lambda: (None, None, None)))
    monkeypatch.setattr(jax_ckpt, "save_checkpoint",
                        lambda *a, **kw: calls.append(("save", a[0])))
    runs = {}
    for name, run in (("twohead", jle.run_twohead),
                      ("semisup", jle.run_semisup),
                      ("nuisance_probe", jle.run_nuisance_probe)):
        calls.clear()
        result = run()
        runs[name] = ([(n, c) for n, c in calls if n != "save"], result)
    return runs


@pytest.fixture
def port_calls(monkeypatch, tmp_path):
    """The same experiments of the port against the same recorders."""
    calls = []

    def record(name, result):
        def fn(config, *args, **kw):
            calls.append((name, config))
            return result()
        return fn

    monkeypatch.setattr(le, "train_cluster_twohead", record(
        "twohead", lambda: (None, _stand_in_cluster_history())))
    monkeypatch.setattr(le, "train_cluster_single", record(
        "single", lambda: (None, _stand_in_cluster_history())))
    monkeypatch.setattr(le, "train_semisup", record(
        "semisup", lambda: (None, _stand_in_semisup_history())))
    monkeypatch.setattr(le, "save_random_trunk", record(
        "random_trunk", lambda: None))
    runs = {}
    out = str(tmp_path)
    for name, run in (("twohead", le.run_twohead),
                      ("semisup", le.run_semisup),
                      ("nuisance_probe", le.run_nuisance_probe)):
        calls.clear()
        result = run(out, device="cpu")
        runs[name] = (list(calls), result)
    return runs


def test_configs_and_json_equal_jax(jax_calls, port_calls):
    for name in ("twohead", "semisup", "nuisance_probe"):
        (jcalls, jres), (tcalls, tres) = jax_calls[name], port_calls[name]
        assert [n for n, _ in tcalls] == [n for n, _ in jcalls], name
        for (n, tc), (_, jc) in zip(tcalls, jcalls):
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), (name,
                                                                     n)
        # equal stand-in histories: equal lines
        assert tres == jres, name
    assert [c.model_ind for _, c in port_calls["nuisance_probe"][0]] == \
        [930, 931, 932, 933]


def test_config_functions_are_what_the_runs_train(port_calls, tmp_path):
    out = str(tmp_path)
    assert port_calls["twohead"][0][0][1] == le.twohead_config(out)
    assert [c for _, c in port_calls["semisup"][0]] == \
        list(le.semisup_configs(out))
    cfgs = le.nuisance_configs(out)
    assert [c for _, c in port_calls["nuisance_probe"][0]] == [
        cfgs["iic"], cfgs["random"], cfgs["finetune"]["iic"],
        cfgs["finetune"]["random"]]


def _shrunk_cluster(cfg, **kw):
    twohead, sobel = cfg.twohead, cfg.sobel
    return dataclasses.replace(cfg, **kw).finalize(twohead=twohead,
                                                   sobel=sobel)


def _finite(result):
    return all(math.isfinite(v) for v in result.values()
               if isinstance(v, float))


def test_runs_shrunk_on_cpu(tmp_path, capsys, jax_calls):
    """twohead and semisup for 2 epochs on 64 synthetic images, through
    their config functions: JAX's JSON keys and finite numbers."""
    out = str(tmp_path / "runs")
    small = dict(dataset="Synthetic10x32x3x64", batch_sz=16)
    cfg = _shrunk_cluster(le.twohead_config(out), num_epochs=2, **small)
    old, fin = le.semisup_configs(out)
    old = _shrunk_cluster(old, num_epochs=2, **small)
    fin = dataclasses.replace(fin, num_epochs=1, new_batch_sz=16)
    capsys.readouterr()
    results = [le.run_twohead(out, "cpu", config=cfg),
               le.run_semisup(out, "cpu", configs=(old, fin))]
    lines = _json_lines(capsys.readouterr().out)
    assert lines == results
    for name, res in zip(("twohead", "semisup"), results):
        assert _keys(res) == _keys(jax_calls[name][1]), name
        assert _finite(res), res
    assert results[0]["epochs"] == 1
    assert os.path.exists(os.path.join(out, "203", "config.pickle"))


def test_nuisance_probe_shrunk_on_cpu(tmp_path, capsys, jax_calls):
    """The probe on the nuisance digits (OpenCV), each run cut to its
    first epoch of two batches (``test_code``): JAX's keys, finite."""
    pytest.importorskip("cv2")
    out = str(tmp_path)
    cfgs = le.nuisance_configs(out)
    for tag in ("iic", "random"):
        cfgs[tag] = _shrunk_cluster(cfgs[tag], num_epochs=2, test_code=True)
        cfgs["finetune"][tag] = dataclasses.replace(
            cfgs["finetune"][tag], num_epochs=1, test_code=True)
    res = le.run_nuisance_probe(out, "cpu", configs=cfgs)
    assert _json_lines(capsys.readouterr().out)[-1] == res
    assert _keys(res) == _keys(jax_calls["nuisance_probe"][1])
    assert _finite(res), res
    assert os.path.exists(os.path.join(out, "931", "best.pytorch"))


def test_digits_baselines_on_cpu(capsys):
    """The port's whole run against JAX's (scikit-learn): the same keys,
    accuracies within 0.05 of JAX's (both fits within 1.01x of each
    other's inertia; see the next tests)."""
    pytest.importorskip("sklearn")
    res = le.run_digits_baselines("cpu")
    want = jle.run_digits_baselines()
    capsys.readouterr()
    assert _keys(res) == _keys(want)
    for k in ("kmeans_raw_pixels_acc", "kmeans_pca32_acc"):
        assert 0.0 <= res[k] <= 1.0
        assert abs(res[k] - want[k]) <= 0.05, (k, res[k], want[k])


def test_pca_equals_sklearn():
    """The port's PCA-32 equals scikit-learn's exact one up to each
    component's sign. The JAX tool's ``PCA(32, random_state=0)`` picks the
    randomized solver at 1797 x 576, an approximation of it."""
    sk = pytest.importorskip("sklearn.decomposition")
    flat, _ = le.digits_data()
    assert flat.shape == (1797, 576)
    want = sk.PCA(n_components=32, svd_solver="full").fit_transform(flat)
    got = le.pca(torch.from_numpy(flat), 32).numpy()
    sign = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * sign, want, rtol=PCA_RTOL, atol=0)
    default = sk.PCA(n_components=32, random_state=0)
    default.fit(flat)
    assert default._fit_svd_solver == "randomized"


def _inertia(x, centres):
    """float64 sum of squared distances to the nearest centroid."""
    d = ((x[:, None, :] - np.asarray(centres, np.float64)[None]) ** 2)
    return float(d.sum(-1).min(1).sum())


def test_kmeans_inertia_within_sklearn_bound():
    """On the raw pixels and on the PCA-32 projection: the port's fit
    (``KMeans(10, n_init=10, seed=0)``) within 1.01x of scikit-learn's
    ``KMeans(n_clusters=10, n_init=10, random_state=0)`` on the same data;
    a fit stopped after one Lloyd iteration fails the bound."""
    skc = pytest.importorskip("sklearn.cluster")
    fits = le.digits_fits("cpu")
    for name, (x, fit) in fits.items():
        x = x.numpy()
        want = skc.KMeans(n_clusters=10, n_init=10, random_state=0).fit(x)
        got = _inertia(x, fit.cluster_centers_.double().numpy())
        assert got <= INERTIA_RATIO * want.inertia_, (name, got,
                                                       want.inertia_)
        one = KMeans(10, n_init=1, max_iter=1, seed=0).fit(torch.from_numpy(x))
        assert _inertia(x, one.cluster_centers_.double().numpy()) > \
            INERTIA_RATIO * want.inertia_, name


def test_main_writes_summary(tmp_path, capsys, monkeypatch):
    """``main``'s argument picks the experiments, and summary.json holds
    their results; no --device and no GPU is an error."""
    out = str(tmp_path)
    results = le.main(["digits_baselines", "--device", "cpu", "--out_root",
                       out])
    assert len(results) == 1 and "kmeans_pca32_acc" in results[0]
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == results
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found no GPU"):
        le.main(["digits_baselines", "--out_root", out])
    with pytest.raises(SystemExit):
        le.main(["nope", "--out_root", out])
