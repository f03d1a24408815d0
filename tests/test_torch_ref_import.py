"""The port's import of the reference's PyTorch checkpoints
(``iic_tpu_torch/compat/torch_import.py``, ``cli/import_torch.py``)
against the JAX package's (``iic_tpu/compat/torch_import.py``).

Each fixture is a state_dict in the reference's key layout (``module.``
prefixes, the cluster scripts' bare files and the segmentation scripts'
``{"net", "optimiser"}`` ones, VGG trunks under ``trunk.features``, the
SupHead5 wrapper's ``trunk.*`` / ``head.{0,1,3}``, the triplets head's
``head.head``, the Doersch head's ``siamese_branch`` / ``joint``), made
from a port net whose BN statistics were moved off (0, 1) by train-mode
forwards. It goes through JAX's ``state_dict_to_variables`` and through
the port's import; the two forwards agree within 1e-5 (max |d| of
softmax outputs, or of logits over their max |ref|). The readers'
python-2 fallbacks are held on hand-built py2 fixtures: JAX's and the
port's return the same dict.
"""

import argparse
import collections
import os
import pickle
import struct
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.compat import torch_import as jti
from iic_tpu.models import cluster_nets as jcluster
from iic_tpu.models import seg_baselines as jseg_baselines
from iic_tpu.models import semisup as jsemisup
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat import torch_import as ti
from iic_tpu_torch.models.semisup import SemisupNet, SupHead5Head

TOL = 1e-5
SZ = 24


def _cfg(arch, **kw):
    base = dict(arch=arch, in_channels=1, output_k=10, output_k_A=12,
                output_k_B=10, num_sub_heads=2, input_sz=SZ,
                batchnorm_track=True, model_dtype="float32")
    base.update(kw)
    return argparse.Namespace(**base)


def _evolved(net, x, **kw):
    """``net`` after train-mode forwards (running statistics moved)."""
    net.train()
    with torch.no_grad():
        for _ in range(2):
            net(torch.from_numpy(x), **kw)
    return net.eval()


def _reference(arch, sd):
    """A port state_dict in the reference's key layout."""
    out = collections.OrderedDict()
    for k, v in sd.items():
        if arch.endswith(("Doersch", "Isola")):
            attr = ("doersch_head." if arch.endswith("Doersch")
                    else "isola_head.")
            k = k.replace("trunk.features.", "features.")
            for a, b in (("head.siamese_conv.", "siamese_branch.0."),
                         ("head.siamese_bn.", "siamese_branch.1."),
                         ("head.joint1.", "joint.0."),
                         ("head.joint2.", "joint.3.")):
                if k.startswith(a):
                    k = attr + b + k[len(a):]
        elif arch.startswith("Triplets") and k.startswith("head."):
            k = "head.head." + k[len("head."):]
        elif arch == "SupHead5":
            if k.startswith("net."):
                k = "trunk." + k[len("net."):]
            for a, b in (("head.linear1.", "head.0."), ("head.bn.", "head.1."),
                         ("head.linear2.", "head.3.")):
                if k.startswith(a):
                    k = b + k[len(a):]
        out[k] = v.clone()
    return out


def _save(tmp_path, sd, fname, dataparallel=True, seg_combined=False,
          legacy=False):
    if dataparallel:
        sd = collections.OrderedDict(("module." + k, v)
                                     for k, v in sd.items())
    obj = {"net": sd, "optimiser": {}} if seg_combined else sd
    path = os.path.join(tmp_path, fname)
    torch.save(obj, path, _use_new_zipfile_serialization=not legacy)
    return path


def _port_load(arch, cfg, path, warnings=None):
    net = tmodels.build(arch, cfg)
    sd = ti.reference_to_port(arch, ti.load_torch_file(path))
    return ti.load_into(net, sd, warnings).eval()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL, err


def _x(seed, c, sz=SZ, b=4):
    return np.random.default_rng(seed).standard_normal(
        (b, c, sz, sz)).astype(np.float32)


def _forwards(jnet, variables, tnet, x, train=False, **kw):
    """(JAX output, port output) on ``x``; a train-mode forward uses the
    batch statistics and leaves the running ones as they were."""
    v = {"params": variables["params"]}
    if variables.get("batch_stats"):
        v["batch_stats"] = variables["batch_stats"]
    if train and "batch_stats" in v:
        jout = jnet.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"], **kw)[0]
    else:
        jout = jnet.apply(v, jnp.asarray(x), train=train, **kw)
    saved = [b.clone() for b in tnet.buffers()]
    tnet.train(train)
    with torch.no_grad():
        tout = tnet(torch.from_numpy(np.array(x)), **kw)
    with torch.no_grad():
        for b, s in zip(tnet.buffers(), saved):
            b.copy_(s)
    tnet.eval()
    return np.asarray(jout), tout.numpy()


def _template(jnet, x, heads=None, **kw):
    if heads:
        return jmodels.init_variables(jnet, jax.random.PRNGKey(0),
                                      jnp.asarray(x), heads=heads)
    return jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw)


# --------------------------------------------------------------- forms

def test_cluster_twohead_import_matches_jax(tmp_path):
    """net6c two-head, a bare state_dict under ``module.``
    (best_net.pytorch): both heads, eval- and train-mode BN."""
    arch, x = "ClusterNet6cTwoHead", _x(0, 1)
    cfg = _cfg(arch)
    torch.manual_seed(0)
    src = _evolved(tmodels.build(arch, cfg), x)
    path = _save(tmp_path, _reference(arch, src.state_dict()),
                 "best_net.pytorch")
    warnings = []
    tnet = _port_load(arch, cfg, path, warnings)
    assert warnings == []
    jnet = jcluster.ClusterNet6cTwoHead(output_k_A=12, output_k_B=10,
                                        num_sub_heads=2, input_sz=SZ)
    jw = []
    variables = jti.state_dict_to_variables(
        arch, _template(jnet, x, heads=("A", "B")),
        jti.load_torch_file(path), jw)
    assert jw == []
    for train in (False, True):
        for head in "AB":
            _close(*_forwards(jnet, variables, tnet, x, train, head=head))


def test_seg_import_matches_jax(tmp_path):
    """net10a two-head in the segmentation scripts' {"net", "optimiser"}
    file, ``module.`` prefixes."""
    arch, x = "SegmentationNet10aTwoHead", _x(1, 5, b=2)
    cfg = _cfg(arch, in_channels=5, output_k_A=6, output_k_B=3)
    torch.manual_seed(1)
    src = _evolved(tmodels.build(arch, cfg), x)
    path = _save(tmp_path, _reference(arch, src.state_dict()),
                 "best.pytorch", seg_combined=True)
    tnet = _port_load(arch, cfg, path)
    jnet = jmodels.build(arch, cfg)
    variables = jti.state_dict_to_variables(
        arch, _template(jnet, x, heads=("A", "B")),
        jti.load_torch_file(path))
    for head in "AB":
        _close(*_forwards(jnet, variables, tnet, x, False, head=head))


def test_sup_head5_import_matches_jax(tmp_path):
    """A SupHead5 wrapper: ``trunk.*`` the wrapped net6c two-head net,
    ``head.{0,1,3}`` the MLP; in the port, one ``SemisupNet``."""
    arch, x = "ClusterNet6cTwoHead", _x(2, 1)
    cfg = _cfg(arch, gt_k=10)
    dlen = 512 * 3 * 3
    torch.manual_seed(2)
    model = SemisupNet(tmodels.build(arch, cfg), SupHead5Head(dlen, 10))
    _evolved(model, x)
    path = _save(tmp_path, _reference("SupHead5", model.state_dict()),
                 "best_net.pytorch", dataparallel=False)
    sd = ti.load_torch_file(path)
    port = ti.load_into(
        SemisupNet(tmodels.build(arch, cfg), SupHead5Head(dlen, 10)),
        ti.sup_head5_to_port(arch, sd)).eval()
    jnet = jcluster.ClusterNet6cTwoHead(output_k_A=12, output_k_B=10,
                                        num_sub_heads=2, input_sz=SZ)
    jhead = jsemisup.SupHead5Head(gt_k=10)
    feats = np.random.default_rng(3).standard_normal(
        (4, dlen)).astype(np.float32)
    net_vars, head_vars = jti.sup_head5_state_dict_to_variables(
        arch, _template(jnet, x, heads=("A", "B")),
        jhead.init(jax.random.PRNGKey(1), jnp.asarray(feats)),
        jti.load_torch_file(path))
    for head in "AB":
        _close(*_forwards(jnet, net_vars, port.net, x, False, head=head))
    with torch.no_grad():
        tfeats = port.features(torch.from_numpy(x))
    jfeats = jnet.apply({"params": net_vars["params"],
                         "batch_stats": net_vars["batch_stats"]},
                        jnp.asarray(x), train=False, trunk_features=True)
    _close(tfeats.numpy(), jfeats)
    _close(*_forwards(jhead, head_vars, port.head, np.asarray(jfeats),
                      False))


def test_triplets_import_matches_jax(tmp_path):
    arch, x = "TripletsNet6c", _x(4, 1)
    cfg = _cfg(arch)
    torch.manual_seed(4)
    src = _evolved(tmodels.build(arch, cfg), x)
    path = _save(tmp_path, _reference(arch, src.state_dict()),
                 "latest_net.pytorch")
    tnet = _port_load(arch, cfg, path)
    jnet = jcluster.TripletsNet(output_k=10, input_sz=SZ, trunk_type="6c")
    variables = jti.state_dict_to_variables(
        arch, _template(jnet, x), jti.load_torch_file(path))
    _close(*_forwards(jnet, variables, tnet, x, False))


def test_doersch_import_matches_jax(tmp_path):
    """The trunk under ``features.*``, the head under
    ``doersch_head.{siamese_branch.{0,1}, joint.{0,3}}``."""
    arch, x = "SegmentationNet10aDoersch", _x(5, 3, sz=16, b=2)
    cfg = _cfg(arch, in_channels=3, input_sz=16, doersch_patch_side=1)
    torch.manual_seed(5)
    src = tmodels.build(arch, cfg)
    with torch.no_grad():  # the head BN's statistics off (0, 1)
        src.head.siamese_bn.running_mean.normal_()
        src.head.siamese_bn.running_var.uniform_(0.5, 2.0)
    path = _save(tmp_path, _reference(arch, src.state_dict()),
                 "latest.pytorch", seg_combined=True)
    tnet = _port_load(arch, cfg, path)
    jnet = jseg_baselines.SegmentationNet10aDoersch(patch_side=1,
                                                    input_sz=16)
    c = np.array([[8, 8], [5, 9]], np.int32)
    o = np.array([[7, 9], [6, 9]], np.int32)
    variables = jti.state_dict_to_variables(
        arch, jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        centre=jnp.asarray(c), other=jnp.asarray(o),
                        train=False), jti.load_torch_file(path))
    jout = jnet.apply(variables, jnp.asarray(x), centre=jnp.asarray(c),
                      other=jnp.asarray(o), train=False)
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x), torch.from_numpy(c),
                    torch.from_numpy(o))
    _close(tout.numpy(), jout)


def test_track_false_net_drops_the_stats_with_a_warning(tmp_path):
    """A checkpoint that tracked statistics into a net built with
    batchnorm_track=False: the parameters load, the statistics are
    dropped with a warning in both packages, and the batch-statistics
    forwards agree."""
    arch, x = "ClusterNet6c", _x(6, 1)
    torch.manual_seed(6)
    src = _evolved(tmodels.build(arch, _cfg(arch, num_sub_heads=1)), x)
    path = _save(tmp_path, _reference(arch, src.state_dict()),
                 "best_net.pytorch")
    cfg = _cfg(arch, num_sub_heads=1, batchnorm_track=False)
    warnings = []
    tnet = _port_load(arch, cfg, path, warnings)
    assert warnings and all("stats dropped" in w for w in warnings)
    jnet = jcluster.ClusterNet6c(output_k=10, num_sub_heads=1, input_sz=SZ,
                                 batchnorm_track=False)
    jw = []
    variables = jti.state_dict_to_variables(arch, _template(jnet, x),
                                            jti.load_torch_file(path), jw)
    assert jw and all("stats dropped" in w for w in jw)
    for train in (False, True):
        _close(*_forwards(jnet, variables, tnet, x, train))


def test_missing_counters_load_and_other_keys_raise(tmp_path):
    """Only num_batches_tracked may be missing; an unexpected key, a
    missing parameter or statistics the net tracks but the file lacks
    raise, naming the keys."""
    arch, x = "ClusterNet6c", _x(7, 1)
    cfg = _cfg(arch, num_sub_heads=1)
    sd = tmodels.build(arch, cfg).state_dict()
    no_counters = {k: v for k, v in sd.items()
                   if not k.endswith("num_batches_tracked")}
    ti.load_into(tmodels.build(arch, cfg), no_counters)
    with pytest.raises(ti.TorchImportError, match="unexpected.*extra"):
        ti.load_into(tmodels.build(arch, cfg), {**sd, "extra.weight":
                                                torch.zeros(1)})
    with pytest.raises(ti.TorchImportError, match="missing.*head.heads.0"):
        ti.load_into(tmodels.build(arch, cfg),
                     {k: v for k, v in sd.items()
                      if not k.startswith("head.heads.0.0.bias")})
    no_stats = {k: v for k, v in sd.items() if "running" not in k}
    with pytest.raises(ti.TorchImportError, match="batchnorm_track"):
        ti.load_into(tmodels.build(arch, cfg), no_stats)


@pytest.mark.parametrize("case,match", [
    ("sub_heads", "sub-head"), ("output_k", "weight"), ("trunk", "convs")])
def test_mismatch_errors_name_it(tmp_path, case, match):
    """A wrong sub-head count, a wrong output_k and a wrong trunk raise in
    both packages, naming the mismatch (tests/test_torch_import.py's
    error paths)."""
    arch = "ClusterNet6cTwoHead"
    saved = {"sub_heads": _cfg(arch, num_sub_heads=3),
             "output_k": _cfg(arch),
             "trunk": _cfg(arch, in_channels=2)}[case]
    torch.manual_seed(8)
    path = _save(tmp_path, _reference(arch, tmodels.build(
        arch, saved).state_dict()), "best_net.pytorch")
    if case == "trunk":
        target, tarch = _cfg("ClusterNet5gTwoHead", in_channels=2,
                             input_sz=32), "ClusterNet5gTwoHead"
        jnet = jmodels.build(tarch, target)
        x = _x(9, 2, sz=32)
    else:
        target, tarch = (_cfg(arch, output_k_B=7) if case == "output_k"
                         else _cfg(arch)), arch
        jnet = jmodels.build(tarch, target)
        x = _x(9, 1)
    with pytest.raises(ti.TorchImportError, match=match):
        _port_load(tarch, target, path)
    template = jax.eval_shape(lambda: jmodels.init_variables(
        jnet, jax.random.PRNGKey(0), jnp.asarray(x), heads=("A", "B")))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), template)
    with pytest.raises(jti.TorchImportError, match=match):
        jti.state_dict_to_variables(tarch, template,
                                    jti.load_torch_file(path))


# ------------------------------------------------------------ the readers

def _py2_namespace_pickle(fields):
    """The bytes python 2's ``pickle.dump(namespace, f, protocol=2)``
    writes for an argparse.Namespace: NEWOBJ of argparse.Namespace, its
    __dict__ as py2 ``str`` (SHORT_BINSTRING) keys with memo puts, BUILD."""
    out = bytearray(b"\x80\x02cargparse\nNamespace\nq\x00)\x81q\x01}q\x02(")
    memo = 3

    def binstring(b):
        nonlocal memo
        piece = b"U" + bytes([len(b)]) + b + b"q" + bytes([memo])
        memo += 1
        return piece

    for k, v in fields.items():
        out += binstring(k.encode("latin1"))
        if isinstance(v, bool):
            out += b"\x88" if v else b"\x89"
        elif isinstance(v, int):
            out += b"J" + struct.pack("<i", v)
        elif isinstance(v, float):
            out += b"G" + struct.pack(">d", v)
        else:
            out += binstring(v.encode("latin1"))
    out += b"ub."
    return bytes(out)


@pytest.mark.parametrize("fields", [
    {"arch": "ClusterNet5gTwoHead", "output_k_A": 70, "lr": 0.0001,
     "double_eval": True, "dataset": "CIFAR10"},
    {"arch": "SegmentationNet10aTwoHead", "dataset_root":
     "data/caf\xe9", "batchnorm_track": False, "gt_k": 3}])
def test_py2_config_pickle(tmp_path, fields):
    """A py2 protocol-2 Namespace pickle, ASCII or (second case) with a
    latin1 byte string that the default decoding refuses: both readers
    return the same dict, str keys, the values decoded as latin1."""
    path = tmp_path / "config.pickle"
    path.write_bytes(_py2_namespace_pickle(fields))
    if any(isinstance(v, str) and not v.isascii() for v in fields.values()):
        with pytest.raises(UnicodeDecodeError):
            with open(path, "rb") as f:
                pickle.load(f)
    got = ti.read_reference_config(str(path))
    assert got == jti.read_reference_config(str(path)) == fields


def test_unreadable_config_raises(tmp_path):
    path = tmp_path / "config.pickle"
    path.write_bytes(b"not a pickle")
    with pytest.raises(ti.TorchImportError, match="cannot read"):
        ti.read_reference_config(str(path))


@pytest.mark.parametrize("legacy", [True, False])
def test_torch_file_formats(tmp_path, legacy):
    """A legacy-format (``_use_new_zipfile_serialization=False``) and a
    zip-format state_dict with ``module.`` prefixes and counters: both
    readers return the same keys and values."""
    arch = "ClusterNet6cTwoHead"
    sd = tmodels.build(arch, _cfg(arch)).state_dict()
    path = _save(tmp_path, sd, "latest_net.pytorch", legacy=legacy)
    got, want = ti.load_torch_file(path), jti.load_torch_file(path)
    assert list(got) == list(want)
    assert not any(k.startswith("module.") or "num_batches" in k
                   for k in got)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


class _Py2Pickler(pickle._Pickler):
    """Python 2's pickler as far as a legacy torch save needs it: every
    str written as a py2 ``str`` (SHORT_BINSTRING / BINSTRING of its
    latin1 bytes)."""
    dispatch = dict(pickle._Pickler.dispatch)

    def _save_py2_str(self, obj):
        b = obj.encode("latin1")
        self.write((b"U" + bytes([len(b)]) if len(b) < 256
                    else b"T" + struct.pack("<i", len(b))) + b)
        self.memoize(obj)

    dispatch[str] = _save_py2_str


def _py2_pickle_module():
    mod = types.ModuleType("py2_pickle")
    mod.Pickler = _Py2Pickler
    mod.dump = lambda obj, f, protocol=2: _Py2Pickler(f, protocol).dump(obj)
    return mod


def test_py2_torch_file(tmp_path):
    """A legacy-format state_dict as python 2 saved it (keys and the
    storages' names py2 ``str``), one key not ASCII, so the default
    decoding refuses it: both readers return the same keys and values,
    the port's as weights only."""
    sd = collections.OrderedDict([
        ("module.conv\xe9.weight", torch.arange(6.0).view(2, 3)),
        ("module.bn.running_mean", torch.ones(3)),
        ("module.bn.num_batches_tracked", torch.tensor(4))])
    path = str(tmp_path / "best_net.pytorch")
    torch.save(sd, path, pickle_module=_py2_pickle_module(),
               pickle_protocol=2, _use_new_zipfile_serialization=False)
    with pytest.raises(UnicodeDecodeError):
        torch.load(path, weights_only=True)
    got, want = ti.load_torch_file(path), jti.load_torch_file(path)
    assert list(got) == list(want) == ["conv\xe9.weight", "bn.running_mean"]
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


class _NotWeights:
    """A class that neither a weights-only read nor the config reader
    builds."""

    def __eq__(self, other):
        return isinstance(other, _NotWeights)


def test_full_unpickle_needs_allow_pickle(tmp_path):
    """A net file or a config.pickle that names another class is refused
    without ``allow_pickle`` and read in full with it."""
    sd = tmodels.build("ClusterNet6cTwoHead",
                       _cfg("ClusterNet6cTwoHead")).state_dict()
    net_path = str(tmp_path / "best.pytorch")
    torch.save({"net": sd, "optimiser": {}, "extra": _NotWeights()},
               net_path)
    with pytest.raises(ti.TorchImportError, match="allow_pickle"):
        ti.load_torch_file(net_path)
    got = ti.load_torch_file(net_path, allow_pickle=True)
    assert list(got) == [k for k in sd if "num_batches" not in k]
    cfg_path = str(tmp_path / "config.pickle")
    with open(cfg_path, "wb") as f:
        pickle.dump(argparse.Namespace(arch="ClusterNet6cTwoHead",
                                       extra=_NotWeights()), f, protocol=2)
    with pytest.raises(ti.TorchImportError, match="not a config's class"):
        ti.read_reference_config(cfg_path)
    assert ti.read_reference_config(cfg_path, allow_pickle=True) == {
        "arch": "ClusterNet6cTwoHead", "extra": _NotWeights()}


# --------------------------------------------------------------- the CLI

def _ref_dir(tmp_path, arch, cfg, ref_cfg, files, seg_combined=False,
             x=None):
    torch.manual_seed(10)
    src = tmodels.build(arch, cfg)
    if x is not None:
        _evolved(src, x)
    ref = tmp_path / "ref"
    ref.mkdir()
    with open(ref / "config.pickle", "wb") as f:
        pickle.dump(argparse.Namespace(**ref_cfg), f, protocol=2)
    for fname in files:
        _save(ref, _reference(arch, src.state_dict()), fname,
              seg_combined=seg_combined)
    return str(ref), src.eval()


GREY_REF = {"arch": "ClusterNet6cTwoHead", "mode": "IID",
            "dataset": "Synthetic10x28x1x64", "dataset_root": "",
            "gt_k": 10, "output_k_A": 12, "output_k_B": 10,
            "num_sub_heads": 2, "input_sz": SZ, "batchnorm_track": True,
            "batch_sz": 32, "num_dataloaders": 2, "lr": 1e-4,
            "num_epochs": 3, "crop_orig": True, "crop_other": True,
            "tf1_crop": "centre_half", "tf1_crop_sz": 20,
            "tf2_crop_szs": [16, 20, 24], "no_flip": True,
            "pytorch_only_key": "dropped"}


def test_cli_import_then_restart(tmp_path, capsys):
    """A reference cluster run dir (config.pickle a Namespace, best and
    latest nets under ``module.``) -> a port run dir: the files, the
    source net's forward, a fresh optimiser's state, and ``--restart``
    from it for one --test_code epoch."""
    from iic_tpu_torch.cli import cluster_greyscale_twohead, import_torch
    from iic_tpu_torch.train import checkpoint as ckpt
    from iic_tpu_torch.train.config import config_from_dict

    x = _x(11, 1)
    arch = GREY_REF["arch"]
    ref, src = _ref_dir(tmp_path, arch, _cfg(arch), GREY_REF,
                        ("best_net.pytorch", "latest_net.pytorch"), x=x)
    out = str(tmp_path / "out")
    import_torch.main(["--ref_dir", ref, "--out_root", out, "--model_ind",
                       "685", "--greyscale", "--last_epoch", "0"],
                      device="cpu")
    assert "imported" in capsys.readouterr().out
    run = os.path.join(out, "685")
    for fname in ("best.pytorch", "latest.pytorch", "config.pickle",
                  "config.txt", "best_config.pickle"):
        assert os.path.exists(os.path.join(run, fname)), fname
    meta = ckpt.read_meta(out, 685)
    assert meta["last_epoch"] == 0 and "pytorch_only_key" not in \
        meta["config"]
    config = config_from_dict(meta["config"])
    assert (config.sobel, config.in_channels) == (False, 1)
    saved = torch.load(os.path.join(run, "best.pytorch"), weights_only=True)
    assert saved["optimiser"]["state"] == {}
    net = tmodels.build(arch, config)
    net.load_state_dict(saved["net"])
    net.eval()
    with torch.no_grad():
        for head in "AB":
            assert torch.equal(net(torch.from_numpy(x), head=head),
                               src(torch.from_numpy(x), head=head))
    argv = ["--model_ind", "685", "--out_root", out, "--restart",
            "--test_code", "--arch", arch, "--mode", "IID", "--dataset",
            GREY_REF["dataset"], "--dataset_root", "", "--gt_k", "10",
            "--output_k_A", "12", "--output_k_B", "10", "--num_sub_heads",
            "2", "--input_sz", str(SZ), "--batchnorm_track", "--batch_sz",
            "32", "--num_dataloaders", "2", "--num_epochs", "3",
            "--crop_orig", "--crop_other", "--tf1_crop", "centre_half",
            "--tf1_crop_sz", "20", "--tf2_crop_szs", "16", "20", "24",
            "--no_flip"]
    _, history = cluster_greyscale_twohead.main(argv, device="cpu")
    assert np.isfinite(history["epoch_loss_head_A"]).all()
    assert len(history["eval"].epoch_acc) == 1


def test_cli_import_seg_format(tmp_path):
    """A segmentation run dir (best.pytorch {"net", "optimiser"}): the
    imported weights give the JAX import's forward."""
    from iic_tpu_torch.cli import import_torch

    arch = "SegmentationNet10aTwoHead"
    ref_cfg = {"arch": arch, "mode": "IID", "dataset": "SyntheticSeg3x48x16",
               "gt_k": 3, "output_k_A": 6, "output_k_B": 3,
               "num_sub_heads": 1, "input_sz": SZ, "batchnorm_track": True,
               "batch_sz": 8, "num_dataloaders": 1, "include_rgb": True}
    x = _x(12, 5, b=2)
    cfg = _cfg(arch, in_channels=5, output_k_A=6, output_k_B=3,
               num_sub_heads=1)
    ref, _ = _ref_dir(tmp_path, arch, cfg, ref_cfg, ("best.pytorch",),
                      seg_combined=True, x=x)
    out = str(tmp_path / "out")
    import_torch.main(["--ref_dir", ref, "--out_root", out, "--model_ind",
                       "555"], device="cpu")
    net = tmodels.build(arch, cfg)
    net.load_state_dict(torch.load(os.path.join(out, "555", "best.pytorch"),
                                   weights_only=True)["net"])
    jnet = jmodels.build(arch, cfg)
    variables = jti.state_dict_to_variables(
        arch, _template(jnet, x, heads=("A", "B")),
        jti.load_torch_file(os.path.join(ref, "best.pytorch")))
    for head in "AB":
        _close(*_forwards(jnet, variables, net.eval(), x, False, head=head))


def test_cli_import_needs_a_gpu_without_a_device(tmp_path):
    from iic_tpu_torch.cli import import_torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        import_torch.main(["--net_file", "x.pytorch", "--arch",
                           "ClusterNet6c", "--out_root",
                           str(tmp_path), "--model_ind", "1"])
