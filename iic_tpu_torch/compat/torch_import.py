"""Import the reference's (xu-ji/IIC) PyTorch checkpoints into the port
(``iic_tpu/compat/torch_import.py``).

The reference saves plain torch ``state_dict`` files:

- cluster scripts: ``latest_net.pytorch`` / ``best_net.pytorch`` hold the
  bare net state_dict;
- segmentation scripts: ``latest.pytorch`` / ``best.pytorch`` hold one
  ``{"net": ..., "optimiser": ...}`` dict;
- semisup: ``best_net.pytorch`` holds the whole SupHead5 wrapper:
  ``trunk.*`` is the wrapped cluster net and ``head.{0,1,3}.*`` the
  finetune MLP (Linear, BatchNorm1d, ReLU, Linear).

The port's nets carry the reference's module names (``trunk.conv1``,
``trunk.features.<i>``, ``head_A.heads.<s>.0``), so most keys load as
they are. The rest are renamed: the semisup head B's ``head_B.head.*`` ->
``head_B.*``, the triplets head's ``head.head.*`` -> ``head.*``, the
Doersch / Isola nets' ``features.*`` -> ``trunk.features.*`` and their
``<doersch|isola>_head.{siamese_branch.0, siamese_branch.1, joint.0,
joint.3}`` -> ``head.{siamese_conv, siamese_bn, joint1, joint2}``, and a
SupHead5 save's ``trunk.*`` -> ``net.*`` and ``head.{0,1,3}`` ->
``head.{linear1,bn,linear2}`` (``models.semisup.SemisupNet``).

The load into a net is strict. It tolerates only missing
``num_batches_tracked`` counters and the running statistics of a save
that tracked them, loaded into a net built with ``batchnorm_track=False``
(dropped, with a warning). Every other missing or unexpected key, and
every shape that differs, raises ``TorchImportError`` naming it.
Optimiser state is not imported.
"""

import collections
import pickle
import re

import numpy as np
import torch


class TorchImportError(ValueError):
    pass


def _check(cond, msg):
    if not cond:
        raise TorchImportError(msg)


# --------------------------------------------------------------- loading

def normalize_state_dict(obj):
    """Any reference save format -> OrderedDict[str, torch.Tensor].

    Accepts a bare state_dict (cluster scripts), the segmentation scripts'
    ``{"net": ..., "optimiser": ...}`` wrapper, and tensors or arrays as
    values. Strips a leading ``module.`` (nn.DataParallel) prefix and
    drops ``num_batches_tracked`` counters."""
    if isinstance(obj, dict) and "net" in obj and hasattr(obj["net"],
                                                          "items"):
        obj = obj["net"]
    _check(hasattr(obj, "items"), f"not a state_dict: {type(obj)}")
    sd = collections.OrderedDict()
    for k, v in obj.items():
        _check(isinstance(k, str), f"non-string state_dict key: {k!r}")
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        sd[k] = (v.detach().cpu() if torch.is_tensor(v)
                 else torch.from_numpy(np.asarray(v)))
    return sd


def load_torch_file(path, allow_pickle=False):
    """``torch.load`` a reference ``*.pytorch`` file -> normalized
    state_dict. Reads with ``weights_only`` (tensors and plain containers
    only), then again decoding py2 byte strings as latin1 (the reference is
    py2). A file that needs any other class is unpickled in full only with
    ``allow_pickle``, which runs whatever code the file names: give it only
    for a file from a trusted source."""
    import warnings
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as first:  # noqa: BLE001 - retried below
        try:
            with warnings.catch_warnings():
                # torch warns that pickle_load_args are ignored under
                # weights_only; its restricted reader honours encoding
                warnings.simplefilter("ignore", UserWarning)
                obj = torch.load(path, map_location="cpu",
                                 weights_only=True, encoding="latin1")
        except Exception:  # noqa: BLE001
            if not allow_pickle:
                raise TorchImportError(
                    f"{path}: not readable as weights only ({first}); "
                    "pass allow_pickle (import_torch --allow_pickle) to "
                    "unpickle it in full, for a trusted file only") from None
            obj = torch.load(path, map_location="cpu", weights_only=False,
                             encoding="latin1")
    return normalize_state_dict(obj)


# what a reference config.pickle holds: the argparse.Namespace and, in its
# metric history, numpy scalars and arrays
_CONFIG_GLOBALS = {
    ("argparse", "Namespace"), ("collections", "OrderedDict"),
    ("numpy", "dtype"), ("numpy", "ndarray"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct")}


class _ConfigUnpickler(pickle.Unpickler):
    """A pickle reader that builds only ``_CONFIG_GLOBALS``' classes."""

    def find_class(self, module, name):
        if (module, name) not in _CONFIG_GLOBALS:
            raise pickle.UnpicklingError(
                f"{module}.{name}: not a config's class (allow_pickle "
                "reads it)")
        return super().find_class(module, name)


def read_reference_config(path, allow_pickle=False):
    """Best-effort read of a reference run dir's ``config.pickle`` (a
    pickled argparse.Namespace, written by py2) -> plain dict. Builds no
    class but a Namespace's, an OrderedDict's and numpy's scalars and
    arrays, unless ``allow_pickle`` (a trusted file only). Raises
    TorchImportError when unreadable; callers fall back to explicit
    flags."""
    reader = pickle.Unpickler if allow_pickle else _ConfigUnpickler
    last = None
    for kw in ({}, {"encoding": "latin1"}, {"encoding": "bytes"}):
        try:
            with open(path, "rb") as f:
                obj = reader(f, **kw).load()
            d = obj if isinstance(obj, dict) else vars(obj)
            return {k if isinstance(k, str) else k.decode("latin1"): v
                    for k, v in d.items()}
        except Exception as e:  # noqa: BLE001 - collect and re-raise below
            last = e
    raise TorchImportError(f"cannot read reference config {path}: {last}")


# ------------------------------------------------------------- key names

_SIAMESE = {"siamese_branch.0.": "siamese_conv.",
            "siamese_branch.1.": "siamese_bn.",
            "joint.0.": "joint1.", "joint.3.": "joint2."}
_SUP_HEAD = {"0.": "linear1.", "1.": "bn.", "3.": "linear2."}


def _rename(sd, prefix, new, table=None):
    """Keys under ``prefix`` moved under ``new``, their rest renamed by
    ``table`` (first match of its prefixes); other keys kept."""
    out = collections.OrderedDict()
    for k, v in sd.items():
        if k.startswith(prefix):
            rest = k[len(prefix):]
            for a, b in (table or {}).items():
                if rest.startswith(a):
                    rest = b + rest[len(a):]
                    break
            k = new + rest
        out[k] = v
    return out


def reference_to_port(arch, sd):
    """A reference state_dict's keys -> the port net's names for
    ``arch``."""
    if arch.endswith(("Doersch", "Isola")):
        attr = "doersch_head." if arch.endswith("Doersch") else "isola_head."
        return _rename(_rename(sd, "features.", "trunk.features."), attr,
                       "head.", _SIAMESE)
    if arch.startswith("Triplets"):
        return _rename(sd, "head.head.", "head.")
    # the semisup variant's head B (one Linear); "head_B.heads." is not
    # under this prefix
    return _rename(sd, "head_B.head.", "head_B.")


def has_semisup_head_B(sd):
    """Whether a reference state_dict's head B is the semisup Linear."""
    return any(k.startswith("head_B.head.") for k in sd)


def sup_head5_to_port(arch, sd):
    """A SupHead5 wrapper state_dict -> ``SemisupNet`` names: the wrapped
    cluster net (``trunk.*``) under ``net.*``, the finetune MLP under
    ``head.{linear1,bn,linear2}``."""
    _check(any(k.startswith("trunk.") for k in sd),
           "no trunk.* keys: not a SupHead5 state_dict")
    inner = collections.OrderedDict(
        (k[len("trunk."):], v) for k, v in sd.items()
        if k.startswith("trunk."))
    out = collections.OrderedDict(
        ("net." + k, v) for k, v in reference_to_port(arch, inner).items())
    for k, v in _rename(sd, "head.", "head.", _SUP_HEAD).items():
        if k.startswith("head."):
            out[k] = v
    return out


# ------------------------------------------------------------ strict load

_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _sub_heads(keys, head):
    return {int(m.group(1)) for k in keys
            for m in [re.match(rf"{head}\.heads\.(\d+)\.", k)] if m}


def _check_structure(sd, want):
    """Name the mismatches the reference's checkpoints show: a wrong
    sub-head count or a wrong trunk (before the key-by-key check)."""
    for head in ("head", "head_A", "head_B"):
        got, exp = _sub_heads(sd, head), _sub_heads(want, head)
        _check(got == exp or not exp,
               f"{head}: checkpoint has {len(got)} sub-heads, the net "
               f"{len(exp)}")

    def convs(keys):
        return sum(1 for k in keys if k.startswith(("trunk.", "net.trunk."))
                   and k.endswith("weight") and keys[k].ndim == 4)
    got, exp = convs(sd), convs(want)
    _check(got == exp, f"trunk: checkpoint has {got} convs, the net {exp}")


def load_into(net, sd, warnings=None):
    """Strict load of a state_dict already in the port's names into
    ``net`` (on the net's device, in its parameters' dtype). Tolerates
    missing ``num_batches_tracked`` counters, and drops the running
    statistics of BNs the net built without them (``batchnorm_track``
    off), appending a warning to ``warnings``. Raises TorchImportError on
    any other missing or unexpected key or on a shape that differs.
    Returns ``net``."""
    if warnings is None:
        warnings = []
    want = net.state_dict()
    _check_structure(sd, want)
    sd = collections.OrderedDict(sd)
    dropped = [k for k in sd if k not in want and k.endswith(_STATS)
               and k.rsplit(".", 1)[0] + ".weight" in want]
    for k in dropped:
        del sd[k]
    if dropped:
        warnings.append(
            f"{len(dropped)} running statistics in the checkpoint, but the "
            "net has batchnorm_track=False: stats dropped "
            f"({dropped[0]}, ...)")
    missing = [k for k in want if k not in sd
               and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in want]
    _check(not missing and not unexpected,
           f"keys differ: missing {missing[:8]}, unexpected "
           f"{unexpected[:8]}" + (
               " (the net tracks running stats, the checkpoint has none: "
               "import with batchnorm_track matching the original run)"
               if missing and all(k.endswith(_STATS) for k in missing)
               else ""))
    for k, v in sd.items():
        _check(tuple(v.shape) == tuple(want[k].shape),
               f"{k}: weight shape {tuple(v.shape)} in the checkpoint, "
               f"{tuple(want[k].shape)} in the net")
    full = {k: (sd[k] if k in sd else want[k]).to(want[k].dtype)
            for k in want}
    net.load_state_dict(full, strict=True)
    return net
