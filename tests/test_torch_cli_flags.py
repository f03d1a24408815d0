"""The flag surface of the port's CLIs: each port CLI's argparse parser
against its JAX counterpart's, built without running either (the parser
is caught at its ``parse_args``). The port's option strings must equal the
JAX ones, aliases included, but for the port's own additions in ``EXTRA``;
the JAX package's own lock (tests/test_flag_surface.py) stays as it is.
The training CLIs' parsers are generated from the config dataclasses, so
those are held to JAX's too: the same fields with the same defaults."""

import argparse
import dataclasses
import importlib

import pytest

# (JAX module, port module, argv that reaches the parser)
CLIS = [
    ("iic_tpu.cli.export_model", "iic_tpu_torch.cli.export_model", []),
    ("iic_tpu.cli.import_torch", "iic_tpu_torch.cli.import_torch", []),
] + [
    (f"iic_tpu.cli.analysis.{name}", f"iic_tpu_torch.cli.analysis.{name}",
     argv)
    for name, argv in (
        ("eval", []), ("print_stats", []), ("update_config", []),
        ("print_nets", []), ("print_sub_heads_eval", []),
        ("overcluster_fewer_labels_example", []), ("render_general", []),
        ("render_potsdam", []), ("clone_and_eval", []),
        ("count_classes", ["--model_inds", "1"]), ("count_classes", []),
        ("print_examples", []), ("colour_scheme_change", []))]
# the training CLIs and the k-means + SIFT baseline
CLIS += [(f"iic_tpu.cli.{name}", f"iic_tpu_torch.cli.{name}", [])
         for name in ("cluster_greyscale", "cluster_greyscale_twohead",
                      "cluster_sobel", "cluster_sobel_twohead",
                      "segmentation", "segmentation_twohead",
                      "triplets_greyscale", "triplets_sobel", "doersch",
                      "isola", "IID_semisup_STL10", "kmeans_and_sift")]

# port-only flags: import_torch reads net files as weights only, and
# unpickles one in full (running the code it names) only when asked; the
# training CLIs and kmeans_and_sift have none
EXTRA = {"iic_tpu_torch.cli.import_torch": {"--allow_pickle"}}


class _Caught(Exception):
    def __init__(self, parser):
        super().__init__("parser caught")
        self.parser = parser


def _options(module, argv, monkeypatch):
    """The option strings of the parser ``module.main(argv)`` builds."""
    def catch(self, args=None, namespace=None):
        raise _Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    main = importlib.import_module(module).main
    with pytest.raises(_Caught) as caught:
        main(list(argv))
    monkeypatch.undo()
    return {o for a in caught.value.parser._actions for o in a.option_strings}


@pytest.mark.parametrize(
    "jax_mod,port_mod,argv", CLIS,
    ids=[c[1].rsplit(".", 1)[1] + ("-" + c[2][0] if c[2] else "")
         for c in CLIS])
def test_port_cli_flags_equal_jax(jax_mod, port_mod, argv, monkeypatch):
    want = _options(jax_mod, argv, monkeypatch)
    got = _options(port_mod, argv, monkeypatch)
    extra = EXTRA.get(port_mod, set())
    assert extra <= got
    got -= extra
    assert got == want, (sorted(got - want), sorted(want - got))
    assert len(want) > 1


def _defaults(cls):
    """{field: its default} of a config dataclass."""
    return {f.name: (f.default_factory() if f.default is dataclasses.MISSING
                     else f.default) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["ClusterConfig", "SegConfig",
                                  "SemisupConfig"])
def test_config_fields_and_defaults_equal_jax(name):
    """The port's config dataclass has JAX's fields, in JAX's order, with
    equal defaults of the same types."""
    theirs = _defaults(getattr(
        importlib.import_module("iic_tpu.train.config"), name))
    ours = _defaults(getattr(
        importlib.import_module("iic_tpu_torch.train.config"), name))
    assert list(ours) == list(theirs)
    for field, want in theirs.items():
        got = ours[field]
        assert got == want and type(got) is type(want), (field, got, want)
