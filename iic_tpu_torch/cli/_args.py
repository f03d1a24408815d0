"""argparse -> config for the CLI entry points, with the reference's flag
names (``iic_tpu/cli/_args.py``: ``parse_cluster_args``,
``parse_seg_args``)."""

import argparse
import dataclasses

from iic_tpu_torch.train.config import ClusterConfig, SegConfig

_DERIVED = ("twohead", "sobel", "in_channels", "dataloader_batch_sz",
            "eval_mode", "bn_axis_name", "using_IR")


def _add_dataclass_args(parser, cls, skip=()):
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(name, action="store_true",
                                default=f.default)
        elif isinstance(f.default, tuple):
            if f.default:
                elem = int if all(isinstance(x, int) for x in f.default) \
                    else float
            else:
                elem = float if "float" in str(f.type) else int
            parser.add_argument(name, type=elem, nargs="+",
                                default=list(f.default))
        elif f.default is None:
            parser.add_argument(name, type=int, default=None)
        else:
            parser.add_argument(name, type=type(f.default),
                                default=f.default)
    return parser


def _parse(cls, argv, defaults):
    parser = argparse.ArgumentParser()
    _add_dataclass_args(parser, cls, skip=_DERIVED)
    args = parser.parse_args(argv)
    cfg = cls()
    for f in dataclasses.fields(cls):
        if f.name in _DERIVED:
            continue
        v = getattr(args, f.name)
        setattr(cfg, f.name, tuple(v) if isinstance(v, list) else v)
    for k, v in (defaults or {}).items():
        setattr(cfg, k, v)
    return cfg


def parse_cluster_args(argv=None, defaults=None):
    return _parse(ClusterConfig, argv, defaults)


def parse_seg_args(argv=None, defaults=None):
    return _parse(SegConfig, argv, defaults)
