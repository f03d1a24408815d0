"""Model registry: name -> constructor taking a config object, the
reference's ``archs.__dict__[config.arch](config)`` lookup. Ported so far:
the two segmentation archs, the ResNet-34 and net6c cluster nets (the
two-head ones with the semisup head B under ``config.semisup``) and the
baselines' nets (``TripletsNet`` on either trunk, the Doersch and Isola
nets of ``models.seg_baselines``). Every net runs in
``config.model_dtype`` (float32 by default, or bfloat16) but the Doersch
and Isola nets, which run in float32 whatever it says, as the JAX
factories build them. The semisup finetune's head is
``models.semisup.SupHead5Head``."""

from iic_tpu_torch.models.cluster_nets import (
    ClusterNet5g, ClusterNet5gTrunk, ClusterNet5gTwoHead, ClusterNet6c,
    ClusterNet6cTrunk, ClusterNet6cTwoHead, TripletsNet)
from iic_tpu_torch.models.seg_baselines import (
    SegmentationNet10aDoersch, SegmentationNet10aIsola)
from iic_tpu_torch.models.segmentation_nets import (
    SegmentationNet10a, SegmentationNet10aTrunk, SegmentationNet10aTwoHead)
from iic_tpu_torch.models.layers import compute_dtype


def _build_common(config):
    """``iic_tpu/models/__init__.py``'s ``_build_common``: BN tracking and
    the compute dtype; a ``model_dtype`` other than float32 or bfloat16
    raises."""
    return dict(
        batchnorm_track=config.batchnorm_track,
        dtype=compute_dtype(getattr(config, "model_dtype", "float32")))


def make_SegmentationNet10a(config):
    return SegmentationNet10a(
        config.in_channels, config.output_k, config.num_sub_heads,
        config.input_sz, **_build_common(config))


def make_SegmentationNet10aTwoHead(config):
    return SegmentationNet10aTwoHead(
        config.in_channels, config.output_k_A, config.output_k_B,
        config.num_sub_heads, config.input_sz, **_build_common(config))


def make_ClusterNet6c(config):
    return ClusterNet6c(config.in_channels, config.output_k,
                        config.num_sub_heads, config.input_sz,
                        **_build_common(config))


def make_ClusterNet6cTwoHead(config):
    return ClusterNet6cTwoHead(
        config.in_channels, config.output_k_A, config.output_k_B,
        config.num_sub_heads, config.input_sz,
        semisup=getattr(config, "semisup", False), **_build_common(config))


def make_ClusterNet5g(config):
    return ClusterNet5g(config.in_channels, config.output_k,
                        config.num_sub_heads, **_build_common(config))


def make_ClusterNet5gTwoHead(config):
    return ClusterNet5gTwoHead(
        config.in_channels, config.output_k_A, config.output_k_B,
        config.num_sub_heads, semisup=getattr(config, "semisup", False),
        **_build_common(config))


def make_TripletsNet5g(config):
    return TripletsNet(config.in_channels, config.output_k, config.input_sz,
                       trunk_type="5g", **_build_common(config))


def make_TripletsNet6c(config):
    return TripletsNet(config.in_channels, config.output_k, config.input_sz,
                       trunk_type="6c", **_build_common(config))


def make_SegmentationNet10aDoersch(config):
    return SegmentationNet10aDoersch(
        config.in_channels, config.doersch_patch_side, config.input_sz,
        batchnorm_track=config.batchnorm_track)


def make_SegmentationNet10aIsola(config):
    return SegmentationNet10aIsola(
        config.in_channels, config.isola_patch_side, config.input_sz,
        batchnorm_track=config.batchnorm_track)


ARCHS = {
    "ClusterNet5g": make_ClusterNet5g,
    "ClusterNet5gTwoHead": make_ClusterNet5gTwoHead,
    "ClusterNet6c": make_ClusterNet6c,
    "ClusterNet6cTwoHead": make_ClusterNet6cTwoHead,
    "SegmentationNet10a": make_SegmentationNet10a,
    "SegmentationNet10aTwoHead": make_SegmentationNet10aTwoHead,
    "TripletsNet5g": make_TripletsNet5g,
    "TripletsNet6c": make_TripletsNet6c,
    "SegmentationNet10aDoersch": make_SegmentationNet10aDoersch,
    "SegmentationNet10aIsola": make_SegmentationNet10aIsola,
}


def build(name, config):
    if name not in ARCHS:
        raise NotImplementedError(f"arch {name!r} is not ported; ported: "
                                  f"{sorted(ARCHS)}")
    return ARCHS[name](config)


__all__ = ["ARCHS", "build", "ClusterNet5g", "ClusterNet5gTrunk",
           "ClusterNet5gTwoHead", "ClusterNet6c", "ClusterNet6cTrunk",
           "ClusterNet6cTwoHead", "SegmentationNet10a",
           "SegmentationNet10aTrunk", "SegmentationNet10aTwoHead",
           "TripletsNet", "SegmentationNet10aDoersch",
           "SegmentationNet10aIsola"]
