"""Model registry: name -> constructor taking a config object, the
reference's ``archs.__dict__[config.arch](config)`` lookup. Ported so far:
the two segmentation archs and the ResNet-34 cluster nets."""

from iic_tpu_torch.models.cluster_nets import (
    ClusterNet5g, ClusterNet5gTrunk, ClusterNet5gTwoHead)
from iic_tpu_torch.models.segmentation_nets import (
    SegmentationNet10a, SegmentationNet10aTrunk, SegmentationNet10aTwoHead)


def make_SegmentationNet10a(config):
    return SegmentationNet10a(
        config.in_channels, config.output_k, config.num_sub_heads,
        config.input_sz, batchnorm_track=config.batchnorm_track)


def make_SegmentationNet10aTwoHead(config):
    return SegmentationNet10aTwoHead(
        config.in_channels, config.output_k_A, config.output_k_B,
        config.num_sub_heads, config.input_sz,
        batchnorm_track=config.batchnorm_track)


def make_ClusterNet5g(config):
    return ClusterNet5g(config.in_channels, config.output_k,
                        config.num_sub_heads,
                        batchnorm_track=config.batchnorm_track)


def make_ClusterNet5gTwoHead(config):
    return ClusterNet5gTwoHead(
        config.in_channels, config.output_k_A, config.output_k_B,
        config.num_sub_heads, batchnorm_track=config.batchnorm_track)


ARCHS = {
    "ClusterNet5g": make_ClusterNet5g,
    "ClusterNet5gTwoHead": make_ClusterNet5gTwoHead,
    "SegmentationNet10a": make_SegmentationNet10a,
    "SegmentationNet10aTwoHead": make_SegmentationNet10aTwoHead,
}


def build(name, config):
    if name not in ARCHS:
        raise NotImplementedError(f"arch {name!r} is not ported; ported: "
                                  f"{sorted(ARCHS)}")
    return ARCHS[name](config)


__all__ = ["ARCHS", "build", "ClusterNet5g", "ClusterNet5gTrunk",
           "ClusterNet5gTwoHead", "SegmentationNet10a",
           "SegmentationNet10aTrunk", "SegmentationNet10aTwoHead"]
