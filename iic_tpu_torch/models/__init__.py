"""Model registry: name -> constructor taking a config object, the
reference's ``archs.__dict__[config.arch](config)`` lookup. Only the two
segmentation archs are ported so far."""

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


ARCHS = {
    "SegmentationNet10a": make_SegmentationNet10a,
    "SegmentationNet10aTwoHead": make_SegmentationNet10aTwoHead,
}


def build(name, config):
    if name not in ARCHS:
        raise NotImplementedError(f"arch {name!r} is not ported; ported: "
                                  f"{sorted(ARCHS)}")
    return ARCHS[name](config)


__all__ = ["ARCHS", "build", "SegmentationNet10a", "SegmentationNet10aTrunk",
           "SegmentationNet10aTwoHead"]
