"""Experiment configuration of the segmentation scripts
(``iic_tpu/train/config.py``: ``SegConfig``, ``config_to_str``).

The same flag names and defaults as the JAX package, so its command lines
carry over. Flags the port does not implement yet are refused by the
trainer with ``NotImplementedError`` (``train/seg_trainer.py``); derived
fields are computed in ``finalize()``.
"""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class SegConfig:
    # reference flags (segmentation scripts, segmentation_twohead.py:35-122)
    model_ind: int = 0
    arch: str = "SegmentationNet10aTwoHead"
    opt: str = "Adam"
    mode: str = "IID"
    dataset: str = "Potsdam"
    dataset_root: str = ""
    use_coarse_labels: bool = False
    fine_to_coarse_dict: str = ""
    include_things_labels: bool = False
    incl_animal_things: bool = False
    coco_164k_curated_version: int = -1
    gt_k: int = 3
    output_k: Optional[int] = None
    output_k_A: int = 15
    output_k_B: int = 3
    lamb: float = 1.0
    lamb_A: float = 1.0
    lamb_B: float = 1.5
    lr: float = 1e-4
    lr_schedule: Tuple[int, ...] = ()
    lr_mult: float = 0.1
    use_uncollapsed_loss: bool = False
    num_epochs: int = 1000
    batch_sz: int = 120
    num_dataloaders: int = 1
    num_sub_heads: int = 1
    out_root: str = "out"
    restart: bool = False
    restart_from_best: bool = False
    test_code: bool = False
    save_freq: int = 10
    batchnorm_track: bool = False
    # the seg scripts default to head A FIRST, opposite of the cluster
    # scripts' head_A_first flag (segmentation_twohead.py:82,179-181)
    head_B_first: bool = False
    head_A_epochs: int = 1
    head_B_epochs: int = 1
    select_sub_head_on_loss: bool = False
    # accepted for flag parity but refused like the reference dataset
    # does (cocostuff.py:63-64 asserts it is never set)
    mask_input: bool = False
    # data
    no_sobel: bool = False
    include_rgb: bool = False
    pre_scale_all: bool = False
    pre_scale_factor: float = 0.5
    input_sz: int = 161
    use_random_scale: bool = False
    scale_min: float = 0.6
    scale_max: float = 1.4
    jitter_brightness: float = 0.4
    jitter_contrast: float = 0.4
    jitter_saturation: float = 0.4
    jitter_hue: float = 0.125
    flip_p: float = 0.5
    # random affine of img2 (reference segmentation_twohead.py:108-115)
    use_random_affine: bool = False
    aff_min_rot: float = -30.0
    aff_max_rot: float = 30.0
    aff_min_shear: float = -10.0
    aff_max_shear: float = 10.0
    aff_min_scale: float = 0.8
    aff_max_scale: float = 1.2
    no_pre_eval: bool = False
    # doersch/isola baselines (reference baselines/doersch.py:35,
    # isola.py:71); per_sample_patches is a JAX-package extension: draw an
    # independent patch pair per image instead of one pair per batch
    doersch_patch_side: int = 11
    isola_patch_side: int = 11
    max_num_kmeans_samples: int = -1
    per_sample_patches: bool = False
    # Doersch colour-dropping (datasets/segmentation/baselines/
    # doersch.py:25-73): set True by the doersch CLI (doersch.py:98),
    # False by the main seg scripts (segmentation_twohead.py:134)
    use_doersch_datasets: bool = False
    # cache dir for the dataset RGB mean/stddev pickle the noise draws
    # from (doersch.py:37, stats file auto-created); "" = compute fresh
    doersch_stats: str = ""
    # extra numbered checkpoints every 3 epochs (doersch.py:362)
    save_multiple: bool = False
    # per-stage k-means eval progress logs (doersch.py:285)
    verbose: bool = False
    # loss geometry
    half_T_side_dense: int = 0
    half_T_side_sparse_min: int = 0
    half_T_side_sparse_max: int = 0
    # additions of the JAX package (most are refused by the port's trainer)
    n_devices: Optional[int] = None
    joint_mode: str = "global"
    model_dtype: str = "float32"
    bn_sync: bool = False
    seed: int = 0
    eval_batch_sz: Optional[int] = None
    exact_warp: bool = False  # the port always warps exactly
    # displacement-joint implementation for the uncollapsed loss: "pallas"
    # (the hand-written CUDA kernels; the JAX package's name for its own
    # kernel), "conv" (the plain conv) or "fft" (not ported)
    joint_impl: str = "pallas"
    profile_dir: str = ""  # not ported: refused
    no_compile_cache: bool = False  # no compile cache in the port
    use_orbax: bool = False  # not ported: refused
    fused_pair_forward: bool = False  # one 2B forward (BN stats over union)
    resident_data: bool = False  # stage dataset in HBM; crop on device
    epoch_scan: bool = False  # fuse whole epochs into one lax.scan program
    no_host_prefetch: bool = False  # disable the background prefetch thread
    prefetch_depth: int = 8  # host prefetch queue depth (~8 MB/batch)

    # derived
    twohead: bool = True
    sobel: bool = True
    using_IR: bool = False
    in_channels: int = 0
    dataloader_batch_sz: int = 0
    eval_mode: str = "hung"
    bn_axis_name: Optional[str] = None

    def finalize(self, twohead=True):
        """Derived fields (reference utils/segmentation/general.py:1-20)."""
        self.twohead = twohead
        if self.output_k is None:
            self.output_k = self.output_k_B
        self.sobel = not self.no_sobel
        self.using_IR = "Potsdam" in self.dataset
        if self.sobel:
            self.in_channels = 2  # dx, dy
            if self.include_rgb:
                self.in_channels += 3
        else:
            self.in_channels = 3 if self.include_rgb else 1
        if self.using_IR:
            self.in_channels += 1
        self.dataloader_batch_sz = self.batch_sz // self.num_dataloaders
        self.eval_mode = "hung" if self.mode == "IID" else "orig"
        self.bn_axis_name = "data" if self.bn_sync else None
        return self


def config_to_str(config):
    """Reference ``config_to_str`` (utils/cluster/general.py:12-17)."""
    attrs = dataclasses.asdict(config) if dataclasses.is_dataclass(config) \
        else vars(config)
    lines = ["Config: -----"]
    lines += [f"{k}: {v}" for k, v in attrs.items()]
    lines.append("----------")
    return "\n".join(lines)

