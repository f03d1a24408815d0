#!/usr/bin/env python3
"""Drives the PyTorch port (``iic_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--trace_dir DIR]

Phases, in order; any failure raises and the exit code is non-zero:
  1. require CUDA; print the device, its name and power limit; set TF32
     (before each timed phase below, the SM clock, its maximum, the power
     draw and the temperature are printed);
  2. build the CUDA kernels from ``iic_tpu_torch/csrc``, one nvcc per
     source, all at once; print the times and ptxas' registers and spills;
     for both forms of K1, K2 and K3 and the tensor-core kernels X1, X7, X2's
     three mode instantiations and its copies-only kernel, the TMA-fed
     kernels of X3, X4, X5 / X6 and X6's roll_build, X8 and X9 print
     registers, stack and local memory (``cuobjdump
     --dump-resource-usage``) and the count of HGMMA / HMMA instructions,
     wgmma waits (all, and those for zero groups) and, for the TMA-fed
     kernels, TMA loads (UTMALDG), lane shuffles (SHFL) and byte permutes
     (PRMT) in their SASS (``--dump-sass``), and fail if a tensor-core
     kernel (K1 and K2 at k > 4, X1, X7, X2's modes but copies-only, X3,
     X4, X5 / X6, X8, X9) has none or uses local memory (spills), if K1's
     stack product, its X2 modes or a TMA-fed kernel wait for zero groups
     after every product (ptxas serialised them), if K1's stack product
     builds differently in K1's and X7's libraries, if a TMA-fed kernel
     has no TMA load or passes 200 registers, if roll_build's kernel has
     no SHFL or PRMT, or K1's CUDA-core form leaves its 80 registers;
     print K3's dynamic shared memory a block in both forms;
  3. hold K1 (joint forward) and K2 (input gradient, dx1 and dx2) against
     their plain PyTorch versions at the segmentation path's shapes (n=120,
     128^2, T=21, k=15 and k=3), within the JAX package's own kernel
     contract (rtol 5e-3, atol 5e-3 * max); hold both forms of K1 within
     K1_F64 (tensor cores) or K1_F64_FMA (CUDA cores) of max of its bf16
     function in float64 and both forms of K2 within 3e-5, and K2
     bit-equal to X8 where it runs X8's kernel (k=15); print each form's
     errors against the bf16 function in float64 and against the f32
     conv, K1's error and time against its chunk depth and the device
     time of each kernel a K1 call launches (k=15), and
     CUDA-event times of both forms of K1 and K2, the f32 plain versions
     and the bf16 cuDNN conv of each;
  4. hold K3 (fused clustering IID loss) in both forms (a thread-block
     cluster a sub-head, and one block a sub-head) against its plain
     version at the clustering path's shapes (S=5 sub-heads; bn, k = 660,
     70 / 660, 10 / 1000, 140): loss and loss_nl within rtol = atol =
     1e-5, P within 1e-6 of max |P| (the cluster form's of P in float64),
     autograd gradients within rtol 1e-3,
     atol 1e-6; the cluster form's bits equal across two launches and for
     each sub-head launched alone; errors against a float64 plain version;
     CUDA-event times through the wrapper, forward (both forms) and
     forward + backward; the wrapper in both forms in 10 alternating
     rounds, by CUDA events and by its host time a call; the
     entry point's times through ctypes in both forms (also at one 32-row
     stage, bn=32) beside an empty kernel launched the same way (the
     launch floor), and each one's device time by the profiler;
  5. hold X2 (the experiment tool's bf16 joint forward, on K1's stack
     product) against its plain version at the segmentation shapes in
     every mode: full, rank3 and aligned-copies within the JAX contract
     (aligned-copies also exactly broadcast over (u, v)), mm-only and
     copies-only exactly; at k=15 full and rank3 bit-equal to X7's
     tensor-core form at rb 16, 32, 64; full's error against float64;
     every mode's time beside X7's; hold X1 (the stack-product probe) at the same shapes
     in both forms to its plain version (tiles of ones: every entry the
     count of terms issued), exactly; CUDA-event times of each kernel, its
     plain version and the library call that computes the same function
     (X1 on the tensor cores beside one bf16 torch.matmul);
  6. hold X7 (the tool's v8 joint forward: K1's kernels on bf16 inputs)
     in both forms and X8 (its v8 input gradient with bf16 operands, dx1
     and dx2) against their plain versions at the same shapes for rb = 16,
     32, 64, within the JAX contract, and X7 bit-equal to K1 on the same
     bf16 operands in K1's form; their errors against float64; X7's times
     in both forms beside K1's and X2's in the same phase; X8 beside K2
     (bit-equal to X8 at k=15) and the bf16 cuDNN conv in its phase;
     kernel, plain and library times;
  7. run the TMA-fed tensor-core forms of X3, X4, X5 and X6 (both
     roll_build) in a child process under a time limit (a hung mbarrier
     wait fails the phase), at the phase's shapes and at ragged ones whose
     chunks walk 1, 2, 3 and more slabs, each bit-equal to X7's
     tensor-core form (X6 to X5 on rounded inputs); hold X3-X6 (the tool's
     pipelined v3, v4, v5 and v6 joint forwards) against X2's plain
     version at the same shapes within the JAX contract: X3 at rb = 16,
     32, 64 x flat in its default form and at each rb in the other, X4 and
     X5 at each rb in each form, X6 (f32 inputs, rounded in the
     kernel) at both roll_build in each form (X3 and X5 bit for bit equal
     to X7 in the same form at that rb, X4 in the tensor-core form, X6 to X5 on the rounded inputs and
     roll_build=True to False; the tensor-core forms also within K1_F64 of
     max of float64); each kernel's error against float64; their times
     (all four in both forms) beside K1's, X7's (both forms) and X2's
     in the same phase; plain and library times; at k=15 the tensor-core
     forms of X3-X6 beside X7's and K1 in alternating rounds
     (median, min, max) and the device time of each kernel their calls
     launch;
  8. hold X9 (the tool's v7 fused backward: dx1 and dx2 in one launch,
     each per-displacement partial rounded to bf16) against its plain
     version by mean |d| / mean |ref| <= 1e-5 and max |d| <= 2e-3 max |ref|,
     at k=15, k=3 and (n=8) k=17, and require X8's unrounded pair to fail
     that criterion (so the check sees a lost rounding); errors against
     float64; times beside two X8 calls and two bf16 cuDNN convs;
  9. run the two-head segmentation CLI (COCO-Stuff-3 shape, model 555,
     on SyntheticSeg3x146x480) with --test_code, kernel counts set to 0
     just before; require finite losses, a filled eval history and at
     least 4 K1 and 8 K2 launches;
 10. run the two-head sobel clustering CLI (CIFAR10 model 640's flags on
     Synthetic10x32x3, --fused_loss) with --test_code, counts set to 0
     just before; require finite losses for both heads, a pre-train and an
     epoch eval with the double-eval lists, and at least one K3 launch per
     step; phases 9 and 10 run in f32 and then in bf16 (--model_dtype
     bfloat16), each behind the default prefetch thread, with the same
     checks, and the kernel table's K1, K2 and K3 launches are the sums of
     the four runs;
 10a. the segmentation family's real-data path, on a Potsdam fixture tree
     written in a temporary directory (110 unlabelled, 40 labelled and 30
     test tiles of 200 x 200 rgb + ir, ``scipy.io.savemat``; labelled
     tiles only have a gt file): build the port's native host prep with
     g++ (seconds, path, CPUs) and hold its batch of model 545's first 75
     tiles bit-equal to the numpy fast path's, images and masks, with each
     path's host ms a batch (median of 10); hold K1, and K2 for dx1 and
     dx2, at the six joint shapes of models 512, 545 and 544 (n 60 / 75 /
     60; 128^2 / 200^2 / 200^2; T 21 / 21 / 11; k 45 and 15, 24 and 3, 36
     and 6) within the JAX contract, K2 bit-equal to X8 where it runs X8's
     kernel, K1 at 545's k=24 within K1_F64 of its bf16 function in
     float64, with each one's CUDA-event ms beside the bf16 F.conv2d and
     its bound; run model 545's two-head CLI (--test_code, bf16) through
     the native host prep, then --restart into the same run directory
     (it must resume at epoch 2), then the single-head IID+ CLI on the same
     tree, each with counts set to 0 just before and required to launch
     K1 and K2; and the learning guard of tests/test_seg_regression.py
     through the port's two-head CLI in f32 (SyntheticSegStripes3x64x256,
     8 epochs) at seeds 0-4: best eval acc >= 0.80 and >= 0.30 over the
     pre-eval in one run at least (a run's outcome hangs on its random
     draws, in the JAX package too; every run is printed); the
     K1 and K2 launches of these runs add to the table's; each phase's
     seconds are printed;
 11. run the port's experiment tool in-process at its default size (120 15
     128 10): the default run, ``ablate``, ``mmprobe``, ``v3``, ``v4``,
     ``v5``, ``v6``, ``kpad``, ``v8`` and ``v7``, counts set to 0 just
     before; from the records the tool returns, require every variant to
     report, none FAILED, finite times and errors, the exact ablations
     exact, X9 within 1e-5 mean of its float64 plain version, and at least
     one launch of X1-X9;
 12. profile steady head-A and head-B steps of both paths in f32 and in
     bf16: step time, device busy share and device time by kernel, and
     the kernels' share (chrome traces go to --trace_dir when it is
     given); print each step's device time by family in f32 beside bf16;
 13. the headline rate by bench.py's method (a log line, not a
     benchmark): model 555 at batch 120, heads A and B alternating full
     passes over one continuous stream, 2 warm and 4 timed passes between
     float(loss) barriers; aug-pairs/s and the ratio to the reference's
     33/4 a GPU, in f32 and bf16, each behind the prefetch thread at depth
     8 and without it; model 640's head-A wall a step in the same four
     settings;
 14. print the kernel table as one JSON line (each kernel's launches on
     its path, max error against its plain version, its time, the plain
     version's, the library call's and the bound), then the result line.
"""

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import time

N, HW, HALF_T = 120, 128, 10
KS = (15, 3)  # head A, head B
RTOL = 5e-3   # tests/test_pallas_kernels.py:95-96, :119-122
LIBS = ("seg_joint", "iid_loss", "joint_exp", "joint_exp_pipe",
        "joint_exp_bwd", "joint_exp_tma")
SOURCES = {"seg_joint_fwd": "iic_tpu_torch/csrc/seg_joint.cu",
           "seg_joint_dgrad": "iic_tpu_torch/csrc/seg_joint.cu",
           "iid_loss_fwd": "iic_tpu_torch/csrc/iid_loss.cu",
           "mm_probe": "iic_tpu_torch/csrc/joint_exp.cu",
           "joint_fwd_v2": "iic_tpu_torch/csrc/joint_exp.cu",
           "joint_fwd_v3": "iic_tpu_torch/csrc/joint_exp_tma.cu",
           "joint_fwd_v4": "iic_tpu_torch/csrc/joint_exp_tma.cu",
           "joint_fwd_v5": "iic_tpu_torch/csrc/joint_exp_tma.cu",
           "joint_fwd_v6": "iic_tpu_torch/csrc/joint_exp_tma.cu",
           "joint_fwd_v8": "iic_tpu_torch/csrc/joint_exp.cu",
           "dgrad_v8": "iic_tpu_torch/csrc/joint_exp_bwd.cu",
           "dgrad_fused_v7": "iic_tpu_torch/csrc/joint_exp_bwd.cu"}
REPLACES = {"seg_joint_fwd": "iic_tpu/ops/pallas/seg_joint_kernel.py:83",
            "seg_joint_dgrad": "iic_tpu/ops/pallas/seg_joint_kernel.py:191",
            "iid_loss_fwd": "iic_tpu/ops/pallas/iid_loss_kernel.py:34",
            "mm_probe": "tools/joint_kernel_exp.py:90",
            "joint_fwd_v2": "tools/joint_kernel_exp.py:140",
            "joint_fwd_v3": "tools/joint_kernel_exp.py:518",
            "joint_fwd_v4": "tools/joint_kernel_exp.py:253",
            "joint_fwd_v5": "tools/joint_kernel_exp.py:387",
            "joint_fwd_v6": "tools/joint_kernel_exp.py:810",
            "joint_fwd_v8": "tools/joint_kernel_exp.py:646",
            "dgrad_v8": "tools/joint_kernel_exp.py:729",
            "dgrad_fused_v7": "tools/joint_kernel_exp.py:929"}
X_PIPE = ("joint_fwd_v3", "joint_fwd_v4", "joint_fwd_v5", "joint_fwd_v6")
TOOL_KERNELS = ("mm_probe", "joint_fwd_v2", *X_PIPE, "joint_fwd_v8",
                "dgrad_v8", "dgrad_fused_v7")
# The H100 SXM's published peaks (NVIDIA's data sheet, dense): bf16 tensor
# cores, f32 on the CUDA cores, HBM3. The joint kernels (K1, K2, X1-X9)
# are bounded at the bf16 rate: the TPU kernels round their operands to
# bf16 and the kernels' contract (rtol 5e-3) admits it; the f32 figure is
# printed beside.
PEAK_BF16, PEAK_F32, HBM = 989e12, 67e12, 3.35e12
# Kernels whose resources and tensor-core instructions the build phase
# reports, by library: mangled-name key -> (tag, must use the tensor cores
# and spill nothing, registers it must use or None, must keep its products
# in flight). K1's CUDA-core form is held at 80 registers (its time hangs
# on the residency they allow); its tensor-core form, which X7 and X2's
# full mode share (instantiation 0 of its modes), X2's mm-only (1) and
# aligned-copies (2) instantiations and the TMA-fed forms of X3, X4, X5 / X6
# (the pair kernel) and X6's roll_build (its kRoll instantiation) must not
# wait for zero groups after every product (ptxas serialises the products
# when registers run short); X2's copies-only kernel issues no product.
# K2's tensor-core form is X8's kernel, built into K2's library.
SASS_KERNELS = {
    "seg_joint": {"joint_fwd_mma_kernel": ("K1", True, None, True),
                  "joint_partial_kernelI13__nv_bfloat16E":
                      ("K1 k<=4", False, 80, False),
                  "15dgrad_v8_kernel": ("K2", True, None, False),
                  "12dgrad_kernelI": ("K2 k<=4", False, None, False)},
    "joint_exp": {"mm_probe_partial_kernel": ("X1", True, None, False),
                  "joint_fwd_mma_kernelILi0E": ("X7 / X2 full", True, None,
                                                True),
                  "joint_fwd_mma_kernelILi1E": ("X2 mm-only", True, None,
                                                True),
                  "joint_fwd_mma_kernelILi2E": ("X2 aligned-copies", True,
                                                None, True),
                  "copies_only_kernel": ("X2 copies-only", False, None,
                                         False)},
    "iid_loss": {"iid_loss_cluster_kernel": ("K3", False, None, False),
                 "iid_loss_block_kernel": ("K3 block form", False, None,
                                           False)},
    "joint_exp_bwd": {"15dgrad_v8_kernel": ("X8", True, None, False),
                      "dgrad_fused_v7_kernel": ("X9", True, None, False)},
    "joint_exp_tma": {"joint_fwd_tma_kernel": ("X3", True, None, True),
                      "joint_fwd_tma_branch_kernel": ("X4", True, None,
                                                      True),
                      "joint_fwd_tma_pair_kernelILb0E": ("X5 / X6", True,
                                                         None, True),
                      "joint_fwd_tma_pair_kernelILb1E": ("X6 roll_build",
                                                         True, None, True)},
}
# The TMA-fed kernels' register ceiling (one block of 256 threads an SM,
# no spills), and the kernel whose A operand is rolled in registers: its
# SASS must hold lane shuffles and byte permutes
TMA_MAX_REGS = 200
ROLLED = "joint_fwd_tma_pair_kernelILb1E"
# K1's tensor-core kernel is one template instantiation in two libraries
# (K1's and X7's): their build reports must agree
SAME_BUILD = (("seg_joint", "joint_fwd_mma_kernel"),
              ("joint_exp", "joint_fwd_mma_kernelILi0E"))
X_RB = 16  # X1-X5, X7, X8 rb in the kernel table (the TPU tool's default)
X_RBS = (16, 32, 64)  # the rb of the tool's ablate and v8 runs
# X9 against its plain version: each p_v is rounded to bf16, so a last-bit
# difference in the f32 partial may move it across a rounding boundary:
# mean |d| / mean |ref| and max |d| / max |ref| (X8's unrounded pair is
# ~1.7e-3 off in the mean)
X9_MEAN, X9_MAX = 1e-5, 2e-3
# K2 against its own function in float64 (bf16 operands, exact products):
# f32 summation only, which the tensor cores accumulate truncating (toward
# zero) where FMAs round (1.03e-5 of max measured at k=15)
K2_F64 = 3e-5
# K1 against its own function in float64, the same: a joint's terms are
# all positive, so the truncation does not cancel and grows with a
# chunk's depth (8.2e-5 of max measured at 128-row chunks, k=15); the
# CUDA-core form rounds (2.6e-6)
K1_F64, K1_F64_FMA = 2e-4, 2e-5
K1_CHUNKS = (16, 32, 64, 128, 256, 512, 1024)  # chunk rows, error vs depth
TOOL_RUNS = {None: 8, "ablate": 12, "mmprobe": 4, "v3": 5, "v4": 1,
             "v5": 1, "v6": 2, "kpad": 2, "v8": 6,
             "v7": 2}  # run -> variants
# K3 at the clustering path's shapes (S sub-heads, bn, k): model 640's
# heads A and B, and the CIFAR20 overclustering head of model 579
K3_SHAPES = ((5, 660, 70), (5, 660, 10), (5, 1000, 140))
K3_STAGE = (5, 32, 70)  # head A's shape cut to one 32-row stage
K3_ROUNDS = 10  # alternating rounds of the wrapper in both forms
K3_LAMB = 1.0
# tests/test_pallas_kernels.py:34-37 (values) and :54-55 (gradients)
K3_RTOL = K3_ATOL = 1e-5
K3_GRAD_RTOL, K3_GRAD_ATOL = 1e-3, 1e-6
# P against max |P|: the block form against the f32 plain version (the
# same sums in the same order), the cluster form, which sums each entry in
# C row ranges, against the float64 plain version (the f32 plain version is
# itself 0.8-1.1e-6 of max off it at K3_SHAPES)
K3_P_REL = 1e-6

CLI_ARGS = [
    "--mode", "IID", "--dataset", "SyntheticSeg3x146x480",
    "--dataset_root", "", "--arch", "SegmentationNet10aTwoHead",
    "--lamb_A", "1.0", "--lamb_B", "1.5", "--num_sub_heads", "1",
    "--batch_sz", "120", "--num_dataloaders", "1", "--output_k_A", "15",
    "--output_k_B", "3", "--gt_k", "3", "--input_sz", "128",
    "--half_T_side_sparse_min", "0", "--half_T_side_sparse_max", "0",
    "--half_T_side_dense", "10", "--include_rgb", "--use_uncollapsed_loss",
    "--batchnorm_track", "--test_code", "--num_epochs", "2"]

# CIFAR10 model 640 (examples/commands.md:26-39) with --fused_loss, on the
# synthetic set of CIFAR's image size and class count
CLUSTER_CLI_ARGS = [
    "--model_ind", "640", "--arch", "ClusterNet5gTwoHead", "--mode", "IID",
    "--dataset", "Synthetic10x32x3", "--dataset_root", "", "--gt_k", "10",
    "--output_k_A", "70", "--output_k_B", "10", "--lamb", "1.0",
    "--lr", "0.0001", "--num_epochs", "2000", "--batch_sz", "660",
    "--num_dataloaders", "3", "--num_sub_heads", "5", "--crop_orig",
    "--rand_crop_sz", "20", "--input_sz", "32", "--head_A_first",
    "--head_B_epochs", "2", "--double_eval", "--batchnorm_track",
    "--fused_loss", "--test_code"]


def _log(msg):
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # cuDNN convs (the trunk) in TF32, matmuls in full f32: the same
    # choice the trainer makes (iic_tpu_torch/train/seg_trainer.py)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    _log(f"device: {name}, count {torch.cuda.device_count()}, "
         f"torch {torch.__version__}, cuda {torch.version.cuda}")
    _log(smi)
    return name, smi


def _clocks(tag):
    """Logs the card's SM clock, its maximum, power draw and temperature
    before a phase: a card held below its clock reads slower in every
    later time."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True)
    _log(f"clocks before {tag}: {(smi.stdout or smi.stderr).strip()}")


def phase_build():
    """Build every kernel source at once, one nvcc each (ptxas prints each
    kernel's registers, shared memory and spills), then report, from the
    built libraries, the registers, stack and local memory of K1 and of the
    tensor-core kernels and the count of tensor-core instructions in each
    of those kernels' SASS (and of TMA loads, lane shuffles and byte
    permutes in the TMA-fed ones); fail if K1's CUDA-core form leaves its
    80 registers, a tensor-core kernel has no such instruction or spills,
    a kernel that must keep its products in flight (K1's stack product
    and its X2 modes, the TMA-fed kernels) has them serialised, K1's stack
    product builds differently in K1's and X7's libraries, a TMA-fed
    kernel has no TMA load or passes TMA_MAX_REGS registers, or X6's
    roll_build kernel no shuffle or permute."""
    from concurrent.futures import ThreadPoolExecutor
    from iic_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBS)) as pool:
        list(pool.map(_build.library, LIBS))
    _log(f"build: {', '.join(LIBS)} in {time.perf_counter() - t0:.2f} s "
         + ", ".join(f"(nvcc {n} {_build.BUILD_SECONDS[n]:.2f} s)"
                     for n in LIBS))
    cuobjdump = _build.cuda_tool("cuobjdump")
    reports = {}
    for lib, kernels in SASS_KERNELS.items():
        path = str(_build.LIB_PATHS[lib])
        usage = _resource_usage(subprocess.run(
            [cuobjdump, "--dump-resource-usage", path], capture_output=True,
            text=True, check=True).stdout)
        counts = _mma_counts(subprocess.run(
            [cuobjdump, "--dump-sass", path], capture_output=True, text=True,
            check=True).stdout)
        for key, (tag, tensor_cores, want_regs, pipelined) in kernels.items():
            names = [f for f in counts if key in f]
            if not names:
                raise AssertionError(f"no kernel {key} in lib{lib}'s SASS")
            for f in names:
                if f not in usage:
                    raise AssertionError(f"no resource usage for {f} in "
                                         f"lib{lib}")
                use, mma = usage[f], counts[f]
                reports[(lib, key)] = (use["REG"], use.get("LOCAL", 0),
                                       mma["HGMMA"], mma["DEPBAR"],
                                       mma["DEPBAR0"])
                _log(f"  {tag} {f}: {use['REG']} registers, stack "
                     f"{use.get('STACK', '?')} bytes, local "
                     f"{use.get('LOCAL', '?')} bytes; SASS HGMMA "
                     f"{mma['HGMMA']}, HMMA {mma['HMMA']}, WARPGROUP.DEPBAR "
                     f"{mma['DEPBAR']} ({mma['DEPBAR0']} for zero groups)"
                     + (f", TMA loads (UTMALDG) {mma['UTMALDG']}, SHFL "
                        f"{mma['SHFL']}, PRMT {mma['PRMT']}"
                        if lib == "joint_exp_tma" else ""))
                if pipelined and mma["DEPBAR0"] >= mma["HGMMA"]:
                    raise AssertionError(f"{tag} {f} waits for zero groups "
                                         f"after every product: ptxas "
                                         f"serialised them")
                if tensor_cores and mma["HGMMA"] + mma["HMMA"] == 0:
                    raise AssertionError(f"{tag} {f} has no tensor-core "
                                         f"instruction in its SASS")
                if tensor_cores and use.get("LOCAL", 0) != 0:
                    raise AssertionError(f"{tag} {f} spills: "
                                         f"{use['LOCAL']} bytes of local "
                                         f"memory")
                if want_regs is not None and use["REG"] != want_regs:
                    raise AssertionError(f"{tag} {f} uses {use['REG']} "
                                         f"registers, not {want_regs}")
                if lib == "joint_exp_tma" and mma["UTMALDG"] == 0:
                    raise AssertionError(f"{tag} {f} has no TMA load in its "
                                         f"SASS")
                if lib == "joint_exp_tma" and use["REG"] > TMA_MAX_REGS:
                    raise AssertionError(f"{tag} {f} uses {use['REG']} "
                                         f"registers, over {TMA_MAX_REGS}")
                if key == ROLLED and not (mma["SHFL"] and mma["PRMT"]):
                    raise AssertionError(f"{tag} {f} does not roll A in "
                                         f"registers: SHFL {mma['SHFL']}, "
                                         f"PRMT {mma['PRMT']}")
    from iic_tpu_torch.ops.kernels import iid_loss as k3
    lib = k3._lib()
    _log(f"  K3 dynamic shared memory a block (bytes), cluster form "
         f"({k3.CLUSTER} blocks a sub-head) / block form: " + ", ".join(
             f"k={k} {lib.iid_loss_smem(k, k3.CLUSTER)} / "
             f"{lib.iid_loss_smem(k, 0)}"
             for k in (10, 70, 140, lib.iid_loss_max_k())))
    if reports[SAME_BUILD[0]] != reports[SAME_BUILD[1]]:
        raise AssertionError(f"K1's tensor-core kernel builds differently in "
                             f"K1's and X7's libraries: "
                             f"{[reports[b] for b in SAME_BUILD]}")


def _resource_usage(dump):
    """{mangled kernel: {"REG": n, "STACK": n, "LOCAL": n, ...}} from
    ``cuobjdump --dump-resource-usage``: each function's line of KEY:value
    fields follows its name."""
    usage, fn = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function ([^\s:]+)", line)
        if m:
            fn = m.group(1)
        fields = dict(re.findall(r"\b([A-Z]+):(\d+)", line))
        if fn and "REG" in fields:
            usage[fn] = {key: int(v) for key, v in fields.items()}
    return usage


def _mma_counts(sass):
    """{mangled kernel: {"HGMMA": n, "HMMA": n, "DEPBAR": n, "DEPBAR0": n,
    "UTMALDG": n, "SHFL": n, "PRMT": n}}: the warpgroup (wgmma) and
    warp-level tensor-core instructions in each function of a SASS dump,
    the waits on wgmma groups (`WARPGROUP.DEPBAR`), those of them that wait
    for zero groups in flight (one of those per HGMMA means ptxas
    serialised the products), the TMA loads, and the lane shuffles and
    byte permutes (X6's roll_build)."""
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "DEPBAR": 0, "DEPBAR0": 0,
                          "UTMALDG": 0, "SHFL": 0, "PRMT": 0}
        elif fn and "UTMALDG" in line:
            counts[fn]["UTMALDG"] += 1
        elif fn and re.search(r"\bSHFL\.", line):
            counts[fn]["SHFL"] += 1
        elif fn and re.search(r"\bPRMT\b", line):
            counts[fn]["PRMT"] += 1
        elif fn and "HGMMA" in line:
            counts[fn]["HGMMA"] += 1
        elif fn and "HMMA" in line:
            counts[fn]["HMMA"] += 1
        elif fn and "WARPGROUP.DEPBAR" in line:
            counts[fn]["DEPBAR"] += 1
            if re.search(r"gsb0, 0x0\b", line):
                counts[fn]["DEPBAR0"] += 1
    return counts


def _time_ms(fn, reps=5):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check(tag, got, ref, rtol, atol):
    """Max abs error of ``got``; raises unless |got - ref| <= atol + rtol
    |ref| everywhere."""
    import torch
    err = float((got - ref).abs().max())
    ok = bool(torch.all((got - ref).abs() <= atol + rtol * ref.abs()))
    _log(f"  {tag}: max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:.3e}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{tag} disagrees with its plain version")
    return err


def _joint_flop(n, k, h, w, half_t):
    """FLOP the displacement joint needs (K1, X2; each K2 call the same):
    2 n k^2 S_h S_w, S_h = sum over the T shifts d of the h - |d| rows in
    the frame (S_w the same for columns). The kernels also multiply the
    zeros outside the frame; those products are not counted."""
    def in_frame(size):
        return sum(max(size - abs(d), 0) for d in range(-half_t, half_t + 1))
    return 2.0 * n * k * k * in_frame(h) * in_frame(w)


def _compare(tag, got, ref):
    """The JAX package's K1/K2 contract: rtol 5e-3, atol 5e-3 * max |ref|."""
    return _check(tag, got, ref, RTOL, RTOL * float(ref.abs().max()))


def _softmax_pair(gen, k):
    import torch

    def one():
        z = torch.randn((N, k, HW, HW), device="cuda", generator=gen)
        return torch.softmax(z, dim=1).contiguous()
    return one(), one()


def phase_kernels():
    """K1 and K2 against their plain versions at the main path's shapes;
    both forms of each also against its own function in float64 (bf16
    operands, exact products), K1 within K1_F64 (K1_F64_FMA on the CUDA
    cores) and K2 within K2_F64 of max, and K2 bit-equal to X8 where it
    runs X8's kernel; K1's error and time against its chunk depth; times of
    both forms of K1 and K2, the plain versions (f32 convs) and the bf16
    cuDNN conv computing each one's function. Returns {kernel:
    {"max_abs_err", "ms", "plain_ms", "library_ms", ...}} (ms at head A's
    k=15 in the path's form; the k=3 numbers are printed)."""
    import torch
    import torch.nn.functional as F
    from iic_tpu_torch.ops.kernels import joint_exp as jx
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {name: {"max_abs_err": 0.0} for name in REPLACES}
    for k in KS:
        t = 2 * HALF_T + 1

        x1, x2 = _softmax_pair(gen, k)
        g = torch.randn((k, k, t, t), device="cuda", generator=gen)
        g2d, g2d_swap = sj.adjoints(g)
        form = sj.k2_form(k, HALF_T)
        other_form = next(f for f in sj.K2_FORMS if f != form)
        k1_form = sj.k1_form(k, HALF_T)
        k1_other = next(f for f in sj.K1_FORMS if f != k1_form)
        _log(f"k={k}: n={N}, {HW}x{HW}, T={t}; K1 form {k1_form}, K2 form "
             f"{form}")

        got = sj.joint_fwd(x1, x2, HALF_T)
        ref = sj.displacement_joint_dense(x1, x2, HALF_T)
        torch.cuda.synchronize()
        e_fwd = _compare("K1 joint", got, ref)
        # K1's function on the card: bf16 operands, exact products, f32 sums
        ref64 = sj.joint_fwd_bf16_plain(x1.double(), x2.double(), HALF_T)
        scale64, scale = float(ref64.abs().max()), float(ref.abs().max())
        for tag, f in ((k1_form, got), (k1_other, sj.joint_fwd(
                x1, x2, HALF_T, form=k1_other))):
            tol = K1_F64 if tag == "wgmma" else K1_F64_FMA
            e64 = float((f.double() - ref64).abs().max()) / scale64
            ok = e64 <= tol
            _log(f"  K1 {tag} vs float64 of its bf16 operands: max err / "
                 f"max|ref| {e64:.3e} (<= {tol:g}) {'ok' if ok else 'FAIL'};"
                 f" vs the f32 conv {float((f - ref).abs().max()) / scale:.3e}")
            if not ok:
                raise AssertionError(f"K1 {tag} is off its bf16 function")
            e_fwd = max(e_fwd, _compare(f"K1 {tag} vs the f32 conv", f, ref))
        if k == KS[0]:
            _k1_depth(x1, x2, ref64, scale64)
            _kernel_parts("K1", lambda: sj.joint_fwd(x1, x2, HALF_T))
        del ref64
        got1 = sj.joint_dgrad(g2d, x2, HALF_T)
        ref1 = sj.dgrad_plain(g2d, x2, HALF_T)
        got2 = sj.joint_dgrad(g2d_swap, x1, HALF_T)
        ref2 = sj.dgrad_plain(g2d_swap, x1, HALF_T)
        torch.cuda.synchronize()
        e_bwd = max(_compare("K2 dx1", got1, ref1),
                    _compare("K2 dx2", got2, ref2))
        del got, ref, ref1, got2, ref2
        # K2's function on the card: bf16 operands, exact products, f32 sums
        ref64 = jx.dgrad_v8_plain(g2d.double(), x2.double(), HALF_T)
        scale = float(ref64.abs().max())
        for tag, f in ((form, got1), (other_form, sj.joint_dgrad(
                g2d, x2, HALF_T, form=other_form))):
            e64 = float((f.double() - ref64).abs().max()) / scale
            ok = e64 <= K2_F64
            _log(f"  K2 {tag} dx1 vs float64 of its bf16 operands: max err "
                 f"/ max|ref| {e64:.3e} (<= {K2_F64:g}) "
                 f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 {tag} is off its bf16 function")
        del ref64
        if form == "wgmma":
            same = torch.equal(got1, jx.dgrad_v8(g2d, x2, HALF_T, X_RB))
            _log(f"  K2 dx1 equals X8 (rb={X_RB}) bit for bit: {same}")
            if not same:
                raise AssertionError("K2 differs from X8 on its operands")
        del got1
        _f64_errors(k, x1, x2, g2d)

        x1b, x2b = x1.bfloat16(), x2.bfloat16()
        gf = g.flip(2, 3).bfloat16().contiguous()
        k1_other_ms = _time_ms(lambda: sj.joint_fwd(x1, x2, HALF_T,
                                                     form=k1_other))
        times = {
            "seg_joint_fwd": (
                _time_ms(lambda: sj.joint_fwd(x1, x2, HALF_T)),
                _time_ms(lambda: sj.displacement_joint_dense(x1, x2,
                                                             HALF_T)),
                _time_ms(lambda: F.conv2d(x1b.transpose(0, 1),
                                          x2b.transpose(0, 1),
                                          padding=HALF_T))),
            "seg_joint_dgrad": (
                _time_ms(lambda: sj.joint_dgrad(g2d, x2, HALF_T)),
                _time_ms(lambda: sj.dgrad_plain(g2d, x2, HALF_T)),
                _time_ms(lambda: F.conv2d(x2b, gf, padding=HALF_T))),
        }
        other_ms = _time_ms(lambda: sj.joint_dgrad(g2d, x2, HALF_T,
                                                   form=other_form))
        for name, (ms, plain_ms, lib_ms) in times.items():
            _log(f"  {name} k={k}: kernel {ms:.3f} ms, plain (f32 "
                 f"F.conv2d) {plain_ms:.3f} ms, bf16 F.conv2d {lib_ms:.3f} "
                 f"ms (CUDA events, mean of 5)")
        k1_ms, _, k1_lib = times["seg_joint_fwd"]
        _log(f"  K1 k={k} forms: {k1_form} {k1_ms:.3f} ms (the path's), "
             f"{k1_other} {k1_other_ms:.3f} ms; "
             f"{'faster' if k1_ms < k1_lib else 'SLOWER'} than one bf16 "
             f"F.conv2d ({k1_lib:.3f} ms)")
        k2_ms, _, k2_lib = times["seg_joint_dgrad"]
        _log(f"  K2 k={k} forms: {form} {k2_ms:.3f} ms (the path's), "
             f"{other_form} {other_ms:.3f} ms; "
             f"{'faster' if k2_ms < k2_lib else 'SLOWER'} than one bf16 "
             f"F.conv2d ({k2_lib:.3f} ms)")
        stats["seg_joint_fwd"]["max_abs_err"] = max(
            stats["seg_joint_fwd"]["max_abs_err"], e_fwd)
        stats["seg_joint_dgrad"]["max_abs_err"] = max(
            stats["seg_joint_dgrad"]["max_abs_err"], e_bwd)
        if k == KS[0]:
            flop = _joint_flop(N, k, HW, HW, HALF_T)
            in_bytes = 2 * x1.numel() * 4
            for name, (ms, plain_ms, lib_ms) in times.items():
                stats[name].update(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms)
                stats[name].update(_bound(name, flop, in_bytes
                                          + (k * t) ** 2 * 4, PEAK_BF16))
        del x1, x2, x1b, x2b
        torch.cuda.empty_cache()
    return stats


def _k1_depth(x1, x2, ref64, scale64):
    """K1's tensor-core form (its launcher, past the wrapper) at each chunk
    depth of K1_CHUNKS: its error against its bf16 function in float64
    (the tensor cores' f32 sums truncate, and a joint's terms do not
    cancel) and its time."""
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    n, k, h, w = x1.shape
    for rows in K1_CHUNKS:
        per, splits = sj.k1_plan(n, k, h, HALF_T, sj.K1_RB, rows)
        def call():
            return sj.launch_joint_fwd_mma(sj._lib().seg_joint_fwd, x1, x2,
                                           HALF_T, sj.K1_RB, rows)
        err = float((call().double() - ref64).abs().max()) / scale64
        ms = _time_ms(call)
        _log(f"  K1 wgmma chunk of {per * sj.K1_RB} rows ({splits} chunks, "
             f"{per * sj.K1_RB * -(-w // 16)} k16 steps): max err / max|ref| "
             f"{err:.3e}, {ms:.3f} ms"
             + (" (the default)" if rows == sj.K1_CHUNK_ROWS else ""))


def _kernel_parts(tag, call, calls=5):
    """Device time of each kernel one ``call`` launches, from
    torch.profiler over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    parts = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    _log(f"  {tag}'s kernels, device ms a call (torch.profiler, mean of "
         f"{calls}): " + ", ".join(
             f"{_kernel_name(e.key)} x{e.count // calls} "
             f"{e.self_device_time_total / calls / 1e3:.4f}"
             for e in sorted(parts, key=lambda e: -e.self_device_time_total)))


def _alternate(calls, rounds, reps=5):
    """Times each of ``calls`` ({tag: fn}) in turn, ``rounds`` times (a
    reading is CUDA events, mean of ``reps``), and logs each one's median,
    min and max reading and, past the first, those of its ratio to the
    first's reading of the same round."""
    import statistics
    ms = {tag: [] for tag in calls}
    for _ in range(rounds):
        for tag, fn in calls.items():
            ms[tag].append(_time_ms(fn, reps))
    first = next(iter(calls))
    for tag, v in ms.items():
        line = (f"    {tag}: median {statistics.median(v):.4f}, min "
                f"{min(v):.4f}, max {max(v):.4f} ms")
        if tag != first:
            r = [a / b for a, b in zip(v, ms[first])]
            line += (f"; / {first}: median {statistics.median(r):.4f}, min "
                     f"{min(r):.4f}, max {max(r):.4f}")
        _log(line)


def _kernel_name(key):
    """A kernel's bare name from a profiler key such as ``void
    (anonymous namespace)::f<float>(float const*, ...)``."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0].split("<")[0].split("::")[-1]


def phase_k3():
    """K3 against its plain version at the clustering path's shapes: loss,
    loss_nl, P and the autograd gradients within the JAX package's kernel
    contract, in the cluster form (the default) and the block form; the
    cluster form's bits equal across launches and, sub-head by sub-head,
    to a launch on that sub-head alone; errors against a float64 plain
    version; CUDA-event times of the kernel (both forms) and the plain
    version, forward and forward + backward; the wrapper in both forms in
    alternating rounds, by CUDA events and by its host time a call; then
    ``_k3_readings``. Returns {"max_abs_err", "ms",
    "plain_ms", ...} (ms: the wrapper's CUDA-event time in the default
    form at head A's shape; every time is printed)."""
    import statistics

    import torch
    from iic_tpu_torch.ops.kernels import iid_loss as k3

    gen = torch.Generator(device="cuda").manual_seed(1)
    stats = {"max_abs_err": 0.0}
    for s, bn, k in K3_SHAPES:
        def softmax():
            return torch.softmax(torch.randn((s, bn, k), device="cuda",
                                             generator=gen), dim=-1)
        z, zt = softmax(), softmax()
        _log(f"K3 S={s}, bn={bn}, k={k}:")
        ref = k3.iid_loss_fused_plain(z, zt, K3_LAMB)
        ref64 = k3.iid_loss_fused_plain(z.double(), zt.double(), K3_LAMB)
        for form in k3.FORMS:
            got = k3.iid_loss_fwd(z, zt, K3_LAMB, form=form)
            # P: the block form sums each entry over the rows in the f32
            # plain version's order (its bits), the cluster form in C
            # ranges added in rank order, so it is held to P in float64
            p_ref = ref64[2] if form == "cluster" else ref[2]
            errs = [_check(f"{form} loss", got[0], ref[0], K3_RTOL,
                           K3_ATOL),
                    _check(f"{form} loss_nl", got[1], ref[1], K3_RTOL,
                           K3_ATOL),
                    _check(f"{form} P"
                           + (" (vs float64)" if form == "cluster" else ""),
                           got[2], p_ref, 0.0,
                           K3_P_REL * float(p_ref.abs().max())),
                    _check(f"{form} total", got[3], ref[3], K3_RTOL, 0.0)]
            if form == "cluster":
                stats["max_abs_err"] = max(stats["max_abs_err"], *errs[:3])
        got = k3.iid_loss_fwd(z, zt, K3_LAMB)
        again = k3.iid_loss_fwd(z, zt, K3_LAMB)
        alone = [k3.iid_loss_fwd(z[i], zt[i], K3_LAMB) for i in range(s)]
        if not (all(torch.equal(a, b) for a, b in zip(got, again))
                and all(torch.equal(a[i], b) for i in range(s)
                        for a, b in zip(got, alone[i]))):
            raise AssertionError("K3's cluster form differs between "
                                 "launches, or a sub-head alone from the "
                                 "batch")
        _log("  cluster form: equal bits on a second launch and for each "
             "sub-head launched alone")
        for name, i in (("loss", 0), ("P", 2)):
            scale = float(ref64[i].abs().max())
            e_k, e_p = (float((v[i].double() - ref64[i]).abs().max()) / scale
                        for v in (got, ref))
            _log(f"  {name} vs float64: max err / max|ref| kernel {e_k:.3e}"
                 f", plain f32 {e_p:.3e}")

        zr = z.clone().requires_grad_()
        ztr = zt.clone().requires_grad_()
        weights = torch.linspace(0.5, 1.5, s, device="cuda")

        def fwd_bwd(fn):
            loss, nl = fn(zr, ztr, K3_LAMB)[:2]
            return torch.autograd.grad((weights * loss).sum() - 0.3 * nl.sum(),
                                       (zr, ztr))

        g_kernel = fwd_bwd(k3.iid_loss_fused)
        g_plain = fwd_bwd(k3.iid_loss_fused_plain)
        for name, a, b in zip(("dz", "dzt"), g_kernel, g_plain):
            _check(f"grad {name}", a, b, K3_GRAD_RTOL, K3_GRAD_ATOL)

        times = (
            _time_ms(lambda: k3.iid_loss_fwd(z, zt, K3_LAMB), reps=50),
            _time_ms(lambda: k3.iid_loss_fused_plain(z, zt, K3_LAMB),
                     reps=50),
            _time_ms(lambda: fwd_bwd(k3.iid_loss_fused), reps=50),
            _time_ms(lambda: fwd_bwd(k3.iid_loss_fused_plain), reps=50),
            _time_ms(lambda: k3.iid_loss_fwd(z, zt, K3_LAMB, form="block"),
                     reps=50))
        _log(f"  iid_loss_fwd S={s} bn={bn} k={k}: forward kernel "
             f"{times[0]:.4f} ms (block form {times[4]:.4f}), plain "
             f"{times[1]:.4f} ms; forward+backward kernel {times[2]:.4f} "
             f"ms, plain {times[3]:.4f} ms (CUDA events, mean of 50)")
        wrapper = {form: (lambda form=form: k3.iid_loss_fwd(
            z, zt, K3_LAMB, form=form)) for form in k3.FORMS}
        _log(f"  iid_loss_fwd in {K3_ROUNDS} alternating rounds (CUDA "
             f"events, mean of 50):")
        _alternate(wrapper, K3_ROUNDS, reps=50)
        host = {form: [] for form in wrapper}
        for _ in range(K3_ROUNDS):
            for form, fn in wrapper.items():
                host[form].append(_host_ms(fn))
        _log(f"  iid_loss_fwd host time a call (perf_counter over 50 calls, "
             f"no sync), median of {K3_ROUNDS} alternating rounds: "
             + ", ".join(f"{f} {statistics.median(v):.4f} ms"
                         for f, v in host.items()))
        if (s, bn, k) == K3_SHAPES[0]:
            # the zT z' product; the k x k epilogue adds about 2% to it
            stats.update(ms=times[0], plain_ms=times[1], library_ms=None)
            stats.update(_bound("iid_loss_fwd", 2.0 * s * bn * k * k,
                                (2 * s * bn * k + s * k * k + 3 * s) * 4,
                                PEAK_F32))
    _k3_readings(gen)
    return stats


def _host_ms(fn, reps=50):
    """Host time a call of ``fn`` (perf_counter, no sync inside the loop)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - start) / reps * 1e3
    torch.cuda.synchronize()
    return host


def _k3_readings(gen):
    """K3's entry point called through ctypes on preallocated outputs (no
    wrapper), in the block form and the cluster form, at K3_SHAPES and at
    K3_STAGE (head A's shape cut to one 32-row stage: the difference is the
    row loop), and an empty kernel launched on each form's grid and stream
    by the same route (the launch floor); CUDA events, mean of 50, then
    each call's device time by the profiler."""
    import torch
    from iic_tpu_torch.ops.kernels import iid_loss as k3

    lib = k3._lib()
    launches = {"block": 0, f"cluster {k3.CLUSTER}": k3.CLUSTER}
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for s, bn, k in (*K3_SHAPES, K3_STAGE):
        z, zt = (torch.softmax(torch.randn((s, bn, k), device="cuda",
                                           generator=gen), dim=-1)
                 for _ in range(2))
        out = torch.empty(3 * s + s * k * k, device="cuda")
        ptrs = [out.data_ptr() + 4 * o for o in (0, s, 2 * s, 3 * s)]
        for tag, cluster in launches.items():
            def call(z=z, zt=zt, ptrs=ptrs, s=s, bn=bn, k=k,
                     cluster=cluster):
                err = lib.iid_loss_fwd(z.data_ptr(), zt.data_ptr(), ptrs[0],
                                       ptrs[1], ptrs[3], ptrs[2], s, bn, k,
                                       K3_LAMB, cluster, stream)
                if err:
                    raise RuntimeError(f"iid_loss_fwd: CUDA error {err}")
            calls[f"K3 {tag} S={s} bn={bn} k={k}"] = call
    s = K3_SHAPES[0][0]
    for tag, cluster in launches.items():
        def floor(cluster=cluster):
            err = lib.iid_loss_launch_floor(s, cluster, stream)
            if err:
                raise RuntimeError(f"launch floor: CUDA error {err}")
        calls[f"empty kernel, {tag} grid S={s}"] = floor
    _log("K3 readings (entry point through ctypes, outputs preallocated; "
         "CUDA events, mean of 50):")
    readings = {tag: _time_ms(fn, reps=50) for tag, fn in calls.items()}
    for tag, ms in readings.items():
        _log(f"  {tag}: {ms:.4f} ms")
    for tag, fn in calls.items():
        _kernel_parts(tag, fn, calls=50)


def _bound(name, flop, nbytes, peak):
    """bound_ms: the larger of ``flop`` at ``peak`` and ``nbytes`` at the
    HBM rate; printed with the f32 CUDA-core figure beside."""
    ops_ms, bytes_ms = flop / peak * 1e3, nbytes / HBM * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    _log(f"  bound {name}: {flop:.3e} FLOP, {nbytes:.3e} bytes -> "
         f"{max(ops_ms, bytes_ms):.4f} ms ({by}; at the f32 CUDA-core peak "
         f"{max(flop / PEAK_F32 * 1e3, bytes_ms):.4f} ms)")
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": by}


def phase_x2():
    """X2 against its plain version in every mode at the segmentation
    shapes (mm-only and copies-only exactly, aligned-copies also exactly
    one joint broadcast over (u, v)); at k=15 its full and rank3 bit-equal
    to X7's tensor-core form at rb 16, 32 and 64; full's error against
    float64; the times of every mode, X7's tensor-core form, the plain
    version and a bf16 cuDNN conv of the same activations-as-filters
    joint. Returns the table stats (at head A's k=15, mode full)."""
    import torch
    import torch.nn.functional as F
    from iic_tpu_torch.ops.kernels import joint_exp as jx
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    gen = torch.Generator(device="cuda").manual_seed(2)
    stats = {"max_abs_err": 0.0}
    t = 2 * HALF_T + 1
    for k in KS:
        x1, x2 = _softmax_pair(gen, k)
        x1b, x2b = x1.bfloat16(), x2.bfloat16()
        _log(f"X2 k={k}: n={N}, {HW}x{HW}, T={t}, rb={X_RB}, bf16 inputs")
        for mode in jx.MODES:
            got = jx.joint_fwd_v2(x1b, x2b, HALF_T, mode, X_RB)
            ref = jx.joint_fwd_v2_plain(x1b, x2b, HALF_T, mode, X_RB)
            torch.cuda.synchronize()
            if mode in ("mm-only", "copies-only"):
                err = float((got - ref).abs().max())
                _log(f"  {mode}: max_abs_err {err:.3e} (exact) "
                     f"{'ok' if err == 0 else 'FAIL'}")
                if err != 0:
                    raise AssertionError(f"X2 {mode} disagrees with its "
                                         f"plain version")
                continue
            err = _compare(mode, got, ref)
            if mode == "full":
                stats["max_abs_err"] = max(stats["max_abs_err"], err)
            if mode == "aligned-copies" and not torch.equal(
                    got, got[:, :, :1, :1].expand_as(got)):
                raise AssertionError("X2 aligned-copies is not one joint "
                                     "broadcast over (u, v)")
        if k == KS[0]:
            for rb in X_RBS:
                x7 = jx.joint_fwd_v8(x1b, x2b, HALF_T, rb, form="wgmma")
                for mode in ("full", "rank3"):
                    if not torch.equal(jx.joint_fwd_v2(
                            x1b, x2b, HALF_T, mode, rb), x7):
                        raise AssertionError(f"X2 {mode} rb={rb} differs "
                                             f"from X7's wgmma form")
            _log(f"  full and rank3 equal X7 (wgmma) bit for bit at rb "
                 f"{X_RBS}")
        ref64 = sj.displacement_joint_dense(x1b.double(), x2b.double(),
                                            HALF_T)
        p = jx.joint_fwd_v2(x1b, x2b, HALF_T, rb=X_RB).double()
        _log(f"  full vs float64 of its bf16 inputs: max err / max|ref| "
             f"{float((p - ref64).abs().max() / ref64.abs().max()):.3e}")
        del p, ref64

        def library():
            return F.conv2d(x1b.transpose(0, 1), x2b.transpose(0, 1),
                            padding=HALF_T)
        lib_err = float((library().float()
                         - jx.joint_fwd_v2_plain(x1b, x2b, HALF_T)).abs().max())
        times = {mode: _time_ms(lambda m=mode: jx.joint_fwd_v2(
                     x1b, x2b, HALF_T, m, X_RB))
                 for mode in ("full", "mm-only", "copies-only",
                              "aligned-copies")}
        x7_ms = _time_ms(lambda: jx.joint_fwd_v8(x1b, x2b, HALF_T, X_RB,
                                                 form="wgmma"))
        plain_ms = _time_ms(lambda: jx.joint_fwd_v2_plain(x1b, x2b, HALF_T))
        library_ms = _time_ms(library)
        _log(f"  joint_fwd_v2 k={k}: kernel "
             + ", ".join(f"{m} {ms:.3f}" for m, ms in times.items())
             + " ms")
        _log(f"  in the same phase X7 (wgmma) {x7_ms:.3f} ms (X2 full at "
             f"{times['full'] / x7_ms:.3f}x it); plain {plain_ms:.3f} ms; "
             f"bf16 F.conv2d {library_ms:.3f} ms (its max abs err vs plain "
             f"{lib_err:.3e}) (CUDA events, mean of 5)")
        if k == KS[0]:
            stats.update(ms=times["full"], plain_ms=plain_ms,
                         library_ms=library_ms)
            stats.update(_bound("joint_fwd_v2",
                                _joint_flop(N, k, HW, HW, HALF_T),
                                2 * x1b.numel() * 2 + (k * t) ** 2 * 4,
                                PEAK_BF16))
        del x1, x2, x1b, x2b
        torch.cuda.empty_cache()
    return stats


def phase_x1():
    """X1 at the segmentation shapes, both forms, against its plain version
    (every entry the count of terms issued, under 2^24 here, so exact);
    times of the kernel, its plain version and one bf16 torch.matmul of the
    same (kT x K) @ (K x kT) product. Returns the table stats (k=15,
    mk-nk)."""
    import torch
    from iic_tpu_torch.ops.kernels import joint_exp as jx

    stats = {"max_abs_err": 0.0}
    t = 2 * HALF_T + 1
    for k in KS:
        tk = k * t
        depth = jx.probe_passes(N, HW, HALF_T, X_RB) * 8 * X_RB
        a = torch.randn((tk, depth), device="cuda", dtype=torch.bfloat16)
        b = {"mk-nk": torch.randn((tk, depth), device="cuda",
                                  dtype=torch.bfloat16)}
        b["mk-kn"] = b["mk-nk"].t().contiguous()
        ref = jx.mm_probe_plain(N, k, HW, HALF_T, X_RB, "cuda")
        for form in jx.FORMS:
            out = jx.mm_probe(N, k, HW, HALF_T, X_RB, form, "cuda")
            err = float((out - ref).abs().max())
            _log(f"X1 k={k} {form}: ({tk}, {tk}) over K={depth}, every entry "
                 f"{float(ref[0, 0]):.0f} terms; max_abs_err {err:.1e} "
                 f"(exact) {'ok' if err == 0 else 'FAIL'}")
            if out.shape != (tk, tk) or err != 0:
                raise AssertionError(f"X1 {form} disagrees with its plain "
                                     f"version")
            bb = b[form].t() if form == "mk-nk" else b[form]
            ms = _time_ms(lambda f=form: jx.mm_probe(N, k, HW, HALF_T, X_RB,
                                                     f, "cuda"))
            plain_ms = _time_ms(lambda: jx.mm_probe_plain(
                N, k, HW, HALF_T, X_RB, "cuda"))
            library_ms = _time_ms(lambda: torch.matmul(a, bb))
            _log(f"  mm_probe k={k} {form}: kernel {ms:.3f} ms, plain "
                 f"{plain_ms:.4f} ms, bf16 torch.matmul {library_ms:.3f} ms "
                 f"(CUDA events, mean of 5)")
            if k == KS[0] and form == "mk-nk":
                stats.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
                stats.update(_bound("mm_probe", 2.0 * tk * tk * depth,
                                    tk * tk * 4, PEAK_BF16))
        del a, b
        torch.cuda.empty_cache()
    return stats


def phase_x7():
    """X7 in both forms against its plain version at the segmentation
    shapes for each rb, bit-equal to K1 on the same bf16 operands in the
    tensor-core form (the same kernel and chunks), its errors against
    float64, and its times in both forms beside K1's and X2's and the bf16
    cuDNN conv of the same joint. Returns the table stats (k=15, rb=16, the
    form K1 takes there)."""
    import torch
    import torch.nn.functional as F
    from iic_tpu_torch.ops.kernels import joint_exp as jx
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    gen = torch.Generator(device="cuda").manual_seed(3)
    stats = {"max_abs_err": 0.0}
    t = 2 * HALF_T + 1
    for k in KS:
        x1, x2 = _softmax_pair(gen, k)
        x1b, x2b = x1.bfloat16(), x2.bfloat16()
        form = sj.k1_form(k, HALF_T)
        _log(f"X7 k={k}: n={N}, {HW}x{HW}, T={t}, bf16 inputs; K1's form "
             f"{form}")
        ref = jx.joint_fwd_v8_plain(x1b, x2b, HALF_T)
        k1 = sj.joint_fwd(x1, x2, HALF_T, form="wgmma")
        for f in sj.K1_FORMS:
            for rb in X_RBS:
                got = jx.joint_fwd_v8(x1b, x2b, HALF_T, rb, form=f)
                torch.cuda.synchronize()
                stats["max_abs_err"] = max(
                    stats["max_abs_err"], _compare(f"{f} rb={rb}", got, ref))
                if f == "wgmma":
                    same = torch.equal(got, k1)
                    _log(f"    equals K1 (wgmma) on the same bf16 operands "
                         f"bit for bit: {same}")
                    if not same:
                        raise AssertionError(f"X7 rb={rb} differs from K1")
        del k1
        ref64 = sj.joint_fwd_bf16_plain(x1b.double(), x2b.double(), HALF_T)
        for tag, f in (("wgmma", jx.joint_fwd_v8(x1b, x2b, HALF_T, X_RB,
                                                 form="wgmma")),
                       ("cuda-core", jx.joint_fwd_v8(x1b, x2b, HALF_T, X_RB,
                                                     form="cuda-core")),
                       ("plain f32", ref)):
            _log(f"  {tag} vs float64 of its bf16 inputs: max err / max|ref|"
                 f" {float((f.double() - ref64).abs().max() / ref64.abs().max()):.3e}")
        del ref, ref64

        def library():
            return F.conv2d(x1b.transpose(0, 1), x2b.transpose(0, 1),
                            padding=HALF_T)
        times = {(f, rb): _time_ms(lambda f=f, r=rb: jx.joint_fwd_v8(
                     x1b, x2b, HALF_T, r, form=f))
                 for f in sj.K1_FORMS for rb in X_RBS}
        k1_ms = {f: _time_ms(lambda f=f: sj.joint_fwd(x1, x2, HALF_T,
                                                      form=f))
                 for f in sj.K1_FORMS}
        x2_ms = _time_ms(lambda: jx.joint_fwd_v2(x1b, x2b, HALF_T, rb=X_RB))
        plain_ms = _time_ms(lambda: jx.joint_fwd_v8_plain(x1b, x2b, HALF_T))
        library_ms = _time_ms(library)
        for f in sj.K1_FORMS:
            _log(f"  joint_fwd_v8 k={k} {f}: kernel "
                 + ", ".join(f"rb={rb} {times[(f, rb)]:.3f}" for rb in X_RBS)
                 + f" ms; K1 (f32 in) {k1_ms[f]:.3f} ms")
        _log(f"  in the same phase X2 (K1's stack product, full) "
             f"{x2_ms:.3f} ms; plain {plain_ms:.3f} ms; bf16 F.conv2d "
             f"{library_ms:.3f} ms (CUDA events, mean of 5)")
        if k == KS[0]:
            stats.update(ms=times[(form, X_RB)], plain_ms=plain_ms,
                         library_ms=library_ms)
            stats.update(_bound("joint_fwd_v8",
                                _joint_flop(N, k, HW, HW, HALF_T),
                                2 * x1b.numel() * 2 + (k * t) ** 2 * 4,
                                PEAK_BF16))
        del x1, x2, x1b, x2b
        torch.cuda.empty_cache()
    return stats


# Alternating rounds of X7, X3-X6 and K1 (tensor-core forms) at k=15:
# the spread of each TMA-fed form's time beside theirs
X3_ROUNDS = 10
# The TMA-fed forms of X3-X6 wait on mbarrier phases, and a phase
# mistake hangs a block instead of failing: their first launches run in a
# child process with this limit (seconds), at every shape and rb the phases
# below use and at small ragged ones whose chunks walk 1, 2, 3 and 7 slabs
# (the last from the middle of an image); the child also holds each
# against X7's tensor-core form bit for bit
TMA_WATCHDOG_S = 300
TMA_WATCHDOG = """
import torch
from iic_tpu_torch.ops.kernels import joint_exp as jx
gen = torch.Generator(device="cuda").manual_seed(7)
for n, k, h, w, half_t in {shapes}:
    x1, x2 = (torch.rand((n, k, h, w), device="cuda", generator=gen)
              for _ in range(2))
    x1b, x2b = x1.bfloat16(), x2.bfloat16()
    for rb in (16, 32, 64):
        x7 = jx.joint_fwd_v8(x1b, x2b, half_t, rb, form="wgmma")
        for name in ("joint_fwd_v3", "joint_fwd_v4", "joint_fwd_v5"):
            got = getattr(jx, name)(x1b, x2b, half_t, rb, form="wgmma")
            torch.cuda.synchronize()
            assert torch.equal(got, x7), (name, n, k, h, w, half_t, rb)
    x5 = jx.joint_fwd_v5(x1b, x2b, half_t, 16, form="wgmma")
    for roll in (False, True):
        got = jx.joint_fwd_v6(x1, x2, half_t, roll, form="wgmma")
        torch.cuda.synchronize()
        assert torch.equal(got, x5), ("joint_fwd_v6", roll, n, k, h, w)
print("X3, X4, X5, X6 (wgmma) ran at every shape, each bit-equal to X7",
      flush=True)
"""


def _tma_watchdog():
    """Runs the TMA-fed forms of X3-X6 (X6 at both roll_build) at the
    phase's shapes and at small ragged ones in a child process, each held
    to X7's tensor-core form bit for bit (X6 to X5 on rounded inputs);
    fails if the child does not finish in TMA_WATCHDOG_S (a hung mbarrier
    wait) or fails."""
    import os
    shapes = [(N, k, HW, HW, HALF_T) for k in KS] + [
        (2, 17, 9, 20, HALF_T), (2, 5, 20, 70, 1), (1, 17, 9, 20, HALF_T),
        (1, 5, 40, 20, 3), (3, 5, 200, 20, 3)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", TMA_WATCHDOG.format(shapes=shapes)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=TMA_WATCHDOG_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"X3-X6 (wgmma) did not finish in "
                             f"{TMA_WATCHDOG_S} s: a block hangs (mbarrier "
                             f"phase)") from e
    _log(f"TMA watchdog: {proc.stdout.strip()} in "
         f"{time.perf_counter() - t0:.1f} s (rc {proc.returncode})")
    if proc.returncode != 0:
        raise AssertionError(f"X3-X6 (wgmma) failed in their watchdog "
                             f"run:\n{proc.stderr[-2000:]}")


# The kernels with both forms (all four)
X_FORMED = X_PIPE


def phase_x3_x6():
    """X3-X6 against X2's plain version at the segmentation shapes (X3 at
    each rb and flat in its default form, X3, X4 and X5 at each rb in each
    form, X6 on the f32 inputs at both roll_build in each
    form, which must agree bit for bit), each call's error against
    float64; X3 and X5 in each form (X4 in the tensor-core form) bit-equal
    to X7 in that form at that rb
    and X6 to X5 on the rounded inputs (their tensor-core forms, fed by
    TMA, also within K1_F64 of max of their bf16 function in float64; their
    first launches under a watchdog); the times of X3-X6 (both
    forms) at rb=16 beside K1's, X7's (both forms; the CUDA-core
    form first and last, to show drift) and X2's in the same phase, of the
    plain version and of X2's bf16 cuDNN conv; at k=15, the tensor-core
    forms of X3-X6 (X6 at both roll_build) beside X7's and K1 in
    alternating rounds, and each one's kernels from the profiler; X5 on
    the kpad run's inputs padded to 16 channels, and the tool's kpad16
    call with its padding. Returns
    {kernel: table stats} (k=15, rb=16, each kernel in its default form,
    X3 flat, X6 roll_build=False)."""
    import torch
    import torch.nn.functional as F
    from iic_tpu_torch.ops.kernels import joint_exp as jx
    from iic_tpu_torch.ops.kernels import seg_joint as sj
    from iic_tpu_torch.tools import joint_kernel_exp as tool

    _tma_watchdog()
    gen = torch.Generator(device="cuda").manual_seed(6)
    stats = {name: {"max_abs_err": 0.0} for name in X_PIPE}
    t = 2 * HALF_T + 1
    for k in KS:
        x1, x2 = _softmax_pair(gen, k)
        x1b, x2b = x1.bfloat16(), x2.bfloat16()
        form = sj.k1_form(k, HALF_T)
        other = next(f for f in jx.X_FORMS if f != form)
        _log(f"X3-X6 k={k}: n={N}, {HW}x{HW}, T={t}; X3-X5 on bf16 inputs, "
             f"X6 on their f32 originals; the default form of X3-X6 "
             f"{form}")
        ref = jx.joint_fwd_v2_plain(x1b, x2b, HALF_T)
        ref64 = sj.displacement_joint_dense(x1b.double(), x2b.double(),
                                            HALF_T)
        scale = float(ref64.abs().max())
        _log(f"  plain f32 vs float64 of the bf16 inputs: max err / max|ref| "
             f"{float((ref.double() - ref64).abs().max()) / scale:.3e}")
        calls = (
            [("joint_fwd_v3", form, f"rb={rb} flat={flat} {form}",
              lambda rb=rb, flat=flat: jx.joint_fwd_v3(x1b, x2b, HALF_T, rb,
                                                       flat))
             for rb in X_RBS for flat in (True, False)]
            + [("joint_fwd_v3", other, f"rb={rb} {other}",
                lambda rb=rb: jx.joint_fwd_v3(x1b, x2b, HALF_T, rb,
                                              form=other))
               for rb in X_RBS]
            + [(name, f, f"rb={rb} {f}",
                lambda name=name, rb=rb, f=f: getattr(jx, name)(
                    x1b, x2b, HALF_T, rb, form=f))
               for name in ("joint_fwd_v4", "joint_fwd_v5")
               for f in jx.X_FORMS for rb in X_RBS]
            + [("joint_fwd_v6", f, f"roll_build={roll} {f}",
                lambda roll=roll, f=f: jx.joint_fwd_v6(x1, x2, HALF_T, roll,
                                                       form=f))
               for f in jx.X_FORMS for roll in (False, True)])
        x6 = {}
        x7 = {(f, rb): jx.joint_fwd_v8(x1b, x2b, HALF_T, rb, form=f)
              for f in jx.X_FORMS for rb in X_RBS}
        for name, f, tag, call in calls:
            got = call()
            torch.cuda.synchronize()
            err = _compare(f"{name} {tag}", got, ref)
            if name not in X_FORMED or f == form:
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 err)
            e64 = float((got.double() - ref64).abs().max()) / scale
            _log(f"    vs float64: max err / max|ref| {e64:.3e}")
            if f == "wgmma" and e64 > K1_F64:
                raise AssertionError(f"{name} {tag} is off its bf16 "
                                     f"function ({e64:.3e} > {K1_F64})")
            if name == "joint_fwd_v6":
                x6[tag] = got
            elif name != "joint_fwd_v4" or f == "wgmma":
                # X4's CUDA-core form adds each stage's staged product:
                # another order than X7's
                rb = int(tag.split()[0].removeprefix("rb="))
                if not torch.equal(got, x7[(f, rb)]):
                    raise AssertionError(f"{name} {tag} differs from X7's "
                                         f"{f} form")
        _log("  X3 and X5 equal X7 in the same form at each rb bit for "
             "bit, X4 in the tensor-core form")
        for f in jx.X_FORMS:
            x5 = jx.joint_fwd_v5(x1b, x2b, HALF_T, 16, form=f)
            if not torch.equal(x6[f"roll_build=False {f}"], x5):
                raise AssertionError(f"X6 ({f}) differs from X5 on the "
                                     f"rounded inputs")
            if not torch.equal(x6[f"roll_build=True {f}"],
                               x6[f"roll_build=False {f}"]):
                raise AssertionError(f"X6 ({f}) roll_build=True differs "
                                     f"from False")
        _log("  X6 equals X5 on the rounded inputs, and roll_build=True "
             "equals roll_build=False, bit for bit in each form")
        del ref, ref64, x6, x7, got, x5

        def library():
            return F.conv2d(x1b.transpose(0, 1), x2b.transpose(0, 1),
                            padding=HALF_T)
        # the tool's kpad run: X5 on the inputs zero-padded to 16 channels,
        # the padding outside the timing, and the tool's whole kpad16 call
        # on the f32 inputs (padding, X5, slice)
        x1p, x2p = (F.pad(x, (0, 0, 0, 0, 0, 16 - k)) for x in (x1b, x2b))
        timed = {
            "X7 cuda-core": lambda: jx.joint_fwd_v8(x1b, x2b, HALF_T, X_RB,
                                                    form="cuda-core"),
            "X7 wgmma": lambda: jx.joint_fwd_v8(x1b, x2b, HALF_T, X_RB,
                                                form="wgmma"),
            "K1": lambda: sj.joint_fwd(x1, x2, HALF_T),
            "X2": lambda: jx.joint_fwd_v2(x1b, x2b, HALF_T, rb=X_RB),
            "joint_fwd_v3": lambda: jx.joint_fwd_v3(x1b, x2b, HALF_T, X_RB),
            f"X3 {other}": lambda: jx.joint_fwd_v3(x1b, x2b, HALF_T, X_RB,
                                                   form=other),
            "joint_fwd_v4": lambda: jx.joint_fwd_v4(x1b, x2b, HALF_T, X_RB),
            f"X4 {other}": lambda: jx.joint_fwd_v4(x1b, x2b, HALF_T, X_RB,
                                                   form=other),
            "joint_fwd_v5": lambda: jx.joint_fwd_v5(x1b, x2b, HALF_T, X_RB),
            f"X5 {other}": lambda: jx.joint_fwd_v5(x1b, x2b, HALF_T, X_RB,
                                                   form=other),
            "X5 k=16 padded": lambda: jx.joint_fwd_v5(x1p, x2p, HALF_T,
                                                      X_RB),
            "kpad16(X5)": lambda: tool.kpad16(x1, x2, HALF_T,
                                              jx.joint_fwd_v5),
            "joint_fwd_v6": lambda: jx.joint_fwd_v6(x1, x2, HALF_T),
            "X6 roll_build": lambda: jx.joint_fwd_v6(x1, x2, HALF_T, True),
            f"X6 {other}": lambda: jx.joint_fwd_v6(x1, x2, HALF_T,
                                                   form=other),
            f"X6 {other} roll_build": lambda: jx.joint_fwd_v6(
                x1, x2, HALF_T, True, form=other),
            "X7 wgmma again": lambda: jx.joint_fwd_v8(x1b, x2b, HALF_T, X_RB,
                                                      form="wgmma"),
            "K1 again": lambda: sj.joint_fwd(x1, x2, HALF_T),
            "X7 cuda-core again": lambda: jx.joint_fwd_v8(
                x1b, x2b, HALF_T, X_RB, form="cuda-core"),
            "plain": lambda: jx.joint_fwd_v2_plain(x1b, x2b, HALF_T),
            "bf16 F.conv2d": library}
        ms = {tag: _time_ms(fn) for tag, fn in timed.items()}
        _log(f"  k={k}, rb={X_RB} (CUDA events, mean of 5; X3-X6 = "
             f"{form}): "
             + ", ".join(f"{tag.replace('joint_fwd_v', 'X')} {v:.3f}"
                         for tag, v in ms.items()) + " ms")
        if k == KS[0]:
            # the TMA-fed forms against X7's tensor-core form (the same
            # bf16 operands, layout pass and reduce; only the GEMM kernel
            # differs; X6's layout pass reads f32) and K1 (f32 inputs), in
            # alternating rounds, then each call's kernels
            ring_calls = {
                "X7 wgmma": lambda: jx.joint_fwd_v8(x1b, x2b, HALF_T, X_RB,
                                                    form="wgmma"),
                "X3 wgmma": lambda: jx.joint_fwd_v3(x1b, x2b, HALF_T, X_RB,
                                                    form="wgmma"),
                "X4 wgmma": lambda: jx.joint_fwd_v4(x1b, x2b, HALF_T, X_RB,
                                                    form="wgmma"),
                "X5 wgmma": lambda: jx.joint_fwd_v5(x1b, x2b, HALF_T, X_RB,
                                                    form="wgmma"),
                "X6 wgmma": lambda: jx.joint_fwd_v6(x1, x2, HALF_T,
                                                    form="wgmma"),
                "X6 wgmma roll_build": lambda: jx.joint_fwd_v6(
                    x1, x2, HALF_T, True, form="wgmma"),
                "K1": lambda: sj.joint_fwd(x1, x2, HALF_T)}
            _log(f"  X3-X6 beside X7 and K1, k={k}, rb={X_RB}, "
                 f"{X3_ROUNDS} alternating rounds:")
            _alternate(ring_calls, X3_ROUNDS)
            for tag, call in ring_calls.items():
                _kernel_parts(tag, call)
            flop = _joint_flop(N, k, HW, HW, HALF_T)
            for name in X_PIPE:
                stats[name].update(ms=ms[name], plain_ms=ms["plain"],
                                   library_ms=ms["bf16 F.conv2d"])
                in_bytes = 2 * x1.numel() * (4 if name == "joint_fwd_v6"
                                             else 2)  # X6 reads f32
                stats[name].update(_bound(name, flop,
                                          in_bytes + (k * t) ** 2 * 4,
                                          PEAK_BF16))
        del x1, x2, x1b, x2b, x1p, x2p
        torch.cuda.empty_cache()
    return stats


def phase_x8():
    """X8 (dx1 and dx2, the tool's ``bwd_v8``) against its plain version at
    the segmentation shapes for each rb, its errors against float64, and
    the times of the kernel (one call), its plain version and one bf16
    cuDNN conv computing the same gradient. Returns the table stats (k=15,
    rb=16, the dx1 call)."""
    import torch
    import torch.nn.functional as F
    from iic_tpu_torch.ops.kernels import joint_exp as jx
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    gen = torch.Generator(device="cuda").manual_seed(4)
    stats = {"max_abs_err": 0.0}
    t = 2 * HALF_T + 1
    for k in KS:
        x1, x2 = _softmax_pair(gen, k)
        x1b, x2b = x1.bfloat16(), x2.bfloat16()
        del x1, x2
        g = torch.randn((k, k, t, t), device="cuda", generator=gen)
        g2d, g2d_swap = sj.adjoints(g)
        _log(f"X8 k={k}: n={N}, {HW}x{HW}, T={t}, bf16 inputs and adjoint")
        refs = (jx.dgrad_v8_plain(g2d, x2b, HALF_T),
                jx.dgrad_v8_plain(g2d_swap, x1b, HALF_T))
        for rb in X_RBS:
            got = jx.bwd_v8(g, x1b, x2b, HALF_T, rb)
            torch.cuda.synchronize()
            for tag, a, r in zip(("dx1", "dx2"), got, refs):
                stats["max_abs_err"] = max(stats["max_abs_err"],
                                           _compare(f"rb={rb} {tag}", a, r))
        ref64 = jx.dgrad_v8_plain(g2d.double(), x2b.double(), HALF_T)
        scale = float(ref64.abs().max())
        for tag, f in (("kernel", jx.dgrad_v8(g2d, x2b, HALF_T, X_RB)),
                       ("plain f32", refs[0])):
            _log(f"  dx1 {tag} vs float64: max err / max|ref| "
                 f"{float((f.double() - ref64).abs().max()) / scale:.3e}")
        del refs, ref64, got
        gf = g.flip(2, 3).bfloat16().contiguous()

        def library():
            return F.conv2d(x2b, gf, padding=HALF_T)
        times = {rb: _time_ms(lambda r=rb: jx.dgrad_v8(g2d, x2b, HALF_T, r))
                 for rb in X_RBS}
        x2f = x2b.float()
        k2 = sj.joint_dgrad(g2d, x2f, HALF_T)
        if sj.k2_form(k, HALF_T) == "wgmma":
            same = torch.equal(k2, jx.dgrad_v8(g2d, x2b, HALF_T, X_RB))
            _log(f"  K2 on the same operands equals X8 bit for bit: {same}")
            if not same:
                raise AssertionError("K2 differs from X8 on its operands")
        del k2
        k2_ms = _time_ms(lambda: sj.joint_dgrad(g2d, x2f, HALF_T))
        plain_ms = _time_ms(lambda: jx.dgrad_v8_plain(g2d, x2b, HALF_T))
        library_ms = _time_ms(library)
        _log(f"  dgrad_v8 k={k} (one call, dx1): kernel "
             + ", ".join(f"rb={rb} {ms:.3f}" for rb, ms in times.items())
             + f" ms; in the same phase K2 ({sj.k2_form(k, HALF_T)}, f32 "
             f"in) {k2_ms:.3f} ms; plain {plain_ms:.3f} ms; bf16 F.conv2d "
             f"{library_ms:.3f} ms (CUDA events, mean of 5)")
        if k == KS[0]:
            stats.update(ms=times[X_RB], plain_ms=plain_ms,
                         library_ms=library_ms)
            stats.update(_bound("dgrad_v8",
                                _joint_flop(N, k, HW, HW, HALF_T),
                                (k * t) ** 2 * 4 + x2b.numel() * (2 + 4),
                                PEAK_BF16))
        del x1b, x2b, x2f
        torch.cuda.empty_cache()
    return stats


def _mean_max(got, ref):
    """(mean |d| / mean |ref|, max |d| / max |ref|, max |d|)."""
    d = (got.double() - ref.double()).abs()
    r = ref.double().abs()
    return (float(d.mean() / r.mean()), float(d.max() / r.max()),
            float(d.max()))


def phase_x9():
    """X9 against its plain version at the segmentation shapes by the
    mean / max criterion, X8's unrounded pair required to fail it, errors
    against float64, and the times of the kernel, its plain version and the
    two bf16 cuDNN convs of the same gradients. Returns the table stats
    (k=15)."""
    import torch
    import torch.nn.functional as F
    from iic_tpu_torch.ops.kernels import joint_exp as jx

    gen = torch.Generator(device="cuda").manual_seed(5)
    stats = {"max_abs_err": 0.0}
    t = 2 * HALF_T + 1
    for k in KS:
        x1, x2 = _softmax_pair(gen, k)
        x1b, x2b = x1.bfloat16(), x2.bfloat16()
        del x1, x2
        g = torch.randn((k, k, t, t), device="cuda", generator=gen)
        _log(f"X9 k={k}: n={N}, {HW}x{HW}, T={t}, bf16 inputs and adjoint; "
             f"criterion mean |d|/mean|ref| <= {X9_MEAN:g}, max |d|/max|ref|"
             f" <= {X9_MAX:g}")
        got = jx.dgrad_fused_v7(g, x1b, x2b, HALF_T)
        ref = jx.dgrad_fused_v7_plain(g, x1b, x2b, HALF_T)
        unrounded = jx.bwd_v8(g, x1b, x2b, HALF_T)
        torch.cuda.synchronize()
        for tag, a, r, u in zip(("dx1", "dx2"), got, ref, unrounded):
            mean, mx, err = _mean_max(a, r)
            ok = mean <= X9_MEAN and mx <= X9_MAX and math.isfinite(err)
            u_mean, u_mx, _ = _mean_max(u, r)
            caught = not (u_mean <= X9_MEAN and u_mx <= X9_MAX)
            verdict = "fails the criterion, as it must" if caught else "PASSES"
            _log(f"  {tag}: mean {mean:.3e}, max {mx:.3e} (max_abs_err "
                 f"{err:.3e}) {'ok' if ok else 'FAIL'}; X8's unrounded pair "
                 f"mean {u_mean:.3e}, max {u_mx:.3e}: {verdict}")
            if not ok:
                raise AssertionError(f"X9 {tag} disagrees with its plain "
                                     f"version")
            if not caught:
                raise AssertionError("the X9 criterion does not tell the "
                                     "rounded partials from unrounded ones")
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
        ref64 = jx.dgrad_fused_v7_plain(g.double(), x1b.double(),
                                        x2b.double(), HALF_T)
        for tag, pair in (("kernel", got), ("plain f32", ref)):
            _log(f"  {tag} vs float64 (partials rounded from float64): "
                 + ", ".join(f"{n} mean {m[0]:.3e} max {m[1]:.3e}"
                             for n, m in zip(("dx1", "dx2"), (
                                 _mean_max(a, r)
                                 for a, r in zip(pair, ref64)))))
        del got, ref, unrounded, ref64
        gb = g.bfloat16()
        filters = (gb.flip(2, 3).contiguous(), gb.transpose(0, 1).contiguous())

        def library():
            return (F.conv2d(x2b, filters[0], padding=HALF_T),
                    F.conv2d(x1b, filters[1], padding=HALF_T))
        ms = _time_ms(lambda: jx.dgrad_fused_v7(g, x1b, x2b, HALF_T))
        x8_ms = _time_ms(lambda: jx.bwd_v8(g, x1b, x2b, HALF_T))
        plain_ms = _time_ms(lambda: jx.dgrad_fused_v7_plain(g, x1b, x2b,
                                                            HALF_T))
        library_ms = _time_ms(library)
        _log(f"  dgrad_fused_v7 k={k}: kernel {ms:.3f} ms (dx1 and dx2); in "
             f"the same phase two X8 calls {x8_ms:.3f} ms; plain "
             f"{plain_ms:.3f} ms; two bf16 F.conv2d {library_ms:.3f} ms "
             f"(CUDA events, mean of 5)")
        if k == KS[0]:
            stats.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
            stats.update(_bound("dgrad_fused_v7",
                                2 * _joint_flop(N, k, HW, HW, HALF_T),
                                g.numel() * 4 + 2 * x1b.numel() * (2 + 4),
                                PEAK_BF16))
        del x1b, x2b
        torch.cuda.empty_cache()
    # k > 16: two j chunks, where X9's v-outer order differs from X8's
    x1, x2 = (torch.softmax(torch.randn((8, 17, HW, HW), device="cuda",
                                        generator=gen), dim=1)
              for _ in range(2))
    g = torch.randn((17, 17, t, t), device="cuda", generator=gen)
    got = jx.dgrad_fused_v7(g, x1, x2, HALF_T)
    for tag, a, r in zip(("dx1", "dx2"), got,
                         jx.dgrad_fused_v7_plain(g, x1, x2, HALF_T)):
        mean, mx, err = _mean_max(a, r)
        ok = mean <= X9_MEAN and mx <= X9_MAX and math.isfinite(err)
        _log(f"X9 k=17, n=8, {HW}x{HW} {tag}: mean {mean:.3e}, max {mx:.3e} "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"X9 k=17 {tag} disagrees with its plain "
                                 f"version")
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
    return stats


def _launch_counts():
    from iic_tpu_torch.ops.kernels import iid_loss as k3
    from iic_tpu_torch.ops.kernels import joint_exp as jx
    from iic_tpu_torch.ops.kernels import seg_joint as sj
    return sj, k3, jx


def _reset_counts():
    for mod in _launch_counts():
        mod.reset_launch_counts()


def _read_counts():
    return {k: v for mod in _launch_counts() for k, v in mod.LAUNCHES.items()}


def _seg_cli(main, argv, tag, heads="AB"):
    """One segmentation CLI run in-process, counts set to 0 just before:
    prints its losses, step seconds, eval accuracies and launches; fails on
    a loss of ``heads`` (the single-head script logs in the B slots) or an
    eval accuracy that is not finite, or a run that missed K1 or K2.
    Returns (history, launches)."""
    import numpy as np

    _reset_counts()
    _, history = main(argv)
    launches = _read_counts()
    for head in heads:
        losses = history[f"epoch_loss_head_{head}"]
        steps = history[f"step_seconds_head_{head}"]
        _log(f"{tag} head {head}: epoch loss {losses}, step seconds "
             f"{[round(s, 4) for s in steps]}")
        if not losses or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{tag} head {head} loss not finite: "
                                 f"{losses}")
    acc = history["eval"].epoch_acc
    _log(f"{tag}: eval acc per epoch (pre-train first) {acc}; launches "
         f"{launches}")
    if not acc or not np.all(np.isfinite(acc)):
        raise AssertionError(f"{tag}: eval history not finite: {acc}")
    if launches["seg_joint_fwd"] < 1 or launches["seg_joint_dgrad"] < 2:
        raise AssertionError(f"{tag} missed the kernels: {launches}")
    return history, launches


def phase_trainer(dtype):
    """The segmentation CLI in-process in ``dtype`` (``--model_dtype``),
    behind the default prefetch thread. Returns {kernel: launches in the
    run}."""
    from iic_tpu_torch.cli import segmentation_twohead

    with tempfile.TemporaryDirectory() as out_root:
        history, launches = _seg_cli(
            segmentation_twohead.main,
            CLI_ARGS + ["--model_dtype", dtype, "--out_root", out_root],
            dtype)
    if len(history["eval"].epoch_acc) < 2:
        raise AssertionError(f"eval history not filled: "
                             f"{history['eval'].epoch_acc}")
    if launches["seg_joint_fwd"] < 4 or launches["seg_joint_dgrad"] < 8:
        raise AssertionError(f"main path missed the kernels: {launches}")
    return launches


def phase_cluster_trainer(dtype):
    """The clustering CLI in-process in ``dtype`` (``--model_dtype``),
    behind the default prefetch thread. Returns {kernel: launches in the
    run}."""
    import numpy as np
    from iic_tpu_torch.cli import cluster_sobel_twohead

    with tempfile.TemporaryDirectory() as out_root:
        _reset_counts()
        _, history = cluster_sobel_twohead.main(
            CLUSTER_CLI_ARGS + ["--model_dtype", dtype, "--out_root",
                                out_root])
        launches = _read_counts()
    n_steps = 0
    for head in ("A", "B"):
        losses = history[f"epoch_loss_head_{head}"]
        steps = history[f"step_seconds_head_{head}"]
        n_steps += len(steps)
        _log(f"{dtype} cluster head {head}: epoch loss {losses}, step "
             f"seconds "
             f"{[round(s, 4) for s in steps]}")
        if not losses or not np.all(np.isfinite(losses)):
            raise AssertionError(f"head {head} loss not finite: {losses}")
    ev = history["eval"]
    _log(f"eval acc per epoch (pre-train first): {ev.epoch_acc}, double "
         f"eval {ev.double_eval_acc}")
    for name, acc in (("eval", ev.epoch_acc),
                      ("double eval", ev.double_eval_acc)):
        if len(acc) < 2 or not np.all(np.isfinite(acc)):
            raise AssertionError(f"{name} history not filled: {acc}")
    _log(f"launches in the {dtype} clustering run: {launches}; {n_steps} "
         f"steps, so "
         f"{n_steps} K3 launches expected (one per step for all 5 "
         f"sub-heads; {5 * n_steps} if launched per sub-head)")
    if launches["iid_loss_fwd"] < n_steps:
        raise AssertionError(f"clustering path missed K3: {launches}")
    return launches


# Model 545 (Potsdam-3, examples/commands.md:92-114): the 555 command without
# its COCO-only --pre_scale_all --pre_scale_factor --coco_164k_curated_version,
# with Potsdam-3's changes; --dataset_root is added where it runs
POTSDAM3_ARGS = [
    "--mode", "IID", "--dataset", "Potsdam", "--model_ind", "545",
    "--arch", "SegmentationNet10aTwoHead", "--num_epochs", "4800",
    "--lr", "0.00001", "--lamb_A", "1.0", "--lamb_B", "1.5",
    "--num_sub_heads", "1", "--batch_sz", "75", "--num_dataloaders", "1",
    "--use_coarse_labels", "--output_k_A", "24", "--output_k_B", "3",
    "--gt_k", "3", "--input_sz", "200", "--half_T_side_sparse_min", "0",
    "--half_T_side_sparse_max", "0", "--half_T_side_dense", "10",
    "--include_rgb", "--use_uncollapsed_loss", "--batchnorm_track",
    "--no_sobel", "--jitter_brightness", "0.1", "--jitter_contrast", "0.1",
    "--jitter_saturation", "0.1", "--jitter_hue", "0.1"]
# The single-head IID+ script on the same tree: model 545's flags with one
# overclustering head
POTSDAM3_SINGLE = ["--mode", "IID+", "--arch", "SegmentationNet10a",
                   "--output_k", "24", "--gt_k", "3", "--use_coarse_labels"]
# The Potsdam fixture tree: tiles of each split (150 training tiles in IID+,
# 180 in IID), 200 x 200 rgb + ir uint8, 6 fine classes
POTSDAM_SPLITS = {"unlabelled_train": 110, "labelled_train": 40,
                  "labelled_test": 30}
# The four published segmentation configurations' joint shapes (n, map
# side, half_T, (k of head A, k of head B)): model 555 is phase_kernels's,
# the others examples/commands.md:105-114
SEG_SHAPES = {"512": (60, 128, 10, (45, 15)), "545": (75, 200, 10, (24, 3)),
              "544": (60, 200, 5, (36, 6))}
# tests/test_seg_regression.py:34-50: the JAX package's learning guard, run
# here through the port's two-head CLI in f32, with its band (calibrated on
# the TPU: 0.357 pre-eval -> 0.81 at epoch 1 -> 0.92 at epoch 3). A run
# either learns the texture classes (eval ~0.92, loss B ~-1.62) or settles
# on another partition (~0.6-0.68, ~-1.40), and which one hangs on its
# random draws, in the JAX package as in the port: from the same initial
# weights each lands in the band in 4 of 6 seeds
# (tests/test_torch_seg_guard.py). The JAX guard is one seed that learns,
# so the port's runs GUARD_SEEDS and needs the band in one run at least.
GUARD_ARGS = [
    "--model_ind", "901", "--arch", "SegmentationNet10aTwoHead",
    "--mode", "IID", "--dataset", "SyntheticSegStripes3x64x256",
    "--dataset_root", "", "--num_epochs", "8", "--lr", "0.0001",
    "--lamb_A", "1.0", "--lamb_B", "1.5", "--num_sub_heads", "1",
    "--batch_sz", "32", "--num_dataloaders", "1", "--output_k_A", "15",
    "--output_k_B", "3", "--gt_k", "3", "--input_sz", "64",
    "--half_T_side_sparse_min", "0", "--half_T_side_sparse_max", "0",
    "--half_T_side_dense", "5", "--use_uncollapsed_loss", "--batchnorm_track"]
GUARD_BEST, GUARD_GAIN = 0.80, 0.30
GUARD_SEEDS = (0, 1, 2, 3, 4)


def _write_potsdam(root, seed=0):
    """A Potsdam tree in the layout the reader parses: imgs/<id>.mat
    ("img", uint8 (200, 200, 4)), gt/<id>.mat ("gt", 6 classes) for the
    labelled tiles only, and the three split lists."""
    import os
    import numpy as np
    import scipy.io as sio

    rng = np.random.default_rng(seed)
    for sub in ("imgs", "gt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for split, n in POTSDAM_SPLITS.items():
        ids = [f"{split}_{i}" for i in range(n)]
        for image_id in ids:
            sio.savemat(os.path.join(root, "imgs", image_id + ".mat"),
                        {"img": rng.integers(0, 256, (200, 200, 4),
                                             dtype=np.uint8)})
            if split != "unlabelled_train":
                sio.savemat(os.path.join(root, "gt", image_id + ".mat"),
                            {"gt": rng.integers(0, 6, (200, 200),
                                                dtype=np.uint8)})
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")


def phase_native(potsdam_root):
    """The port's native host prep: its build (g++ seconds, path, CPUs),
    and on a Potsdam-3 batch (75 tiles of 200 x 200 x 4, no rescale)
    ``_native_batch`` bit-equal to the numpy fast path, images and masks;
    each path's host ms a batch, median of 10."""
    import os
    import numpy as np
    from iic_tpu_torch import native
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline

    t0 = time.perf_counter()
    native.load_seg_prep()
    path = native.library_path()
    built = native.BUILD_SECONDS.get(path)
    _log(f"native seg_prep: {path}; g++ "
         + (f"{built:.2f} s (built in this run)" if built is not None else
            f"not run in this process (found built)")
         + f"; load {time.perf_counter() - t0:.3f} s; os.cpu_count() "
         f"{os.cpu_count()}")
    cfg = parse_seg_args(POTSDAM3_ARGS + ["--dataset_root", potsdam_root])
    cfg.finalize(twohead=True)
    parts = ["unlabelled_train", "labelled_train"]
    pipes = {p: SegTrainPipeline(cfg, parts, seed=0, use_native=(p ==
                                                                "native"))
             for p in ("native", "numpy")}
    order, _ = pipes["numpy"]._epoch_order(0)
    idxs = order[:cfg.dataloader_batch_sz]
    located = [pipes["numpy"]._locate(int(i)) for i in idxs]
    labelled = sum(d._load_raw(i)[1] is not None for d, i in located)
    # a batch mixing labelled and unlabelled tiles takes the fast path
    if not 0 < labelled < len(idxs):
        raise AssertionError(f"the batch has {labelled} labelled tiles")

    def batch(path):
        _, rng = pipes[path]._epoch_order(0)
        fn = (pipes[path]._native_batch if path == "native"
              else pipes[path]._numpy_batch)
        return fn(idxs, rng)

    (ni, nm), (pi, pm) = batch("native"), batch("numpy")
    sz = cfg.input_sz
    same = (ni.shape == pi.shape == (len(idxs), sz, sz, 4)
            and np.array_equal(ni, pi) and np.array_equal(nm, pm))
    _log(f"native batch {ni.shape} {ni.dtype} and masks {nm.shape} equal "
         f"the numpy fast path's bit for bit: {same} ({labelled} of "
         f"{len(idxs)} tiles labelled)")
    if not same:
        raise AssertionError("the native batch differs from numpy's")
    for path in ("native", "numpy"):
        times = []
        for _ in range(10):
            t = time.perf_counter()
            batch(path)
            times.append((time.perf_counter() - t) * 1e3)
        _log(f"  {path} host prep: {float(np.median(times)):.2f} ms a batch "
             f"of {len(idxs)} tiles (median of 10; min {min(times):.2f}, max "
             f"{max(times):.2f}; the .mat reads included)")


def phase_seg_shapes():
    """K1, and K2 for dx1 and dx2, at the six joint shapes of the other
    three published segmentation configurations (SEG_SHAPES): each against
    its plain version within the JAX contract, K2 bit-equal to X8 where it
    runs X8's kernel, K1 at 545's head A also within K1_F64 of max of its
    bf16 function in float64; CUDA-event ms of each beside the bf16
    F.conv2d library call and its bound, and the form taken."""
    import torch
    import torch.nn.functional as F
    from iic_tpu_torch.ops.kernels import joint_exp as jx
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    gen = torch.Generator(device="cuda").manual_seed(1)
    for model, (n, hw, half_t, ks) in SEG_SHAPES.items():
        t = 2 * half_t + 1
        for head, k in zip("AB", ks):
            z = [torch.softmax(torch.randn((n, k, hw, hw), device="cuda",
                                           generator=gen), dim=1)
                 for _ in range(2)]
            x1, x2 = z[0].contiguous(), z[1].contiguous()
            g = torch.randn((k, k, t, t), device="cuda", generator=gen)
            g2d, g2d_swap = sj.adjoints(g)
            k1f, k2f = sj.k1_form(k, half_t), sj.k2_form(k, half_t)
            _log(f"model {model} head {head}: n={n}, {hw}x{hw}, T={t}, "
                 f"k={k}; K1 form {k1f}, K2 form {k2f}")
            got = sj.joint_fwd(x1, x2, half_t)
            ref = sj.displacement_joint_dense(x1, x2, half_t)
            _compare("K1 joint", got, ref)
            if (model, head) == ("545", "A"):
                ref64 = sj.joint_fwd_bf16_plain(x1.double(), x2.double(),
                                                half_t)
                tol = K1_F64 if k1f == "wgmma" else K1_F64_FMA
                e64 = (float((got.double() - ref64).abs().max())
                       / float(ref64.abs().max()))
                _log(f"  K1 vs float64 of its bf16 operands: max err / "
                     f"max|ref| {e64:.3e} (<= {tol:g}) "
                     f"{'ok' if e64 <= tol else 'FAIL'}")
                if e64 > tol:
                    raise AssertionError("K1 is off its bf16 function")
                del ref64
            del got, ref
            got1 = sj.joint_dgrad(g2d, x2, half_t)
            _compare("K2 dx1", got1, sj.dgrad_plain(g2d, x2, half_t))
            _compare("K2 dx2", sj.joint_dgrad(g2d_swap, x1, half_t),
                     sj.dgrad_plain(g2d_swap, x1, half_t))
            if k2f == "wgmma":
                same = torch.equal(got1, jx.dgrad_v8(g2d, x2, half_t, X_RB))
                _log(f"  K2 dx1 equals X8 (rb={X_RB}) bit for bit: {same}")
                if not same:
                    raise AssertionError("K2 differs from X8 on its "
                                         "operands")
            del got1
            x1b, x2b = x1.bfloat16(), x2.bfloat16()
            gf = g.flip(2, 3).bfloat16().contiguous()
            flop = _joint_flop(n, k, hw, hw, half_t)
            nbytes = 2 * x1.numel() * 4 + (k * t) ** 2 * 4
            for name, call, lib in (
                    ("K1", lambda: sj.joint_fwd(x1, x2, half_t),
                     lambda: F.conv2d(x1b.transpose(0, 1),
                                      x2b.transpose(0, 1), padding=half_t)),
                    ("K2", lambda: sj.joint_dgrad(g2d, x2, half_t),
                     lambda: F.conv2d(x2b, gf, padding=half_t))):
                ms, lib_ms = _time_ms(call), _time_ms(lib)
                bound = _bound(name, flop, nbytes, PEAK_BF16)
                _log(f"  {name} model {model} head {head} k={k}: kernel "
                     f"{ms:.3f} ms, bf16 F.conv2d {lib_ms:.3f} ms, bound "
                     f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}); "
                     f"{ms / bound['bound_ms']:.1f}x its bound (CUDA "
                     f"events, mean of 5)")
            del x1, x2, x1b, x2b, z
            torch.cuda.empty_cache()


def phase_potsdam(potsdam_root):
    """Model 545's two-head CLI on the Potsdam fixture tree through the
    native host prep (--test_code, bf16), then --restart with --num_epochs
    one higher into the same --out_root (it must resume at epoch 2), then
    the single-head IID+ CLI on the same tree. Returns {kernel: launches
    in the three runs}."""
    from iic_tpu_torch.cli import segmentation, segmentation_twohead
    from iic_tpu_torch.data import seg_pipeline as sp

    native_batches = [0]
    plain = sp.SegTrainPipeline._native_batch

    def counted(self, idxs, rng):
        native_batches[0] += 1
        return plain(self, idxs, rng)

    base = POTSDAM3_ARGS + ["--dataset_root", potsdam_root, "--test_code",
                            "--model_dtype", "bfloat16"]
    total = {"seg_joint_fwd": 0, "seg_joint_dgrad": 0}
    sp.SegTrainPipeline._native_batch = counted
    try:
        with tempfile.TemporaryDirectory() as out_root:
            runs = (
                ("model 545", segmentation_twohead.main,
                 base + ["--num_epochs", "2", "--out_root", out_root], 2,
                 "AB"),
                ("model 545 --restart", segmentation_twohead.main,
                 base + ["--num_epochs", "3", "--restart", "--out_root",
                         out_root], 3, "AB"),
                ("model 545 single-head IID+", segmentation.main,
                 base + POTSDAM3_SINGLE + ["--num_epochs", "2",
                                           "--model_ind", "546",
                                           "--out_root", out_root], 2, "B"))
            for tag, main, argv, evals, heads in runs:
                before = native_batches[0]
                t0 = time.perf_counter()
                history, launches = _seg_cli(main, argv, tag, heads)
                _log(f"{tag}: {time.perf_counter() - t0:.1f} s, "
                     f"{native_batches[0] - before} batches by the native "
                     f"host prep")
                if native_batches[0] == before:
                    raise AssertionError(f"{tag} did not take the native "
                                         "host prep")
                if len(history["eval"].epoch_acc) != evals:
                    raise AssertionError(
                        f"{tag}: {len(history['eval'].epoch_acc)} evals, "
                        f"expected {evals} (pre-eval, epoch 1"
                        + (", epoch 2)" if evals == 3 else ")"))
                for k in total:
                    total[k] += launches[k]
    finally:
        sp.SegTrainPipeline._native_batch = plain
    return total


def phase_learning_guard():
    """tests/test_seg_regression.py's guard through the port's two-head
    CLI: SyntheticSegStripes3x64x256, 8 epochs, f32, one run for each seed
    of GUARD_SEEDS; a run is in the band when its best eval acc reaches
    GUARD_BEST and gains GUARD_GAIN over its pre-eval, and one run at least
    must be. Returns {kernel: launches in all the runs}."""
    import numpy as np
    from iic_tpu_torch.cli import segmentation_twohead

    total = {"seg_joint_fwd": 0, "seg_joint_dgrad": 0}
    passed = []
    for seed in GUARD_SEEDS:
        with tempfile.TemporaryDirectory() as out_root:
            history, launches = _seg_cli(
                segmentation_twohead.main, GUARD_ARGS + [
                    "--seed", str(seed), "--out_root", out_root],
                f"learning guard, seed {seed}")
        for k in total:
            total[k] += launches[k]
        accs = np.array(history["eval"].epoch_acc, float)
        pre, best = float(accs[0]), float(accs.max())
        ok = (len(accs) == 8 and best >= GUARD_BEST
              and best - pre >= GUARD_GAIN)
        passed += [seed] if ok else []
        _log(f"learning guard, seed {seed}: eval acc "
             f"{[round(float(a), 4) for a in accs]}; pre {pre:.4f}, best "
             f"{best:.4f} at epoch {int(accs.argmax())} (>= {GUARD_BEST}), "
             f"gain {best - pre:.4f} (>= {GUARD_GAIN}): "
             f"{'in the band' if ok else 'outside the band'}")
    _log(f"learning guard: {len(passed)} of {len(GUARD_SEEDS)} runs in the "
         f"band (seeds {passed})")
    if not passed:
        raise AssertionError("no run of the port reached the learning "
                             "guard's band")
    return total


def phase_tool():
    """The port's experiment tool in-process at its default size: the
    default run and every run of ``TOOL_RUNS``. Returns {kernel: launches
    in the ten runs}."""
    from iic_tpu_torch.tools import joint_kernel_exp as tool

    _reset_counts()
    for run, variants in TOOL_RUNS.items():
        records = tool.main([run] if run else [])
        sys.stdout.flush()
        if len(records) != variants:
            raise AssertionError(f"tool run {run or 'default'}: "
                                 f"{len(records)} variants, not {variants}")
        for rec in records:
            errs = rec["errs"]
            if (rec["failed"] or not math.isfinite(rec["ms"]) or not errs
                    or not all(math.isfinite(v) for v in errs.values())
                    or errs.get("max |P - plain|", 0.0) != 0.0
                    or any(v > X9_MEAN for label, v in errs.items()
                           if "mean err vs v7 plain" in label)):
                raise AssertionError(f"tool variant failed, or its time or "
                                     f"error is not finite, not exact or "
                                     f"off its plain version: {rec}")
    launches = _read_counts()
    _log(f"launches in the ten tool runs: {launches} (with a check, a "
         f"warm-up and 20 timed calls per variant: 88 X3, 22 X4, 44 X5, "
         f"44 X6, 66 X7, 132 X8, 22 X9)")
    if any(launches[name] < 1 for name in TOOL_KERNELS):
        raise AssertionError(f"tool runs missed one of X1-X9: {launches}")
    return launches


def _f64_errors(k, x1, x2, g2d):
    """Max error over max |ref| of K1, K2 and their f32 plain versions
    against the plain version run in float64 on the f32 inputs (both
    kernels round their operands to bf16, so their errors here are
    bf16's)."""
    import torch
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    for name, kern, plain, args in (
            ("K1", sj.joint_fwd, sj.displacement_joint_dense, (x1, x2)),
            ("K2", sj.joint_dgrad, sj.dgrad_plain, (g2d, x2))):
        ref = plain(*(a.double() for a in args), HALF_T)
        assert ref.dtype == torch.float64
        scale = float(ref.abs().max())
        errs = [float((f(*args, HALF_T).double() - ref).abs().max()) / scale
                for f in (kern, plain)]
        _log(f"  {name} vs float64: max err / max|ref| kernel {errs[0]:.3e},"
             f" plain f32 {errs[1]:.3e}")


# Device-time families of a step, matched on kernel names in this order;
# the hand-written kernels come first, from each path's ``focus``
FAMILIES = (
    ("cuDNN convolutions", ("implicit_gemm", "xmma", "cask")),
    ("BatchNorm", ("batchnorm", "batch_norm", "bn_fw", "bn_bw")),
    ("NCHW/NHWC layout transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("max-pool", ("max_pool",)),
    ("Adam", ("multi_tensor_apply", "Adam")),
)


def _profile(tag, step, batches, trace_dir, focus, steps=3):
    """Two warm-up steps, ``steps`` timed steps (host clock, synchronised),
    then ``steps`` more under torch.profiler: device busy share, device time
    by kernel and by family, and the share of the kernels named in
    ``focus``. Launches here are not counted: the counts were read after
    the trainer runs. Returns {family: device ms a step}, with the wall
    ("wall") and the device busy time ("busy") a step."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(first):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            float(step(*batches[(first + i) % len(batches)])[0])
        return (time.perf_counter() - t0) / steps * 1e3

    for batch in batches[:2]:
        float(step(*batch)[0])
    wall = run(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = run(2 + steps)
    # user annotations (e.g. Optimizer.step) span their kernels: skip them
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    busy = sum(e.self_device_time_total for e in events) / steps / 1e3
    share = 100 * busy / wall
    _log(f"profile {tag}: {wall:.2f} ms/step wall ({wall_prof:.2f} under "
         f"the profiler), device busy {busy:.2f} ms/step ({share:.1f}% of "
         f"the unprofiled wall), mean of {steps} steps")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:12]:
        _log(f"    {e.self_device_time_total / steps / 1e3:9.3f} ms "
             f"x{e.count // steps:<4d} {e.key[:90]}")
    families = (("kernels " + "/".join(focus), focus),) + FAMILIES
    fams = {}
    for e in events:
        name = next((n for n, keys in families
                     if any(k in e.key for k in keys)),
                    "other elementwise / reductions")
        fams[name] = (fams.get(name, 0.0)
                      + e.self_device_time_total / steps / 1e3)
    for name, ms in sorted(fams.items(), key=lambda f: -f[1]):
        _log(f"    family {name}: {ms:.3f} ms/step ({100 * ms / busy:.2f}% "
             f"of device busy)")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{tag.replace(' ', '_')}.json"))
    return {**fams, "wall": wall, "busy": busy}


def _side_by_side(profiles):
    """Each profiled step's device time by family in f32 beside bf16:
    ``profiles`` maps (path, head) to {dtype: ``_profile``'s result}."""
    for (path, head), by_dtype in profiles.items():
        f32, bf16 = by_dtype["float32"], by_dtype["bfloat16"]
        _log(f"{path} head {head}, ms a step, float32 -> bfloat16: wall "
             f"{f32['wall']:.3f} -> {bf16['wall']:.3f}, device busy "
             f"{f32['busy']:.3f} -> {bf16['busy']:.3f}; by family:")
        fams = (set(f32) | set(bf16)) - {"wall", "busy"}
        for name in sorted(fams, key=lambda n: -f32.get(n, 0.0)):
            a, b = f32.get(name, 0.0), bf16.get(name, 0.0)
            ratio = f"{b / a:.3f}x" if a else "new"
            _log(f"    {name}: {a:.3f} -> {b:.3f} ({ratio})")


def phase_profile(trace_dir, dtype):
    """Steady head-A and head-B steps of the segmentation path in
    ``dtype``. Returns {head: ``_profile``'s result}."""
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
    from iic_tpu_torch.parallel.train_step import (make_optimizer,
                                                   make_seg_train_step)

    cfg = parse_seg_args(CLI_ARGS + ["--model_dtype", dtype]).finalize(
        twohead=True)
    torch.manual_seed(0)
    pipe = SegTrainPipeline(cfg, ["train"], seed=0, device="cuda")
    net = models.build(cfg.arch, cfg).cuda()
    opt = make_optimizer(net, cfg)
    batches = [((imgs, masks), gen) for imgs, masks, gen in pipe.epoch(1)]
    out = {}
    for head, lamb in (("A", cfg.lamb_A), ("B", cfg.lamb_B)):
        step = make_seg_train_step(
            net, opt, lamb=lamb, head=head, half_T_side_dense=HALF_T,
            half_T_side_sparse_min=0, half_T_side_sparse_max=0, sobel=True,
            include_rgb=True, use_uncollapsed_loss=True, augment=pipe.augment)
        out[head] = _profile(
            f"{dtype} seg head {head}", step, batches, trace_dir,
            ("joint_fwd_mma_kernel", "jf_layout_kernel",
             "joint_partial_kernel", "joint_reduce_kernel",
             "dgrad_v8_kernel", "dgrad_kernel"))
    return out


def phase_cluster_profile(trace_dir, dtype):
    """Steady head-A and head-B steps of the clustering path (K3 on) in
    ``dtype``. Returns {head: ``_profile``'s result}."""
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
    from iic_tpu_torch.parallel.train_step import (make_cluster_train_step,
                                                   make_optimizer)

    cfg = _cluster_cfg(dtype)
    torch.manual_seed(0)
    pipe_a, pipe_b, _, _ = cluster_twohead_create_dataloaders(
        cfg, seed=0, device="cuda")
    net = models.build(cfg.arch, cfg).cuda()
    opt = make_optimizer(net, cfg)
    out = {}
    for head, pipe in (("A", pipe_a), ("B", pipe_b)):
        step = make_cluster_train_step(
            net, opt, pipe.augment_pair, lamb=cfg.lamb, head=head, sobel=True,
            include_rgb=cfg.include_rgb, loss_impl="fused")
        batches = [b for _, b in zip(range(8), pipe.epoch(1))]
        out[head] = _profile(
            f"{dtype} cluster head {head}", step, batches, trace_dir,
            ("iid_loss_cluster_kernel", "iid_loss_block_kernel"))
    return out


def _cluster_cfg(dtype):
    """Model 640's config (``CLUSTER_CLI_ARGS``) in ``dtype``."""
    from iic_tpu_torch.cli._args import parse_cluster_args

    cfg = parse_cluster_args(CLUSTER_CLI_ARGS + ["--model_dtype", dtype])
    cfg.lamb_A = cfg.lamb_B = cfg.lamb
    cfg.finalize(twohead=True, sobel=True)
    return cfg


# bench.py:117-131's method: 2 warm and 4 timed passes, heads A and B
# alternating full passes, one continuous stream at depth 8
RATE_WARM, RATE_TIMED, RATE_DEPTH = 2, 4, 8
REFERENCE_PAIRS_PER_SEC = 33.0 / 4.0  # bench.py:24, the reference per GPU
CLUSTER_WARM, CLUSTER_TIMED = 1, 2  # head-A passes of model 640


def _stream(pipe, epochs, prefetch):
    """(epoch, batch...) over ``epochs``: one prefetch thread at
    ``RATE_DEPTH`` (``prefetch_epochs``) or the same chain in the
    caller's thread."""
    from iic_tpu_torch.data.prefetch import prefetch_epochs

    if prefetch:
        return prefetch_epochs(pipe, epochs, depth=RATE_DEPTH)
    return ((e_i, *item) for e_i in epochs for item in pipe.epoch(e_i))


def _seg_rate(dtype, prefetch):
    """Aug-pairs/s of model 555's training at batch 120 by bench.py's
    method: the timer starts at a ``float(loss)`` barrier when the first
    batch of the first timed pass arrives and stops at one after the
    last step."""
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
    from iic_tpu_torch.parallel.train_step import (make_optimizer,
                                                   make_seg_train_step)

    cfg = parse_seg_args(CLI_ARGS + ["--model_dtype", dtype]).finalize(
        twohead=True)
    torch.manual_seed(0)
    pipe = SegTrainPipeline(cfg, ["train"], seed=0, device="cuda")
    net = models.build(cfg.arch, cfg).cuda()
    opt = make_optimizer(net, cfg)
    steps = {h: make_seg_train_step(
        net, opt, lamb=lamb, head=h, half_T_side_dense=HALF_T,
        half_T_side_sparse_min=0, half_T_side_sparse_max=0, sobel=True,
        include_rgb=True, use_uncollapsed_loss=True, augment=pipe.augment)
        for h, lamb in (("A", cfg.lamb_A), ("B", cfg.lamb_B))}
    loss, t0, n_pairs = None, None, 0
    for e_i, imgs, masks, gen in _stream(
            pipe, range(RATE_WARM + RATE_TIMED), prefetch):
        if e_i == RATE_WARM and t0 is None:
            float(loss)  # barrier: the warm passes fully drained
            t0 = time.perf_counter()
        loss, _ = steps["AB"[e_i % 2]]((imgs, masks), gen)
        if t0 is not None:
            n_pairs += int(imgs.shape[0])
    if not math.isfinite(float(loss)):
        raise AssertionError(f"{dtype} rate run: loss {float(loss)}")
    return n_pairs / (time.perf_counter() - t0)


def _cluster_wall(dtype, prefetch):
    """Model 640's head-A steps (``--fused_loss``), ms of wall a step over
    ``CLUSTER_TIMED`` whole passes after ``CLUSTER_WARM``, between
    ``float(loss)`` barriers, as ``_seg_rate`` times them."""
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
    from iic_tpu_torch.parallel.train_step import (make_cluster_train_step,
                                                   make_optimizer)

    cfg = _cluster_cfg(dtype)
    torch.manual_seed(0)
    pipe, _, _, _ = cluster_twohead_create_dataloaders(cfg, seed=0,
                                                       device="cuda")
    net = models.build(cfg.arch, cfg).cuda()
    step = make_cluster_train_step(
        net, make_optimizer(net, cfg), pipe.augment_pair, lamb=cfg.lamb,
        head="A", sobel=True, include_rgb=cfg.include_rgb, loss_impl="fused")
    loss, t0, n_steps = None, None, 0
    for e_i, base, gen in _stream(
            pipe, range(CLUSTER_WARM + CLUSTER_TIMED), prefetch):
        if e_i == CLUSTER_WARM and t0 is None:
            float(loss)
            t0 = time.perf_counter()
        loss, _ = step(base, gen)
        n_steps += t0 is not None
    if not math.isfinite(float(loss)):
        raise AssertionError(f"{dtype} cluster wall run: loss {float(loss)}")
    return (time.perf_counter() - t0) / n_steps * 1e3


def phase_rates():
    """The headline rate (a log line, not a benchmark): model 555's
    aug-pairs/s and its ratio to the reference's 33/4 a GPU, and model
    640's wall a step, in f32 and bf16, each behind the prefetch thread
    and without it, in the order with, without, without, with (the host's
    time drifts within a run). Returns {(path, dtype, prefetch): [number
    a run]}."""
    batch = int(CLUSTER_CLI_ARGS[CLUSTER_CLI_ARGS.index("--batch_sz") + 1])
    rates = {}
    for dtype in ("float32", "bfloat16"):
        for prefetch in (True, False, False, True):
            tag = f"{dtype}, " + (f"prefetch depth {RATE_DEPTH}" if prefetch
                                  else "no prefetch")
            rate = _seg_rate(dtype, prefetch)
            rates.setdefault(("seg", dtype, prefetch), []).append(rate)
            _log(f"headline rate, model 555 ({tag}): {rate:.2f} aug-pairs/s, "
                 f"{rate / REFERENCE_PAIRS_PER_SEC:.2f}x the reference's "
                 f"33/4 a GPU")
            wall = _cluster_wall(dtype, prefetch)
            rates.setdefault(("cluster", dtype, prefetch), []).append(wall)
            _log(f"model 640 head A ({tag}): {wall:.2f} ms of wall a step "
                 f"({batch / wall * 1e3:.0f} aug-pairs/s)")
    for (path, dtype, prefetch), runs in rates.items():
        unit = "aug-pairs/s" if path == "seg" else "ms a step"
        _log(f"mean of {len(runs)}: {path} {dtype} prefetch={prefetch}: "
             f"{sum(runs) / len(runs):.2f} {unit}")
    return rates


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--trace_dir", default="",
                        help="write the profiled steps' chrome traces here")
    args = parser.parse_args(argv)

    name, _ = phase_device()
    phase_build()
    _clocks("K1/K2")
    stats = phase_kernels()
    for kernel, tag, phase in (("iid_loss_fwd", "K3", phase_k3),
                               ("joint_fwd_v2", "X2", phase_x2),
                               ("mm_probe", "X1", phase_x1),
                               ("joint_fwd_v8", "X7", phase_x7),
                               (None, "X3-X6", phase_x3_x6),
                               ("dgrad_v8", "X8", phase_x8),
                               ("dgrad_fused_v7", "X9", phase_x9)):
        _clocks(tag)
        if kernel:
            stats[kernel] = phase()
        else:
            stats.update(phase())
    # the CLIs in f32 and in bf16: the kernels' launches on the main path
    # are the sums of the four runs
    launches = {"seg_joint_fwd": 0, "seg_joint_dgrad": 0, "iid_loss_fwd": 0}
    for dtype in ("float32", "bfloat16"):
        _clocks(f"the {dtype} CLI runs")
        for run in (phase_trainer(dtype), phase_cluster_trainer(dtype)):
            for k in launches:
                launches[k] += run[k]
    # the segmentation family's real-data path: K1 and K2 launches of the
    # Potsdam runs and the learning guard add to the table's
    with tempfile.TemporaryDirectory() as potsdam_root:
        t0 = time.perf_counter()
        _write_potsdam(potsdam_root)
        _log(f"Potsdam fixture tree: {POTSDAM_SPLITS} tiles written in "
             f"{time.perf_counter() - t0:.1f} s")
        for tag, phase in (("native", lambda: phase_native(potsdam_root)),
                           ("seg shapes", phase_seg_shapes),
                           ("potsdam", lambda: phase_potsdam(potsdam_root)),
                           ("learning guard", phase_learning_guard)):
            _clocks(f"phase {tag}")
            t0 = time.perf_counter()
            run = phase()
            _log(f"phase {tag}: {time.perf_counter() - t0:.1f} s")
            for k in ("seg_joint_fwd", "seg_joint_dgrad"):
                launches[k] += (run or {}).get(k, 0)
    _clocks("the tool runs")
    launches.update({k: v for k, v in phase_tool().items()
                     if k in TOOL_KERNELS})
    _clocks("the profiles")
    profiles = {}
    for dtype in ("float32", "bfloat16"):
        for path, phase in (("seg", phase_profile),
                            ("cluster", phase_cluster_profile)):
            for head, result in phase(args.trace_dir, dtype).items():
                profiles.setdefault((path, head), {})[dtype] = result
    _side_by_side(profiles)
    _clocks("the rates")
    phase_rates()
    table = [{"name": k, "route": "cuda", "source": SOURCES[k],
              "replaces": REPLACES[k], "launches": launches[k],
              **stats[k]} for k in REPLACES]
    import torch
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
