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
     70 / 660, 10 / 1000, 140 / 700, 50 / 700, 10 / 585, 50): loss and
     loss_nl within rtol = atol =
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
     kernel, K1's error against its bf16 function in float64 and its
     split-K chunk depth printed at each shape, each required within
     K1_F64 (tensor-core form) or K1_F64_FMA (CUDA-core form) of max,
     with each one's CUDA-event ms beside the bf16 F.conv2d
     and its bound; run model 545's two-head CLI (--test_code, bf16) through
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
 10b. the rest of clustering's paper workloads, on fixture trees written
     in a temporary directory, each run with counts set to 0 just before,
     its losses, eval accuracies, launches, seconds and peak device
     memory printed, and each configuration's steady steps profiled as in
     12: a full-size MNIST tree (60 000 raw idx training images, 10 000
     gzipped test images; the port's synthetic clusterable images stand in
     for the digits) through model 685's greyscale two-head CLI in f32 and
     bf16 (one K3 launch a step required) and the single-head greyscale
     IID+ CLI (no K3 launch allowed); an STL10 tree (train 5 000 and test
     8 000 as the real splits, unlabelled cut from 100 000 to 10 000;
     random pixels) through model 569's two-head sobel CLI with
     --mix_train (one K3 launch a step) and model 653's single-head one
     (batch 1400 at 64^2, k 140; no K3), each in f32 and bf16; and the
     digits guard of tests/test_digits_regression.py (its command on the
     Digits set, 12 epochs, f32, --fused_loss: best eval acc >= 0.60 and
     >= 0.25 over the pre-eval) at seed 0, then at seeds 1-4 if it misses,
     one run at least in the band; K3's launches of these runs add to the
     table's;
 10b'. the clustering data entry points, on the same STL10 tree: the
     first 3 uint8 base batches of both heads of model 569's pipelines
     under --lazy_images (memory-mapped readers, --mix_train's lazy
     reorder) equal to the eager pipelines' on the card, bit for bit; then
     model 569's CLI in bf16 with --mix_train --lazy_images and the same
     eager, counts set to 0 just before each, one K3 launch a step
     required, each with the growth of the process's host memory (VmRSS
     and its RssAnon and RssFile parts, sampled every 20 ms) and its wall
     a step; then one --profile_dir epoch of
     the segmentation two-head CLI (model 555's shape) and of the
     clustering one (model 640's), counts set to 0 just before each, each
     trace required to exist, parse as JSON and hold a step_head_<X> span
     a step and K1's and K2's symbols (seg) or K3's (cluster), its size in
     MB printed; their K1, K2 and K3 launches add to the table's; the
     phase's wall time printed;
 10c. the semisup finetune (table 3), on the same STL10 tree: model 650
     (model 653's command with k 70) through the single-head sobel CLI,
     then model 698's finetune from it through IID_semisup_STL10 (table
     3's flags, --test_code: the old run's batch of 1400 at 64^2, the
     trunk read before layer4, SupHead5 at 20 736 -> 2048 -> 10, the
     random affine and cutout, the 10-crop eval of all 8 000 test images
     before training and after the epoch), once from an f32 old run and
     once from a bf16 one, then --restart of the f32 finetune (it must
     resume at epoch 1); each run with counts set to 0 just before must
     launch no kernel; losses, accuracies (of random pixels: they mean
     nothing), the eval's seconds and peak device memory printed, the
     steady steps of model 650 and of each finetune profiled as in 12 and
     the finetune's eval timed; then
     tests/test_semisup_regression.py's Digits pipeline (10 epochs of the
     greyscale IID+ pretrain, 11 of the finetune at batch 128) and its band
     (last CE below half the first and below 0.5, best 10-crop accuracy
     >= 0.80 and >= 0.30 over the pre-train eval) at seed 0, then at seeds
     1-4 if it misses, one run at least in the band;
 10d. the trainable baselines through their CLIs, each run with counts set
     to 0 just before and required to launch no kernel, with finite
     losses and eval accuracies and an eval history of 2 entries at least:
     triplets sobel at model 640's data shape (TripletsNet5g, 660 at 32²)
     in f32, in bf16, with --kmeans_on_features and with --restart (it
     must resume at epoch 2), triplets greyscale at model 685's MNIST flags
     on the MNIST tree (TripletsNet6c, f32), Doersch (colour dropping on)
     and Isola at model 555's data shape (120 at 128², patch side 11,
     f32), each also with --per_sample_patches, and Doersch's --restart
     for epochs 2 and 3 under --save_multiple (it must leave e_3); a
     profile of steady steps of each (triplets also in bf16) with its peak
     memory; then the port's k-means on the card at 50 000 x 512 (k 3 and
     15) and 10 000 x 512 (k 10), timed, with its Lloyd iterations held
     one by one to the same iterations in float64 on the host (labels
     equal but within 1e-6 of a tie, centroids within 1e-4 of max), also
     timed, and accuracy 1.0 on separated clusters; each part's seconds
     printed;
 10e. the serving and analysis path (``infer.py``, ``cli/export_model``,
     ``cli/import_torch``, ``cli/analysis``): models 640 (f32), 555 (f32)
     and 545 (bf16, on a Potsdam fixture tree) trained for one --test_code
     epoch (set-up; their launches are printed and not the table's), then,
     counts set to 0 and at PyTorch's TF32 defaults (cuDNN on, cuBLAS off)
     in both processes: each run's ``load_run`` on cuda and its predictor
     (in f32 and in bf16) against the eager eval path (the mapping
     loader's transform, the best sub-head's argmax, the match), ids equal
     but within 1e-4 of a tie (the near ties counted); each predictor
     exported with a symbolic batch and served by a child that imports
     torch alone (it asserts the port is not loaded) at batches 1, 37 and
     the run's own, held to the eager ids the same way (the ids that
     cuDNN's TF32 itself moves counted beside, with it off); the eager and
     exported predictors' CUDA-event ms, images/s and peak memory at
     batches 1, 64 and the run's; a reference-layout checkpoint of model
     640's arch imported by ``python -m iic_tpu_torch.cli.import_torch``,
     its forward equal to the source net's, then its --restart for one
     epoch (finite losses); ``cli/analysis/eval`` (model 640) and
     ``render_general --reassess_acc`` (model 555) within 1 / images of
     the stored accuracy, ``print_sub_heads_eval`` and the fewer-labels
     tool at pc 0.1; the PNG steps where PIL is found (else printed as
     proved on the CPU only); no kernel launch in any of it;
 10f. data parallelism (``iic_tpu_torch/parallel/mesh.py``): R = min(visible
     cards, 4) ranks, one process a card over NCCL, spawned by the
     script (R = 1: world size 1 through the same group and collectives,
     and a line saying that no cross-card check ran); each rank runs
     model 555's two-head CLI with --n_devices R in f32 and bf16 (120
     pairs global) and model 640's clustering CLI (plain loss: K3 is
     refused under a mesh), each rank's K1, K2 and K3 launches read after
     each run (K1 and K2 required on every rank, K3 on none; the seg runs'
     K1 and K2 add to the table's); the R-rank step of model 555 (global
     mode, --bn_sync, TF32 off, SGD) against one rank on the whole batch,
     loss, gradients, parameters and BN statistics within 4x what one rank
     moves by itself on the batch reversed (1e-4 at least); one step of
     model 698's finetune on each rank's shard, from the semisup phase's
     f32 model-650 run; each rank's wall and device time a head-A step
     and its all-reduce (NCCL kernels) time by torch.profiler, beside the
     cards' names and power limits;
 10g. the paper-parity harness and the learning evidence
     (``iic_tpu_torch/tools/paper_parity.py``, ``learning_evidence.py``),
     after 10d on the MNIST and STL10 trees, with a Potsdam tree and a
     CIFAR10 one (5 x 264 training images of the synthetic clusterable
     set in pickle batches) written beside them: ``check`` of all 13
     BASELINE.md rows (OK for the rows whose trees exist, MISSING for the
     COCO rows and CIFAR20, rc 1) and of an empty root (rc 1); ``run`` on
     cuda:0 of Potsdam-3 (model 545), MNIST (685, ``--fused_loss`` after
     ``--``) and CIFAR10 (640), each ``-- --test_code --num_epochs 2`` at
     its paper widths and batch, one call a row, each row's child wrapped
     to print its K1, K2 and K3 launches and steps on its log's last line
     (rc 0 each; K1 >= 4 and K2 >= 8 in Potsdam-3's, K3 one a step in
     MNIST's, none in CIFAR10's; they add to the table's), the rows on a
     thread while the learning evidence's twohead (its entry point
     ``run_twohead`` at seeds 0-2, a child each, all at once; the tool's
     line held to the run's accuracies, each seed's accuracies and both
     heads' epoch losses printed), semisup and
     digits_baselines run whole in this process (finite numbers, no
     kernel launch; each accuracy printed beside JAX's VALIDATION.md
     figure, not gated; the digits k-means fits within 1.01x of float64
     Lloyd's inertia from the same seeds and held to
     ``replay_float64``); then ``report`` of the three (each a parsed
     accuracy in [0, 1]); nuisance_probe's skip is printed with its
     reason; the phase's seconds printed;
 11. run the port's experiment tool in-process at its default size (120 15
     128 10): the default run, ``ablate``, ``mmprobe``, ``v3``, ``v4``,
     ``v5``, ``v6``, ``kpad``, ``v8`` and ``v7``, counts set to 0 just
     before; from the records the tool returns, require every variant to
     report, none FAILED, finite times and errors, the exact ablations
     exact, X9 within 1e-5 mean of its float64 plain version, and at least
     one launch of X1-X9;
 11a. run the port's four measurement tools in-process at their default
     shapes (``iic_tpu_torch/tools/``: ``joint_kernel_bench`` 120 15 128
     10, ``fused_loss_bench``, ``eval_cost_bench`` all,
     ``e2e_gap_trace`` at bench.py's config, its trace under --trace_dir
     when given), counts set to 0 just before each and printed just after:
     K1 and K2 required in the joint bench and the gap trace, K3 in the
     fused-loss bench, none in the eval bench (they add to the table's);
     then the joint bench's kernel within K1_F64 of max of its bf16
     function in float64 and its P and both input gradients against the
     plain conv's within the JAX contract; the fused-loss bench's fused
     loss against xla's, and both gradients, within K3's contract, with
     K3's host ms a call and device ms printed; finite eval numbers; each
     gap-trace run's split adding up to its wall, with one wait and one
     host prep a batch;
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
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

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
# heads A and B, the CIFAR20 overclustering head of model 579, model 685's
# heads A and B (MNIST; k=50 a new micro-tile count), model 569's head A,
# and the Digits guard's heads A and B on the Digits set's ragged last
# batch (1797 = 12 x 140 + 117 images, x 5)
K3_SHAPES = ((5, 660, 70), (5, 660, 10), (5, 1000, 140), (5, 700, 50),
             (5, 700, 10), (5, 700, 70), (5, 585, 50), (5, 585, 10))
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


def _cluster_cli(main, argv, tag, heads="AB"):
    """One clustering CLI run in-process, counts set to 0 just before and
    the peak of device memory reset: prints its losses, step seconds, eval
    accuracies, launches and peak memory; fails on a loss of ``heads``
    (the single-head scripts log in the B slots) or an eval history that
    is not finite or has fewer than 2 entries (the pre-train eval and one
    epoch's). Returns (history, launches, steps)."""
    import numpy as np
    import torch

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = main(argv)
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    n_steps = 0
    for head in heads:
        losses = history[f"epoch_loss_head_{head}"]
        steps = history[f"step_seconds_head_{head}"]
        n_steps += len(steps)
        _log(f"{tag} head {head}: epoch loss {losses}, step seconds "
             f"{[round(v, 4) for v in steps]}")
        if not losses or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{tag} head {head} loss not finite: "
                                 f"{losses}")
    acc = history["eval"].epoch_acc
    _log(f"{tag}: eval acc per epoch (pre-train first) {acc}; "
         f"{seconds:.1f} s; launches {launches}; peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(acc) < 2 or not np.all(np.isfinite(acc)):
        raise AssertionError(f"{tag}: eval history not filled: {acc}")
    return history, launches, n_steps


def _k3_per_step(tag, launches, n_steps):
    """A two-head --fused_loss run launches K3 once a step (all five
    sub-heads in one launch)."""
    _log(f"{tag}: {launches['iid_loss_fwd']} K3 launches in {n_steps} "
         f"steps")
    if launches["iid_loss_fwd"] != n_steps:
        raise AssertionError(f"{tag}: {launches['iid_loss_fwd']} K3 "
                             f"launches for {n_steps} steps")


def phase_cluster_trainer(dtype):
    """The clustering CLI in-process in ``dtype`` (``--model_dtype``),
    behind the default prefetch thread. Returns {kernel: launches in the
    run}."""
    import numpy as np
    from iic_tpu_torch.cli import cluster_sobel_twohead

    with tempfile.TemporaryDirectory() as out_root:
        history, launches, n_steps = _cluster_cli(
            cluster_sobel_twohead.main,
            CLUSTER_CLI_ARGS + ["--model_dtype", dtype, "--out_root",
                                out_root], f"{dtype} cluster")
    double = history["eval"].double_eval_acc
    _log(f"double eval acc: {double}")
    if len(double) < 2 or not np.all(np.isfinite(double)):
        raise AssertionError(f"double eval history not filled: {double}")
    _k3_per_step(f"the {dtype} clustering run", launches, n_steps)
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
    runs X8's kernel, K1's error against its bf16 function in float64 with
    its split-K chunk depth at every shape, each required within K1_F64
    (tensor-core form) or K1_F64_FMA (CUDA-core form) of max; CUDA-event ms
    of each beside the bf16 F.conv2d library call and its bound, and the
    form taken."""
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
            # K1's f32 sums against its bf16 function in float64, with the
            # depth of its split-K chunks, a check at every shape (a shape
            # over the bound is a fault to record, not a bound to raise)
            ref64 = sj.joint_fwd_bf16_plain(x1.double(), x2.double(), half_t)
            tol = K1_F64 if k1f == "wgmma" else K1_F64_FMA
            e64 = (float((got.double() - ref64).abs().max())
                   / float(ref64.abs().max()))
            if k1f == "wgmma":
                per, splits = sj.k1_plan(n, k, hw, half_t)
                depth = f"{per * sj.K1_RB} rows a chunk, {splits} chunks"
            else:
                splits, per = sj._split(n * hw, (-(-(k * t) // sj._TILE))
                                        ** 2)
                depth = f"{per} rows a chunk, {splits} chunks"
            _log(f"  K1 vs float64 of its bf16 operands ({k1f}, {depth}): "
                 f"max err / max|ref| {e64:.3e} (bound {tol:g}: "
                 f"{'within' if e64 <= tol else 'OVER'}, checked)")
            if not e64 <= tol:
                raise AssertionError(f"K1 at model {model} head {head} is "
                                     f"{e64:.3e} of max off its bf16 "
                                     f"function in float64 (bound {tol:g})")
            del got, ref, ref64
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


# Model 685's batch and transform flags (MNIST, examples/commands.md:46-52)
MNIST_TF_ARGS = [
    "--gt_k", "10", "--lr", "0.0001", "--batch_sz", "700",
    "--num_dataloaders", "5", "--num_sub_heads", "5", "--crop_orig",
    "--crop_other", "--tf1_crop", "centre_half", "--tf2_crop", "random",
    "--tf1_crop_sz", "20", "--tf2_crop_szs", "16", "20", "24",
    "--input_sz", "24", "--rot_val", "25", "--no_flip"]
# Model 685 with --fused_loss --test_code; --dataset_root is added where it
# runs
MNIST685_ARGS = [
    "--model_ind", "685", "--arch", "ClusterNet6cTwoHead", "--mode", "IID",
    "--dataset", "MNIST", "--output_k_A", "50", "--output_k_B", "10",
    "--lamb_A", "1.0", "--lamb_B", "1.0", "--num_epochs", "3200",
    *MNIST_TF_ARGS, "--head_B_epochs", "2", "--fused_loss", "--test_code"]
# The single-head greyscale script (the JAX package's model 665 runs it):
# model 685's batch and transform flags with one overclustering head
MNIST_SINGLE_ARGS = [
    "--model_ind", "665", "--arch", "ClusterNet6c", "--mode", "IID+",
    "--dataset", "MNIST", "--output_k", "50", "--lamb", "1.0",
    "--num_epochs", "3200", *MNIST_TF_ARGS, "--fused_loss", "--test_code"]
MNIST_SPLITS = {"train": 60000, "t10k": 10000}
# STL10 model 569 (examples/commands.md:28-33) with --fused_loss
# --test_code, and model 653 (:60-64), single-head IID+ overclustering
STL569_ARGS = [
    "--model_ind", "569", "--arch", "ClusterNet5gTwoHead", "--mode", "IID",
    "--dataset", "STL10", "--gt_k", "10", "--output_k_A", "70",
    "--output_k_B", "10", "--lamb", "1.0", "--lr", "0.0001",
    "--num_epochs", "2000", "--batch_sz", "700", "--num_dataloaders", "5",
    "--num_sub_heads", "5", "--mix_train", "--crop_orig",
    "--rand_crop_sz", "64", "--input_sz", "64", "--head_A_first",
    "--double_eval", "--batchnorm_track", "--fused_loss", "--test_code"]
STL653_ARGS = [
    "--model_ind", "653", "--arch", "ClusterNet5g", "--dataset", "STL10",
    "--num_epochs", "3200", "--output_k", "140", "--gt_k", "10",
    "--lr", "0.0001", "--lamb", "1.0", "--num_sub_heads", "5",
    "--batch_sz", "1400", "--num_dataloaders", "5", "--mix_train",
    "--crop_orig", "--rand_crop_sz", "64", "--input_sz", "64",
    "--mode", "IID+", "--batchnorm_track", "--test_code"]
# Table 3 (examples/commands.md:72-78): model 650, the figure-6 run its
# "..." stands for (model 653's command with --model_ind 650 --output_k 70;
# --save_freq 1, so that the --test_code run leaves a latest.pytorch for
# the finetune to read, as the full run's every 10th epoch would), then
# model 698's finetune from it with --test_code
STL650_ARGS = [*STL653_ARGS, "--model_ind", "650", "--output_k", "70",
               "--save_freq", "1"]
SEMISUP698_ARGS = [
    "--model_ind", "698", "--old_model_ind", "650", "--head_lr", "0.001",
    "--trunk_lr", "0.0001", "--arch", "SupHead5", "--penultimate_features",
    "--random_affine", "--affine_p", "0.5", "--cutout", "--cutout_p", "0.5",
    "--cutout_max_box", "0.7", "--num_epochs", "8000", "--test_code"]
# tests/test_semisup_regression.py:37-56: the Digits pipeline (IID+
# pretrain, 10 epochs, then 11 epochs of SupHead5) and its band (:84-94)
SEMISUP_GUARD_OLD = [
    "--model_ind", "910", "--arch", "ClusterNet6c", "--mode", "IID+",
    "--dataset", "Digits", "--gt_k", "10", "--output_k", "20",
    "--lamb", "1.0", "--lr", "0.0001", "--num_epochs", "10",
    "--batch_sz", "700", "--num_dataloaders", "3", "--num_sub_heads", "1",
    "--crop_orig", "--crop_other", "--tf1_crop", "centre_half",
    "--tf2_crop", "random", "--tf1_crop_sz", "20", "--tf2_crop_szs", "16",
    "20", "24", "--input_sz", "24", "--rot_val", "25", "--no_flip"]
SEMISUP_GUARD_NEW = [
    "--model_ind", "911", "--old_model_ind", "910", "--arch", "SupHead5",
    "--head_lr", "0.001", "--trunk_lr", "0.0001", "--num_epochs", "11",
    "--new_batch_sz", "128"]
SEMISUP_BEST, SEMISUP_GAIN, SEMISUP_LAST_CE = 0.80, 0.30, 0.5
SEMISUP_SEEDS = (0, 1, 2, 3, 4)
# the kernels of the other paths, none of which a semisup step may launch
K_KERNEL_NAMES = ("joint_fwd_mma_kernel", "jf_layout_kernel",
                  "joint_partial_kernel", "joint_reduce_kernel",
                  "dgrad_v8_kernel", "dgrad_kernel",
                  "iid_loss_cluster_kernel", "iid_loss_block_kernel")
# The STL10 tree: the real train and test splits' sizes; the unlabelled
# split cut from 100 000 to 10 000 images, so --mix_train puts 2
# unlabelled images after each labelled one, not 20
STL_SPLITS = {"train": 5000, "test": 8000, "unlabeled": 10000}
# tests/test_digits_regression.py:63-92: the JAX package's real-data guard
# (the paper's MNIST command on the UCI digits, 12 epochs, band calibrated
# on the TPU: 0.70 at epoch 10), through the port's greyscale two-head CLI
# in f32 with --fused_loss
DIGITS_ARGS = [
    "--model_ind", "1", "--arch", "ClusterNet6cTwoHead", "--mode", "IID",
    "--dataset", "Digits", "--gt_k", "10", "--output_k_A", "50",
    "--output_k_B", "10", "--lamb_A", "1.0", "--lamb_B", "1.0",
    "--lr", "0.0001", "--num_epochs", "12", "--batch_sz", "700",
    "--num_dataloaders", "5", "--num_sub_heads", "5", "--crop_orig",
    "--crop_other", "--tf1_crop", "centre_half", "--tf2_crop", "random",
    "--tf1_crop_sz", "20", "--tf2_crop_szs", "16", "20", "24",
    "--input_sz", "24", "--rot_val", "25", "--no_flip",
    "--head_B_epochs", "2", "--fused_loss"]
DIGITS_BEST, DIGITS_GAIN = 0.60, 0.25
DIGITS_SEEDS = (0, 1, 2, 3, 4)
TF2_STEPS, TF2_ROUNDS = 20, 3  # _tf2_grouping_cost's rounds


def _idx_bytes(arr):
    """An idx file's bytes: magic (uint8, ndim), the dimensions, the
    data."""
    head = (0x0800 | arr.ndim).to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in arr.shape)
    return head + arr.astype("uint8").tobytes()


def _write_mnist(root):
    """A full-size MNIST tree under root/MNIST/raw: 60 000 training images
    as raw idx files, 10 000 test images gzipped, 28 x 28. The images are
    a stand-in: the port's clusterable synthetic set (10 classes, one smooth
    pattern each, plus noise), not handwritten digits."""
    import gzip
    import os
    from iic_tpu_torch.data.readers import make_synthetic

    base = os.path.join(root, "MNIST", "raw")
    os.makedirs(base, exist_ok=True)
    for i, (prefix, n) in enumerate(MNIST_SPLITS.items()):
        d = make_synthetic(n, 10, 28, 1, seed=i)
        for kind, arr in (("images-idx3", d["images"][..., 0]),
                          ("labels-idx1", d["labels"])):
            path = os.path.join(base, f"{prefix}-{kind}-ubyte")
            if prefix == "train":
                with open(path, "wb") as f:
                    f.write(_idx_bytes(arr))
            else:
                with gzip.open(path + ".gz", "wb", compresslevel=1) as f:
                    f.write(_idx_bytes(arr))


def _cluster_profile(tag, cli, argv, heads, dtype, trace_dir=""):
    """``_profile`` of steady steps of each head in ``heads`` of the
    clustering config that the CLI module ``cli`` makes of its flags
    ``argv`` (``cli.config``) in ``dtype``, on its own
    pipelines over the same data (the two-head steps with K3 under
    --fused_loss; the single-head step, ``heads`` "B", with the plain
    loss, as its trainer runs it). Returns {head: ``_profile``'s
    result}."""
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.data.pipeline import (
        cluster_create_dataloaders, cluster_twohead_create_dataloaders)
    from iic_tpu_torch.parallel.train_step import (make_cluster_train_step,
                                                   make_optimizer)

    cfg = cli.config(argv + ["--model_dtype", dtype])
    twohead = cfg.twohead
    torch.manual_seed(0)
    if twohead:
        pipes = dict(zip("AB", cluster_twohead_create_dataloaders(
            cfg, device="cuda")[:2]))
        lambs = {"A": cfg.lamb_A, "B": cfg.lamb_B}
    else:
        pipes = {"B": cluster_create_dataloaders(cfg, device="cuda")[0]}
        lambs = {"B": cfg.lamb}
    net = models.build(cfg.arch, cfg).cuda()
    opt = make_optimizer(net, cfg)
    out = {}
    for head in heads:
        step = make_cluster_train_step(
            net, opt, pipes[head].augment_pair, lamb=lambs[head],
            head=head if twohead else None, sobel=cfg.sobel,
            include_rgb=cfg.include_rgb,
            loss_impl="fused" if twohead and cfg.fused_loss else "xla")
        batches = [b for _, b in zip(range(8), pipes[head].epoch(1))]
        out[head] = _profile(f"{tag} {dtype} head {head}", step, batches,
                             trace_dir, ("iid_loss_cluster_kernel",
                                         "iid_loss_block_kernel"))
    return out


def phase_mnist(root):
    """Model 685 through the port's greyscale two-head CLI on a full-size
    MNIST tree (``_write_mnist``), in f32 and in bf16, each launching K3
    once a step; then the single-head greyscale CLI (``MNIST_SINGLE_ARGS``:
    the repo has no verbatim command for model 665, the JAX package's
    single-head MNIST model, so it is model 685's transform and batch flags
    with ``--arch ClusterNet6c --mode IID+ --output_k 50``), which runs the
    plain loss under --fused_loss and must launch K3 no time. Returns
    {kernel: launches}."""
    from iic_tpu_torch.cli import cluster_greyscale, cluster_greyscale_twohead

    total = {"iid_loss_fwd": 0}
    with tempfile.TemporaryDirectory() as out_root:
        for dtype in ("float32", "bfloat16"):
            _, launches, n_steps = _cluster_cli(
                cluster_greyscale_twohead.main, MNIST685_ARGS + [
                    "--dataset_root", root, "--model_dtype", dtype,
                    "--out_root", out_root], f"model 685 {dtype}")
            _k3_per_step(f"model 685 {dtype}", launches, n_steps)
            total["iid_loss_fwd"] += launches["iid_loss_fwd"]
        _, launches, _ = _cluster_cli(
            cluster_greyscale.main, MNIST_SINGLE_ARGS + [
                "--dataset_root", root, "--out_root", out_root],
            "single-head greyscale IID+", heads="B")
    if launches["iid_loss_fwd"]:
        raise AssertionError(f"the single-head run launched K3: {launches}")
    root_arg = ["--dataset_root", root]
    for dtype in ("float32", "bfloat16"):
        _cluster_profile("model 685", cluster_greyscale_twohead,
                         MNIST685_ARGS + root_arg, "AB", dtype)
    _cluster_profile("single-head greyscale", cluster_greyscale,
                     MNIST_SINGLE_ARGS + root_arg, "B", "float32")
    _tf2_grouping_cost(MNIST685_ARGS + root_arg)
    return total


def _choice_crop_resize_where(img, crop_szs, choice, top, left, out_sz):
    """``choice_crop_resize_at`` without its host sync, for the timing
    in ``_tf2_grouping_cost`` only: every sample cropped (at its corner,
    clamped into the image) and resized at every size, each sample's own
    size picked with ``where``."""
    import torch
    from iic_tpu_torch.data import transforms as tt

    h, w = img.shape[1:3]
    out = None
    for i, sz in enumerate(crop_szs):
        one = tt.resize(tt.crop_at(img, top.clamp(max=h - sz),
                                   left.clamp(max=w - sz), sz), out_sz)
        out = one if out is None else torch.where(
            (choice == i)[:, None, None, None], one, out)
    return out


def _tf2_grouping_cost(argv):
    """Model 685's head-A step in f32 (``argv``: its flags), its tf2's
    crop grouped by size (the port's, one host sync a step for the group
    sizes) against every sample cropped and resized at every size and
    picked with ``where`` (no sync): first the two on one batch's draws
    (equal within 1e-6), then ms of wall a step over ``TF2_STEPS`` steps,
    each ending in ``float(loss)`` as the trainer's do, and ms of wall an
    ``augment_pair`` call alone (synchronised), in ``TF2_ROUNDS`` x the
    rounds grouped, where, where, grouped. Returns {(what, variant): [ms a
    round]}."""
    import statistics

    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.cli import cluster_greyscale_twohead
    from iic_tpu_torch.data import transforms as tt
    from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
    from iic_tpu_torch.parallel.train_step import (make_cluster_train_step,
                                                   make_optimizer)

    cfg = cluster_greyscale_twohead.config(argv)
    torch.manual_seed(0)
    pipe = cluster_twohead_create_dataloaders(cfg, device="cuda")[0]
    net = models.build(cfg.arch, cfg).cuda()
    step = make_cluster_train_step(
        net, make_optimizer(net, cfg), pipe.augment_pair, lamb=cfg.lamb_A,
        head="A", sobel=False, include_rgb=cfg.include_rgb,
        loss_impl="fused")
    batches = [b for _, b in zip(range(8), pipe.epoch(1))]
    variants = {"grouped": tt.choice_crop_resize_at,
                "where": _choice_crop_resize_where}
    img = batches[0][0].float() / 255.0
    draws = tt.draw_choice_crop(*img.shape[:3], tuple(cfg.tf2_crop_szs),
                                cfg.tf2_crop, torch.Generator(
                                    device="cuda").manual_seed(0), "cuda")
    got = {name: fn(img, tuple(cfg.tf2_crop_szs), *draws, cfg.input_sz)
           for name, fn in variants.items()}
    _check("tf2 crop, where vs grouped", got["where"], got["grouped"],
           0.0, 1e-6)
    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TF2_STEPS):
            fn(*batches[i % len(batches)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TF2_STEPS * 1e3

    walls = {}
    try:
        for name in ("grouped", "where", "where", "grouped") * TF2_ROUNDS:
            tt.choice_crop_resize_at = variants[name]
            for batch in batches[:2]:
                float(step(*batch)[0])
            walls.setdefault(("step", name), []).append(
                wall(lambda *b: float(step(*b)[0])))
            walls.setdefault(("augment_pair", name), []).append(
                wall(pipe.augment_pair))
    finally:
        tt.choice_crop_resize_at = variants["grouped"]
    for (what, name), runs in walls.items():
        _log(f"model 685 f32 head A, {what} with the tf2 crop {name}: "
             f"median {statistics.median(runs):.3f}, min {min(runs):.3f} "
             f"ms of wall (rounds of {TF2_STEPS}: "
             + ", ".join(f"{ms:.3f}" for ms in runs) + ")")
    return walls


def _write_stl10(root):
    """An STL10 binary tree under root/stl10_binary, ``STL_SPLITS`` images
    of random pixels (96 x 96 x 3, column-major as the format has them),
    labels 1-10 for train and test."""
    import os
    import numpy as np

    rng = np.random.default_rng(0)
    base = os.path.join(root, "stl10_binary")
    os.makedirs(base, exist_ok=True)
    for part, n in STL_SPLITS.items():
        rng.integers(0, 256, n * 3 * 96 * 96, dtype=np.uint8).tofile(
            os.path.join(base, f"{part}_X.bin"))
        if part != "unlabeled":
            rng.integers(1, 11, n, dtype=np.uint8).tofile(
                os.path.join(base, f"{part}_y.bin"))


def phase_stl(root):
    """Model 569 (two-head, sobel, --mix_train) and model 653 (single-head
    IID+, batch 1400 at 64^2, k 140) through the port's CLIs on an STL10
    tree (``_write_stl10``), each in f32 and in bf16, with the peak device
    memory of each run; 569 launches K3 once a step, 653 no time. Returns
    {kernel: launches}."""
    from iic_tpu_torch.cli import cluster_sobel, cluster_sobel_twohead

    total = {"iid_loss_fwd": 0}
    with tempfile.TemporaryDirectory() as out_root:
        for dtype in ("float32", "bfloat16"):
            _, launches, n_steps = _cluster_cli(
                cluster_sobel_twohead.main, STL569_ARGS + [
                    "--dataset_root", root, "--model_dtype", dtype,
                    "--out_root", out_root], f"model 569 {dtype}")
            _k3_per_step(f"model 569 {dtype}", launches, n_steps)
            total["iid_loss_fwd"] += launches["iid_loss_fwd"]
            _, launches, _ = _cluster_cli(
                cluster_sobel.main, STL653_ARGS + [
                    "--dataset_root", root, "--model_dtype", dtype,
                    "--out_root", out_root], f"model 653 {dtype}",
                heads="B")
            if launches["iid_loss_fwd"]:
                raise AssertionError(f"model 653 launched K3: {launches}")
    root_arg = ["--dataset_root", root]
    for dtype in ("float32", "bfloat16"):
        _cluster_profile("model 569", cluster_sobel_twohead,
                         STL569_ARGS + root_arg, "A", dtype)
        _cluster_profile("model 653", cluster_sobel, STL653_ARGS + root_arg,
                         "B", dtype)
    return total


# --profile_dir's traces: the step spans and the kernels' own symbols
K1_SYMBOLS = ("joint_fwd_mma_kernel", "joint_partial_kernel")
K2_SYMBOLS = ("dgrad_v8_kernel", "dgrad_kernel")
K3_SYMBOLS = ("iid_loss_cluster_kernel",)
LAZY_BATCHES = 3  # base batches of each head held lazy against eager


RSS_KEYS = ("VmRSS", "RssAnon", "RssFile", "statm shared")


def _rss_mb():
    """This process's resident host memory, MB, as far as the kernel
    reports it: VmRSS and its anonymous (RssAnon: the heap, decoded
    arrays) and file-backed (RssFile: mapped files, the memory-mapped
    datasets' pages among them) parts, and /proc/self/statm's shared
    resident pages (file-backed and shared memory). A key the kernel does
    not report is left out."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key = line.split(":")[0]
            if key in RSS_KEYS:
                out[key] = int(line.split()[1]) / 1024.0
    try:
        with open("/proc/self/statm") as f:
            shared = int(f.read().split()[2])
        out["statm shared"] = shared * os.sysconf("SC_PAGE_SIZE") / 2**20
    except (OSError, IndexError, ValueError):
        pass
    return out


@contextmanager
def _rss_peak(out):
    """Sample ``_rss_mb`` every 20 ms while the block runs; ``out`` gets
    each key's value at the start and its peak (MB)."""
    import threading

    out["start"] = _rss_mb()
    out["peak"] = dict(out["start"])
    stop = threading.Event()

    def sample():
        while True:
            for k, v in _rss_mb().items():
                out["peak"][k] = max(out["peak"].get(k, v), v)
            if stop.wait(0.02):
                return

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()


def _lazy_batches_equal(argv):
    """The first ``LAZY_BATCHES`` uint8 base batches of both heads'
    pipelines under --lazy_images, on the card, equal to the eager
    pipelines' bit for bit."""
    import gc
    import torch
    from iic_tpu_torch.cli import cluster_sobel_twohead
    from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
    from iic_tpu_torch.data.readers import LazyBinaryArray

    rss0 = _rss_mb()["VmRSS"]
    pipes = {}
    for tag, extra in (("lazy", ["--lazy_images"]), ("eager", [])):
        cfg = cluster_sobel_twohead.config(argv + extra)
        pipes[tag] = cluster_twohead_create_dataloaders(
            cfg, seed=cfg.seed, device="cuda")[:2]
        _log(f"data paths: {tag} pipelines built, VmRSS "
             f"{_rss_mb()['VmRSS'] - rss0:+.1f} MB")
    for head, lazy, eager in zip("AB", pipes["lazy"], pipes["eager"]):
        if not isinstance(lazy.images, LazyBinaryArray):
            raise AssertionError(f"head {head}'s lazy pipeline holds "
                                 f"{type(lazy.images).__name__}")
        for b_i, ((lb, _), (eb, _)) in enumerate(zip(lazy.epoch(1),
                                                     eager.epoch(1))):
            if b_i == LAZY_BATCHES:
                break
            if lb.device.type != "cuda" or not torch.equal(lb, eb):
                raise AssertionError(f"head {head} batch {b_i}: the lazy "
                                     "base batch differs from the eager")
        _log(f"data paths: head {head}'s first {LAZY_BATCHES} base batches "
             f"({tuple(lb.shape)} uint8) lazy == eager on the card")
    del pipes, lazy, eager, lb, eb
    gc.collect()
    _log(f"data paths: pipelines freed, VmRSS "
         f"{_rss_mb()['VmRSS'] - rss0:+.1f} MB")


def _trace_check(tag, path, spans, symbols):
    """The chrome trace at ``path`` parses as JSON and holds each host span
    of ``spans`` ({name: count}) and, for each group of ``symbols``, a CUDA
    kernel named by one of them. Returns its size in MB."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    # the host's spans (the card's mirror of each is "gpu_user_annotation")
    names = [e.get("name", "") for e in events
             if e.get("cat") == "user_annotation"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    for span, n in spans.items():
        if names.count(span) != n:
            raise AssertionError(f"{tag} trace: {names.count(span)} "
                                 f"{span} spans, expected {n}")
    for group in symbols:
        hits = [k for k in kernels if any(s in k for s in group)]
        if not hits:
            raise AssertionError(f"{tag} trace: no kernel named {group}")
        _log(f"{tag} trace: {len(hits)} events of {group}")
    size = os.path.getsize(path) / 2**20
    _log(f"{tag} trace: {path} parses, {len(events)} events, "
         f"{len(kernels)} kernel events, {size:.1f} MB")
    return size


def phase_data_paths(root):
    """The clustering data entry points on the card, over the STL10 tree
    ``_write_stl10`` wrote: model 569 in bf16 with --mix_train
    --lazy_images (the pipelines' first base batches held bit-equal to the
    eager ones on the card before it; K3 once a step), beside the same
    run eager, each with its growth of host VmRSS and its wall a step;
    then one --profile_dir epoch of the segmentation two-head CLI (model
    555's shape) and of the clustering one (model 640's), each trace
    required to parse and to hold its step spans and the kernels' symbols
    (K1's and K2's; K3's). Returns {kernel: launches}."""
    import numpy as np
    from iic_tpu_torch.cli import cluster_sobel_twohead, segmentation_twohead

    t0 = time.perf_counter()
    argv = STL569_ARGS + ["--dataset_root", root, "--model_dtype",
                          "bfloat16"]
    _lazy_batches_equal(argv)
    total = {"seg_joint_fwd": 0, "seg_joint_dgrad": 0, "iid_loss_fwd": 0}
    with tempfile.TemporaryDirectory() as out_root:
        for tag, extra in (("lazy", ["--lazy_images"]), ("eager", [])):
            rss = {}
            with _rss_peak(rss):
                history, launches, n_steps = _cluster_cli(
                    cluster_sobel_twohead.main,
                    argv + extra + ["--out_root", out_root],
                    f"model 569 bfloat16 {tag}")
            steps = [s for h in "AB"
                     for s in history[f"step_seconds_head_{h}"][1:]]
            growth = ", ".join(
                f"{k} {rss['start'][k]:.1f} -> peak {rss['peak'][k]:.1f} "
                f"({rss['peak'][k] - rss['start'][k]:+.1f})"
                if k in rss["start"] else f"{k} not reported"
                for k in RSS_KEYS)
            _log(f"data paths: model 569 bf16 {tag}: host MB {growth}; "
                 f"{1e3 * float(np.mean(steps)):.2f} ms of wall a step "
                 f"(mean of {len(steps)}, each head's first step left out)")
            _k3_per_step(f"model 569 bf16 {tag}", launches, n_steps)
            total["iid_loss_fwd"] += launches["iid_loss_fwd"]
        traces = {}
        for tag, main, args, symbols, spans in (
                ("seg", segmentation_twohead.main, CLI_ARGS,
                 (K1_SYMBOLS, K2_SYMBOLS), {"step_head_A": 2,
                                            "step_head_B": 2}),
                ("cluster", cluster_sobel_twohead.main, CLUSTER_CLI_ARGS,
                 (K3_SYMBOLS,), {"step_head_A": 2, "step_head_B": 4})):
            prof_dir = os.path.join(out_root, f"profile_{tag}")
            run_argv = args + ["--out_root", out_root, "--model_ind", "9",
                               "--profile_dir", prof_dir]
            t1 = time.perf_counter()
            if tag == "seg":
                _, launches = _seg_cli(main, run_argv, "profiled seg")
            else:
                _, launches, n_steps = _cluster_cli(main, run_argv,
                                                    "profiled cluster")
                _k3_per_step("profiled cluster", launches, n_steps)
            _log(f"data paths: profiled {tag} epoch run "
                 f"{time.perf_counter() - t1:.1f} s")
            for k in total:
                total[k] += launches[k]
            traces[tag] = _trace_check(
                f"profiled {tag}", os.path.join(prof_dir,
                                                "trace_epoch_1.json"),
                spans, symbols)
    _log(f"data paths: phase wall {time.perf_counter() - t0:.1f} s; trace "
         f"sizes {', '.join(f'{k} {v:.1f} MB' for k, v in traces.items())}")
    return total


def phase_digits_guard():
    """tests/test_digits_regression.py's guard through the port's greyscale
    two-head CLI: its command on the Digits set, 12 epochs, f32,
    --fused_loss, at seed 0, and at seeds 1-4 if seed 0 misses; a run is in
    the band when its best eval acc reaches DIGITS_BEST and gains
    DIGITS_GAIN over its pre-eval, and one run at least must be. Returns
    {kernel: launches in all the runs}."""
    import numpy as np
    from iic_tpu_torch.cli import cluster_greyscale_twohead

    total = {"iid_loss_fwd": 0}
    passed, missed = [], []
    for seed in DIGITS_SEEDS:
        with tempfile.TemporaryDirectory() as out_root:
            history, launches, n_steps = _cluster_cli(
                cluster_greyscale_twohead.main, DIGITS_ARGS + [
                    "--seed", str(seed), "--out_root", out_root],
                f"digits guard, seed {seed}")
        _k3_per_step(f"digits guard, seed {seed}", launches, n_steps)
        total["iid_loss_fwd"] += launches["iid_loss_fwd"]
        accs = np.array(history["eval"].epoch_acc, float)
        pre, best = float(accs[0]), float(accs.max())
        ok = (len(accs) == 12 and best >= DIGITS_BEST
              and best - pre >= DIGITS_GAIN)
        (passed if ok else missed).append(seed)
        _log(f"digits guard, seed {seed}: eval acc "
             f"{[round(float(a), 4) for a in accs]}; pre {pre:.4f}, best "
             f"{best:.4f} at epoch {int(accs.argmax())} (>= {DIGITS_BEST}), "
             f"gain {best - pre:.4f} (>= {DIGITS_GAIN}): "
             f"{'in the band' if ok else 'outside the band'}")
        if ok:
            break
    _log(f"digits guard: seeds in the band {passed}, outside {missed}")
    if not passed:
        raise AssertionError("no run of the port reached the digits guard's "
                             "band")
    return total


def _no_launches(tag, launches):
    """The semisup path runs none of K1-K3 (nor the tool's kernels)."""
    if any(launches.values()):
        raise AssertionError(f"{tag} launched a kernel: {launches}")


def _semisup_cli(argv, tag):
    """One finetune run in-process, counts set to 0 just before and the
    peak of device memory reset: prints its losses, step seconds, the
    10-crop eval's accuracies and seconds, peak memory and launches; fails
    on a loss or an accuracy that is not finite, or on any kernel launch.
    Returns the history."""
    import numpy as np
    import torch
    from iic_tpu_torch.cli import IID_semisup_STL10

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = IID_semisup_STL10.main(argv)
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    _log(f"{tag}: epoch loss {history['epoch_loss']}, step seconds "
         f"{[round(v, 4) for v in history['step_seconds']]}; 10-crop eval "
         f"acc (pre-train first) {history['epoch_acc']} in "
         f"{[round(v, 3) for v in history['eval_seconds']]} s; "
         f"{seconds:.1f} s; peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
         f"{launches}")
    for name in ("epoch_loss", "epoch_acc"):
        if not history[name] or not np.all(np.isfinite(history[name])):
            raise AssertionError(f"{tag}: {name} not finite: "
                                 f"{history[name]}")
    _no_launches(tag, launches)
    return history


def _semisup_profile(tag, argv):
    """``_profile`` of steady finetune steps of the config the CLI makes of
    ``argv``, on its own loader's batches (the trainer's
    ``make_finetune``), then the 10-crop eval's wall."""
    import torch
    from iic_tpu_torch.cli import IID_semisup_STL10
    from iic_tpu_torch.train.semisup_trainer import make_finetune

    ft = make_finetune(IID_semisup_STL10.config(argv), "cuda")
    batches = [((imgs, labels), gen) for _, (imgs, labels, gen)
               in zip(range(8), ft.loader.epoch(1))]
    out = _profile(tag, lambda batch, gen: (ft.step(batch, gen),), batches,
                   "", K_KERNEL_NAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = ft.evaluate()
    _log(f"{tag}: 10-crop eval of the test split {time.perf_counter() - t0:.3f}"
         f" s (acc {acc:.4f})")
    return out


def phase_semisup(root):
    """Table 3 on the STL10 tree (``_write_stl10``): model 650 through the
    port's cluster_sobel, then model 698's finetune from it through
    IID_semisup_STL10 (the inherited batch of 1400 at 64^2, the head 20 736
    -> 2048 -> 10, the 10-crop eval over all 8 000 test images before
    training and after the epoch), once from an f32 old run and once from a
    bf16 one; then --restart of the f32 finetune (it resumes at epoch 1).
    Every run with counts set to 0 just before must launch no kernel; the
    steps of model 650 and of each finetune are profiled. The accuracies
    are of random pixels and mean nothing. Returns {kernel: launches}
    (none)."""
    from iic_tpu_torch.cli import cluster_sobel

    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as out_root:
            _, launches, _ = _cluster_cli(
                cluster_sobel.main, STL650_ARGS + [
                    "--dataset_root", root, "--model_dtype", dtype,
                    "--out_root", out_root], f"model 650 {dtype}",
                heads="B")
            _no_launches(f"model 650 {dtype}", launches)
            if dtype == "float32":  # the old run of phase_multigpu's step
                import shutil
                shutil.copytree(os.path.join(out_root, "650"), os.path.join(
                    root, "multigpu_old_runs", "650"))
            _cluster_profile("model 650", cluster_sobel,
                             STL650_ARGS + ["--dataset_root", root], "B",
                             dtype)
            argv = SEMISUP698_ARGS + ["--out_root", out_root]
            history = _semisup_cli(argv, f"model 698 from a {dtype} 650")
            if len(history["epoch_acc"]) != 2:
                raise AssertionError(f"model 698: {history['epoch_acc']}")
            _semisup_profile(f"model 698 from a {dtype} 650", argv)
            if dtype == "float32":
                history = _semisup_cli(argv + ["--restart"],
                                       "model 698 --restart")
                if len(history["epoch_acc"]) != 3:
                    raise AssertionError("the restart did not resume at "
                                         f"epoch 1: {history['epoch_acc']}")
    return {"iid_loss_fwd": 0}


def phase_semisup_guard():
    """tests/test_semisup_regression.py's guard through the port: its
    Digits pipeline (the IID+ pretrain by cluster_greyscale, 10 epochs,
    then IID_semisup_STL10, 11 epochs at batch 128), f32, at seed 0 and at
    seeds 1-4 if seed 0 misses. A run is in the band when its last epoch's
    CE is below half its first and below SEMISUP_LAST_CE, its best 10-crop
    accuracy reaches SEMISUP_BEST and gains SEMISUP_GAIN over the pre-train
    eval; one run at least must be. Returns {kernel: launches} (none)."""
    import numpy as np
    from iic_tpu_torch.cli import cluster_greyscale

    passed, missed = [], []
    for seed in SEMISUP_SEEDS:
        tag = f"semisup guard, seed {seed}"
        with tempfile.TemporaryDirectory() as out_root:
            flags = ["--seed", str(seed), "--out_root", out_root]
            history, launches, _ = _cluster_cli(
                cluster_greyscale.main, SEMISUP_GUARD_OLD + flags,
                f"{tag}, pretrain", heads="B")
            _no_launches(f"{tag}, pretrain", launches)
            if len(history["eval"].epoch_acc) != 10:
                raise AssertionError(f"{tag}: pretrain evals "
                                     f"{history['eval'].epoch_acc}")
            history = _semisup_cli(SEMISUP_GUARD_NEW + flags, tag)
        accs = np.array(history["epoch_acc"], float)
        ce = np.array(history["epoch_loss"], float)
        pre, best = float(accs[0]), float(accs.max())
        ok = (len(accs) == 12 and ce[-1] < 0.5 * ce[0]
              and ce[-1] < SEMISUP_LAST_CE and best >= SEMISUP_BEST
              and best - pre >= SEMISUP_GAIN)
        (passed if ok else missed).append(seed)
        _log(f"{tag}: 10-crop acc {[round(float(a), 4) for a in accs]}; "
             f"CE {[round(float(c), 4) for c in ce]}; pre {pre:.4f}, best "
             f"{best:.4f} (>= {SEMISUP_BEST}), gain {best - pre:.4f} (>= "
             f"{SEMISUP_GAIN}), last CE {ce[-1]:.4f} (< {SEMISUP_LAST_CE} "
             f"and < half the first, {0.5 * ce[0]:.4f}): "
             f"{'in the band' if ok else 'outside the band'}")
        if ok:
            break
    _log(f"semisup guard: seeds in the band {passed}, outside {missed}")
    if not passed:
        raise AssertionError("no run of the port reached the semisup "
                             "guard's band")
    return {"iid_loss_fwd": 0}


# The baselines. Triplets at model 640's data shape: its data and
# batch flags, the two-head flags dropped, --save_freq 1 so that the
# --test_code run leaves a latest.pytorch for --restart
TRIPLETS640_ARGS = [
    "--model_ind", "640", "--arch", "TripletsNet5g", "--dataset",
    "Synthetic10x32x3", "--dataset_root", "", "--gt_k", "10", "--lr",
    "0.0001", "--num_epochs", "2000", "--batch_sz", "660",
    "--num_dataloaders", "3", "--crop_orig", "--rand_crop_sz", "20",
    "--input_sz", "32", "--batchnorm_track", "--save_freq", "1",
    "--test_code"]
# ... greyscale at model 685's MNIST flags (--dataset_root added where it
# runs)
TRIPLETS685_ARGS = [
    "--model_ind", "685", "--arch", "TripletsNet6c", "--dataset", "MNIST",
    "--num_epochs", "3200", *MNIST_TF_ARGS, "--test_code"]
# Doersch and Isola at model 555's data shape (CLI_ARGS' data flags), at
# the default patch side 11. --num_epochs 3: a --test_code run's epoch 1
# is not its last, so it writes no latest.pytorch (3 GB with Adam's
# moments) unless --save_freq 1 asks for one
SEG_BASELINE_ARGS = [
    "--mode", "IID", "--dataset", "SyntheticSeg3x146x480",
    "--dataset_root", "", "--batch_sz", "120", "--num_dataloaders", "1",
    "--gt_k", "3", "--input_sz", "128", "--include_rgb",
    "--batchnorm_track", "--num_epochs", "3", "--test_code"]
# The device k-means against its float64 replay: (samples, features, k),
# the Doersch eval's sample at gt_k 3 and at 15, and a triplets eval's
KMEANS_SHAPES = ((50_000, 512, 3), (50_000, 512, 15), (10_000, 512, 10))
KMEANS_TIE_REL, KMEANS_CENTRE_REL = 1e-6, 1e-4


def _baseline_run(main, argv, tag, min_evals=2):
    """One baseline CLI run in-process, counts set to 0 just before and the
    peak of device memory reset: prints its losses, step seconds, eval
    accuracies, seconds, peak memory and launches; fails on a loss or
    accuracy that is not finite, an eval history of fewer than
    ``min_evals`` entries, or any kernel launch. Returns the history."""
    import numpy as np
    import torch

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = main(argv)
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    loss, acc = history["epoch_loss"], history["epoch_acc"]
    _log(f"{tag}: epoch loss {loss}, step seconds "
         f"{[round(v, 4) for v in history['step_seconds']]}; eval acc "
         f"(pre-train first) {acc}; {seconds:.1f} s; peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
         f"{launches}")
    for name, vals in (("loss", loss), ("eval acc", acc)):
        if not vals or not np.all(np.isfinite(vals)):
            raise AssertionError(f"{tag}: {name} not finite: {vals}")
    if len(acc) < min_evals:
        raise AssertionError(f"{tag}: eval history {acc}")
    _no_launches(tag, launches)
    return history


def _baseline_profile(tag, step, batches, focus):
    """``_profile`` of steady baseline steps, with the step's peak device
    memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    out = _profile(tag, step, batches, "", focus)
    _log(f"profile {tag}: peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def _triplets_profile(tag, cli, argv, dtype):
    """Steady triplets steps of the config the CLI makes of ``argv`` in
    ``dtype``, on its own pipeline's batches and negatives."""
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.data.pipeline import ClusterTrainPipeline
    from iic_tpu_torch.parallel.train_step import make_optimizer
    from iic_tpu_torch.train import triplets_trainer as tt

    cfg = cli.config(argv + ["--model_dtype", dtype])
    torch.manual_seed(0)
    pipe = ClusterTrainPipeline(cfg, [True, False], device="cuda")
    net = models.build(cfg.arch, cfg).cuda()
    step = tt.make_triplets_train_step(
        net, make_optimizer(net, cfg), sobel=cfg.sobel,
        include_rgb=cfg.include_rgb, augment_pair=pipe.augment_pair,
        augment_tf1=pipe.augment_tf1)
    batches = [b for _, b in zip(range(8), tt._with_negatives(
        pipe, 1, tt.negative_order(0, 1, len(pipe.images))))]
    return _baseline_profile(f"{tag} {dtype}",
                             lambda batch, gen: (step(batch, gen),), batches,
                             ("softmax", "xlogy"))


def _seg_baseline_profile(tag, cli, kind, argv):
    """Steady Doersch or Isola steps (f32, colour dropping as the CLI sets
    it, one pair a batch from the reference geometry) on the CLI config's
    own pipeline."""
    import numpy as np
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.data.seg_pipeline import (
        segmentation_create_dataloaders)
    from iic_tpu_torch.parallel.train_step import make_optimizer
    from iic_tpu_torch.train import seg_baseline_trainers as sb

    cfg = cli.config(argv)
    pipe = segmentation_create_dataloaders(cfg, device="cuda")[0]
    torch.manual_seed(0)
    net = models.build(cfg.arch, cfg).cuda()
    side = cfg.doersch_patch_side if kind == "doersch" else \
        cfg.isola_patch_side
    noise = None
    if cfg.use_doersch_datasets and cfg.include_rgb:
        noise = tuple(torch.from_numpy(v).cuda() for v in
                      sb.compute_doersch_rgb_stats(cfg, pipe))
    step = sb.make_seg_baseline_train_step(
        net, make_optimizer(net, cfg), kind, cfg.input_sz, side,
        sobel=cfg.sobel, include_rgb=cfg.include_rgb,
        using_IR=cfg.using_IR, augment=pipe.augment, noise_stats=noise)
    set_fn = sb.doersch_set_patches if kind == "doersch" else \
        sb.isola_set_patches
    batches = [((imgs, masks), gen, set_fn(np.random.default_rng(b_i),
                                           cfg.input_sz, side))
               for b_i, (imgs, masks, gen) in zip(range(4), pipe.epoch(1))]
    return _baseline_profile(f"{tag} float32", lambda *b: (step(*b),),
                             batches, ("upsample_bilinear2d",))


def phase_kmeans():
    """The port's k-means on the card at ``KMEANS_SHAPES``, on overlapping
    relu'd Gaussian clusters: its time, and its Lloyd iterations held one
    by one to the same iterations in float64 on the CPU
    (``replay_float64``: labels equal but within KMEANS_TIE_REL of a tie,
    M-step centroids within KMEANS_CENTRE_REL of max), with the replay's
    time; on separated clusters, accuracy 1.0 after the Hungarian
    match."""
    import numpy as np
    import torch
    from iic_tpu_torch.evals.kmeans_eval import (
        KMeans, kmeans_cluster_assess, replay_float64)

    for n, d, k in KMEANS_SHAPES:
        rng = np.random.default_rng(k)
        centres = rng.standard_normal((k, d)).astype(np.float32)
        truth = rng.integers(0, k, n)
        noise = rng.standard_normal((n, d)).astype(np.float32)
        x = torch.from_numpy(np.maximum(0.15 * centres[truth] + noise,
                                        0)).cuda()
        KMeans(k, n_init=1, max_iter=2).fit(x)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km = KMeans(k, seed=0).fit(x)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = replay_float64(x, km, tie_rel=KMEANS_TIE_REL)
        cpu_s = time.perf_counter() - t0
        blobs = torch.from_numpy(3.0 * centres[truth] + noise).cuda()
        acc = kmeans_cluster_assess(blobs, truth, k)
        _log(f"k-means {n} x {d}, k {k}: card {gpu_s:.3f} s (n_init 10, "
             f"best run {km.n_iter_} iterations, inertia {km.inertia_:.6g}); "
             f"float64 replay of the best run on the CPU {cpu_s:.3f} s: "
             f"{rep['mismatches']} labels off outside ties ({rep['ties']} "
             f"within {KMEANS_TIE_REL:g} of one, over {rep['iterations']} "
             f"iterations and the final E-step), centroids "
             f"{rep['centre_err']:.3e} of max off; separated clusters acc "
             f"{acc}")
        if rep["mismatches"] or rep["centre_err"] > KMEANS_CENTRE_REL:
            raise AssertionError(f"k-means {n} x {d} x {k} off its float64 "
                                 f"replay: {rep['mismatches']} labels, "
                                 f"centroids {rep['centre_err']:.3e}")
        if acc != 1.0:
            raise AssertionError(f"k-means {n} x {d} x {k}: separated "
                                 f"clusters at acc {acc}")


# the k-means + SIFT baseline's archetype: model 555's shape, one batch of
# 120 images at 128^2 (the CLI has no --max_num_train default)
KMEANS_SIFT_DATASET = "SyntheticSeg3x146x120"
KMEANS_SIFT_MAX_TRAIN = 1_000_000


def phase_kmeans_sift():
    """The k-means + SIFT baseline's CLI (``cli/kmeans_and_sift.py``) in
    colour mode on cuda:0, without --test_code: an IID archetype at model
    555's shape (``KMEANS_SIFT_DATASET``, gt_k 3, colour) written by
    ``save_meta``, every masked pixel of its train batch sampled on the
    card, ``KMEANS_SIFT_MAX_TRAIN`` of them fitted, every mapping pixel
    predicted. The samples and the centroids must lie on the card; the fit
    is held to ``replay_float64`` as ``phase_kmeans`` holds its fits, and
    the mapping loader's uint8 round trip (raw colour / 255, times 255,
    truncated) to all 256 levels on the card. Prints the sample counts, the
    seconds of sampling, fitting and prediction, the peak device memory and
    the accuracy (which means nothing on synthetic data). --do_sift is not
    run: SIFT needs OpenCV, which this machine lacks."""
    import numpy as np
    import torch
    from iic_tpu_torch.cli import kmeans_and_sift as ks
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.data.seg_pipeline import SegMappingLoader
    from iic_tpu_torch.evals import kmeans_eval
    from iic_tpu_torch.evals.kmeans_eval import replay_float64
    from iic_tpu_torch.train import checkpoint as ckpt

    real_kmeans = kmeans_eval.KMeans
    real_sample = ks.get_vectorised_colour_samples
    fits, seconds, counts = [], {}, []

    class Timed(real_kmeans):
        def fit(self, x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().fit(x)
            torch.cuda.synchronize()
            seconds["fit"] = time.perf_counter() - t0
            fits.append((x, self))
            return self

        def predict(self, x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().predict(x)
            torch.cuda.synchronize()
            seconds["predict"] = time.perf_counter() - t0
            return out

    def timed_sample(*a, **kw):
        t0 = time.perf_counter()
        out = real_sample(*a, **kw)
        torch.cuda.synchronize()
        seconds.setdefault("sampling", []).append(time.perf_counter() - t0)
        counts.append(len(out[0] if isinstance(out, tuple) else out))
        return out

    argv = [a for a in CLI_ARGS if a != "--test_code"]
    argv[argv.index("--dataset") + 1] = KMEANS_SIFT_DATASET
    with tempfile.TemporaryDirectory() as out_root:
        cfg = parse_seg_args(argv + ["--model_ind", "555", "--out_root",
                                     out_root]).finalize(twohead=True)
        os.makedirs(os.path.join(out_root, "555"))
        ckpt.save_meta(cfg, {}, 0)
        kmeans_eval.KMeans, ks.get_vectorised_colour_samples = \
            Timed, timed_sample
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            acc = ks.main(["--model_ind", "900", "--IID_model_ind", "555",
                           "--max_num_train", str(KMEANS_SIFT_MAX_TRAIN),
                           "--out_root", out_root], device="cuda:0")
            wall = time.perf_counter() - t0
        finally:
            kmeans_eval.KMeans, ks.get_vectorised_colour_samples = \
                real_kmeans, real_sample
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
    (x, km), = fits
    if x.device.type != "cuda" or km.cluster_centers_.device.type != "cuda":
        raise AssertionError(f"k-means + SIFT: samples on {x.device}, "
                             f"centroids on {km.cluster_centers_.device}")
    t0 = time.perf_counter()
    rep = replay_float64(x, km, tie_rel=KMEANS_TIE_REL)
    replay_s = time.perf_counter() - t0
    levels = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    imgs = torch.stack([levels, levels.T, levels.flip(0)], -1)[None].cuda()
    loader = SegMappingLoader(ks.raw_colour_config(cfg), ["train"],
                              device="cuda:0")
    (back, _, _), = ks._iter_mapping([(
        loader.transform(imgs), np.zeros((1, 16, 16), np.int32),
        np.ones((1, 16, 16), bool))])
    levels_back = int(torch.unique(back).numel())
    _log(f"k-means + SIFT (colour, {KMEANS_SIFT_DATASET} at 128^2, "
         f"--max_num_train {KMEANS_SIFT_MAX_TRAIN}): {counts[0]} train "
         f"samples, {x.shape[0]} fitted ({x.dtype} on {x.device}), "
         f"{counts[1]} mapping samples predicted; sampling "
         f"{seconds['sampling'][0]:.3f} s train / "
         f"{seconds['sampling'][1]:.3f} s mapping, fit {seconds['fit']:.3f} "
         f"s (n_init 10, best run {km.n_iter_} iterations, inertia "
         f"{km.inertia_:.6g}), predict {seconds['predict']:.3f} s, CLI "
         f"{wall:.2f} s; peak device memory {peak:.1f} MiB; accuracy "
         f"{acc:.6f} (synthetic data); float64 replay {replay_s:.3f} s: "
         f"{rep['mismatches']} labels off outside ties ({rep['ties']} "
         f"within {KMEANS_TIE_REL:g} of one), centroids "
         f"{rep['centre_err']:.3e} of max off; uint8 round trip "
         f"{levels_back} of 256 levels")
    if rep["mismatches"] or rep["centre_err"] > KMEANS_CENTRE_REL:
        raise AssertionError(f"k-means + SIFT fit off its float64 replay: "
                             f"{rep['mismatches']} labels, centroids "
                             f"{rep['centre_err']:.3e}")
    if not torch.equal(back, imgs):
        raise AssertionError(f"k-means + SIFT: the uint8 round trip gave "
                             f"{levels_back} of 256 levels back")


def phase_baselines(root):
    """The paper's trainable baselines through the port's CLIs, each run with
    counts set to 0 just before and required to launch no kernel (their
    losses are a KL divergence and cross-entropies): triplets sobel at
    model 640's data shape (TripletsNet5g) in f32, in bf16, with
    --kmeans_on_features and with --restart (which must resume at epoch 2);
    triplets greyscale at model 685's MNIST flags on the MNIST tree under
    ``root`` (TripletsNet6c, f32); Doersch (its colour dropping on) and
    Isola at model 555's data shape, patch side 11, f32, each also with
    --per_sample_patches, and Doersch's --restart without --test_code for
    epochs 2 and 3 under --save_multiple (it must leave e_3.pytorch); then
    a profile of steady steps of each (triplets in f32 and bf16), the
    device k-means (``phase_kmeans``) and the k-means + SIFT baseline's CLI
    (``phase_kmeans_sift``). Returns {kernel: launches} (none)."""
    import os
    from iic_tpu_torch.cli import (
        doersch, isola, triplets_greyscale, triplets_sobel)

    phases = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_root:
        out = ["--out_root", out_root]
        for dtype, ind in (("float32", "640"), ("bfloat16", "642")):
            _baseline_run(triplets_sobel.main, TRIPLETS640_ARGS + out + [
                "--model_dtype", dtype, "--model_ind", ind],
                f"triplets sobel {dtype}")
        history = _baseline_run(
            triplets_sobel.main, TRIPLETS640_ARGS + out + ["--restart"],
            "triplets sobel --restart", min_evals=3)
        _log(f"triplets masses after the restart: {history['masses'][-1]}")
        _baseline_run(triplets_sobel.main, TRIPLETS640_ARGS + out + [
            "--kmeans_on_features", "--model_ind", "641"],
            "triplets sobel --kmeans_on_features")
        _baseline_run(triplets_greyscale.main, TRIPLETS685_ARGS + out + [
            "--dataset_root", root], "triplets greyscale float32")
        phases["triplets"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, cli in (("doersch", doersch), ("isola", isola)):
            # Doersch's first run leaves a latest.pytorch to --restart from
            first = ["--save_freq", "1"] if name == "doersch" else []
            for extra, ind in ((first, "555"),
                               (["--per_sample_patches"], "556")):
                _baseline_run(cli.main, SEG_BASELINE_ARGS + out + extra + [
                    "--model_ind", ind], f"{name} {' '.join(extra)}")
            if name == "doersch":
                rest = [a for a in SEG_BASELINE_ARGS if a != "--test_code"]
                rest[rest.index("--num_epochs") + 1] = "4"  # epochs 2, 3
                history = _baseline_run(
                    cli.main, rest + out + ["--model_ind", "555",
                                            "--restart", "--save_multiple"],
                    "doersch --restart --save_multiple", min_evals=4)
                snap = os.path.join(out_root, "555", "e_3.pytorch")
                if not os.path.exists(snap) or len(
                        history["epoch_loss"]) != 3:
                    raise AssertionError(f"doersch --restart: {history}, "
                                         f"e_3 saved {os.path.exists(snap)}")
        phases["doersch and isola"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        _triplets_profile("triplets model 640", triplets_sobel,
                          TRIPLETS640_ARGS, dtype)
    _triplets_profile("triplets model 685", triplets_greyscale,
                      TRIPLETS685_ARGS + ["--dataset_root", root], "float32")
    _seg_baseline_profile("doersch", doersch, "doersch", SEG_BASELINE_ARGS)
    _seg_baseline_profile("isola", isola, "isola", SEG_BASELINE_ARGS)
    phases["profiles"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_kmeans()
    phases["k-means"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_kmeans_sift()
    phases["k-means + SIFT"] = time.perf_counter() - t0
    _log("baseline phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()))
    return {"iid_loss_fwd": 0}


# The serving and analysis path (infer.py and its
# torch.export artifact, cli/export_model, compat/torch_import and
# cli/import_torch, cli/analysis/*): runs at the published widths, trained
# for one --test_code epoch each, then served. No kernel lies under it.
SERVE_TIE = 1e-4  # eager top-2 gap below which an id may flip
SERVE_CHILD_BATCHES = (1, 37)  # and each run's own batch
SERVE_TIME_BATCHES = (1, 64)  # and each run's own batch
SERVE_REPS = 20
SERVE_DTYPES = ("float32", "bfloat16")
# The reference's config.pickle for model 640 (an argparse.Namespace):
# CLUSTER_CLI_ARGS's flags as the reference's parser names them, without
# the port's --fused_loss and --test_code
SERVE_REF640 = dict(
    model_ind=640, arch="ClusterNet5gTwoHead", mode="IID",
    dataset="Synthetic10x32x3", dataset_root="", gt_k=10, output_k_A=70,
    output_k_B=10, lamb=1.0, lr=0.0001, num_epochs=2000, batch_sz=660,
    num_dataloaders=3, num_sub_heads=5, crop_orig=True, rand_crop_sz=20,
    input_sz=32, head_A_first=True, head_B_epochs=2, double_eval=True,
    batchnorm_track=True, opt="Adam", out_root="out")
SERVE_CHILD = r"""
import sys
import torch
assert "iic_tpu_torch" not in sys.modules
print("TF32 as PyTorch's defaults leave it: cudnn",
      torch.backends.cudnn.allow_tf32, "matmul",
      torch.backends.cuda.matmul.allow_tf32)
jobs = torch.load(sys.argv[1])
outs = {}
with torch.no_grad():
    for tag, path, inputs in jobs:
        program = torch.export.load(path).module()
        outs[tag] = [program(x.cuda()).cpu() for x in inputs]
assert "iic_tpu_torch" not in sys.modules, "the port was imported"
torch.save(outs, sys.argv[2])
print("served without the port:", sorted(outs))
"""


@contextmanager
def _tf32(on):
    """cuDNN convolutions in TF32 (``on``) or full f32 inside the block.
    The serving checks and rates run at PyTorch's defaults (cuDNN TF32 on,
    cuBLAS TF32 off), as a user's process and the torch-only child do;
    TF32 off serves only to count the ids that TF32 itself moves."""
    import torch
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _serve_images(loader, config, n):
    """n raw uint8 images (repeated where the set is smaller): a clustering
    mapping set's originals, or a segmentation mapping set's prepared
    images (geometry at input_sz, rgb then IR)."""
    import numpy as np
    if hasattr(loader, "images"):
        imgs = loader.images
    else:
        imgs = np.stack([loader._get(i)[0]
                         for i in range(min(n, loader.total))])
    return np.ascontiguousarray(imgs[np.arange(n) % len(imgs)])


def _serve_eager(config, net, stats, loader, imgs_u8):
    """The eval path's ids for uint8 images on the device: the loader's
    own transform, the eval forward of the best sub-head, argmax, the
    match (``reorder_preds``). Returns (ids, top-2 gap) as numpy."""
    import torch
    from iic_tpu_torch.cli.analysis.eval import eval_apply
    from iic_tpu_torch.evals.metrics import reorder_preds

    if hasattr(loader, "tf3"):
        x = loader.tf3(imgs_u8.float() / 255.0).permute(0, 3, 1, 2)
        x = x.contiguous()
    else:
        x = loader.transform(imgs_u8)
    probs = eval_apply(config, net)(x)[stats["best_train_sub_head"]]
    top2 = probs.topk(2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    preds = probs.argmax(dim=1).cpu().numpy()
    ids = reorder_preds(preds.reshape(-1), stats["best_train_sub_head_match"])
    return ids.reshape(preds.shape), gap


def _serve_compare(tag, got, want, gap):
    """Ids equal to the eager ids but where the eager top-2 gap is under
    SERVE_TIE; prints the near-tie rows and the flips. Returns flips."""
    import numpy as np
    got = np.asarray(got)
    tie = gap < SERVE_TIE
    diff = got != want
    _log(f"  {tag}: {diff.size} ids, {int(tie.sum())} near ties (eager "
         f"top-2 gap < {SERVE_TIE:g}), {int(diff.sum())} differ, "
         f"{int((diff & tie).sum())} of them at a near tie")
    if (diff & ~tie).any():
        raise AssertionError(f"{tag}: {int((diff & ~tie).sum())} ids differ "
                             "away from a near tie")
    return int(diff.sum())


def _serve_net(config, net, dtype):
    """``net`` as the run's config builds it in ``dtype`` (the weights are
    f32 in either)."""
    import copy
    from iic_tpu_torch import models
    if dtype == config.model_dtype:
        return config, net
    config = copy.copy(config)
    config.model_dtype = dtype
    other = models.build(config.arch, config).to(next(net.parameters()).device)
    other.load_state_dict(net.state_dict())
    return config, other.eval()


def _serve_rate(tag, fn, imgs):
    """CUDA-event ms a call (mean of SERVE_REPS after a warm call), the
    images/s it gives and the peak device memory of the calls."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = _time_ms(lambda: fn(imgs), reps=SERVE_REPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rate = len(imgs) * 1000.0 / ms
    _log(f"  {tag} batch {len(imgs)}: {ms:.4f} ms, {rate:.1f} images/s, "
         f"peak {peak:.3f} GiB")
    return ms, rate, peak


def _serve_run(tag, out_root, model_ind, run_batch, work, loaders):
    """One trained run: load_run on cuda, the predictor against the eager
    eval path, then (in each dtype) the export with a symbolic batch and
    the eager and exported rates. Adds the child's jobs to ``work`` and
    returns {dtype: eager ids at the child's batches}."""
    import os
    import numpy as np
    import torch
    from iic_tpu_torch import infer

    config, net, stats = infer.load_run(out_root, model_ind)
    map_a = loaders(config)
    batches = SERVE_CHILD_BATCHES + (run_batch,)
    raw = _serve_images(map_a, config, max(batches + SERVE_TIME_BATCHES))
    imgs = torch.from_numpy(raw).cuda()
    _log(f"{tag}: {config.arch}, {config.model_dtype}, sub-head "
         f"{stats['best_train_sub_head']}, input {tuple(raw.shape[1:])} "
         f"uint8, run batch {run_batch}")
    expected = {}
    for dtype in SERVE_DTYPES:
        cfg, dnet = _serve_net(config, net, dtype)
        predict = infer.make_predictor(cfg, dnet, stats)
        want, gap = _serve_eager(cfg, dnet, stats, map_a, imgs[:run_batch])
        with torch.no_grad():
            got = predict(imgs[:run_batch]).cpu().numpy()
        _serve_compare(f"{tag} {dtype} predictor vs eager eval", got, want,
                       gap)
        expected[dtype] = [_serve_eager(cfg, dnet, stats, map_a, imgs[:b])
                           for b in batches]
        with _tf32(False):
            full, _ = _serve_eager(cfg, dnet, stats, map_a,
                                   imgs[:run_batch])
        moved = full != want
        _log(f"  {tag} {dtype}: cuDNN TF32's own effect on the eager ids: "
             f"{int(moved.sum())} of {moved.size} differ from TF32 off, "
             f"{int((moved & (gap < SERVE_TIE)).sum())} of them at a near "
             "tie (reported, not held)")
        path = os.path.join(out_root, f"{model_ind}_{dtype}.pt2")
        t0 = time.perf_counter()
        data = infer.export_predictor(predict, raw[:2], path=path)
        _log(f"  {tag} {dtype}: exported in "
             f"{time.perf_counter() - t0:.1f} s, {len(data) / 2**20:.1f} "
             f"MiB")
        served = infer.load_exported(path)
        work.append((f"{tag} {dtype}", path,
                     [torch.from_numpy(raw[:b]) for b in batches]))
        for b in SERVE_TIME_BATCHES + (run_batch,):
            for kind, fn in (("eager", predict), ("exported", served)):
                _serve_rate(f"{tag} {dtype} {kind}", fn, imgs[:b])
        del served, predict, dnet
        torch.cuda.empty_cache()
    return expected


def _serve_child(work, expected, tmp):
    """The artifacts in a child process that imports torch alone, at
    batches 1, 37 and each run's; its ids against the eager ids."""
    import os
    import torch

    jobs, outs = os.path.join(tmp, "jobs.pt"), os.path.join(tmp, "outs.pt")
    torch.save(work, jobs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", SERVE_CHILD, jobs, outs],
                         cwd=tmp, env=env, capture_output=True, text=True,
                         timeout=600)
    _log(f"child (torch alone): rc {res.returncode}, "
         f"{time.perf_counter() - t0:.1f} s; {res.stdout.strip()}")
    if res.returncode != 0:
        raise AssertionError(f"the child failed: {res.stderr[-3000:]}")
    served = torch.load(outs)
    flips = 0
    for tag, _, inputs in work:
        for x, got, (want, gap) in zip(inputs, served[tag], expected[tag]):
            flips += _serve_compare(f"{tag} exported, batch {len(x)}", got,
                                    want, gap)
    return flips


def _serve_import(root, device):
    """A reference-layout run directory at model 640's arch (a bare state
    dict under ``module.`` in best_net.pytorch and latest_net.pytorch, as
    the reference's cluster scripts save them, and config.pickle an
    argparse.Namespace), through ``python -m iic_tpu_torch.cli.import_torch``;
    the imported weights' forward against the source net's; then
    --restart of the imported run (from its latest) for one --test_code
    epoch."""
    import argparse
    import os
    import pickle
    import numpy as np
    import torch
    from iic_tpu_torch import infer, models
    from iic_tpu_torch.cli import cluster_sobel_twohead
    from iic_tpu_torch.train.config import ClusterConfig

    cfg = ClusterConfig(**{k: v for k, v in SERVE_REF640.items()
                           if k != "out_root"}).finalize(twohead=True)
    torch.manual_seed(640)
    src = models.build(cfg.arch, cfg).to(device)
    src.train()
    with torch.no_grad():  # running statistics away from (0, 1)
        for _ in range(3):
            src(torch.randn(64, cfg.in_channels, 32, 32, device=device))
    src.eval()
    ref_dir = os.path.join(root, "ref", "640")
    os.makedirs(ref_dir)
    ref_sd = {"module." + k: v.cpu() for k, v in src.state_dict().items()}
    for name in ("best_net.pytorch", "latest_net.pytorch"):
        torch.save(ref_sd, os.path.join(ref_dir, name))
    with open(os.path.join(ref_dir, "config.pickle"), "wb") as f:
        pickle.dump(argparse.Namespace(**SERVE_REF640), f, protocol=2)
    imp = os.path.join(root, "imported")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "iic_tpu_torch.cli.import_torch",
         "--ref_dir", ref_dir, "--out_root", imp, "--model_ind", "640"],
        capture_output=True, text=True, timeout=600)
    _log(f"import_torch: rc {res.returncode}, "
         f"{time.perf_counter() - t0:.1f} s: {res.stdout.strip()}")
    if res.returncode != 0:
        raise AssertionError(f"import_torch failed: {res.stderr[-3000:]}")
    net = models.build(cfg.arch, cfg).to(device)
    net.load_state_dict(torch.load(os.path.join(imp, "640", "best.pytorch"),
                                   map_location=device,
                                   weights_only=True)["net"])
    net.eval()
    x = torch.randn(660, cfg.in_channels, 32, 32, device=device)
    with torch.no_grad():
        err = max(float((net(x, head=h) - src(x, head=h)).abs().max())
                  for h in "AB")
    stats = {"best_train_sub_head": 3,
             "best_train_sub_head_match": [(i, (i + 3) % 10)
                                           for i in range(10)]}
    u8 = torch.randint(0, 256, (660, 32, 32, 3), dtype=torch.uint8,
                       device=device)
    with torch.no_grad():
        ids = infer.make_predictor(cfg, net, stats)(u8)
        want = infer.make_predictor(cfg, src, stats)(u8)
    _log(f"imported run: forward max |d| against the source net {err:.3e} "
         f"(heads A, B; 660 images); predictor ids equal to the source "
         f"net's: {bool(torch.equal(ids, want))}")
    if err != 0.0 or not torch.equal(ids, want):
        raise AssertionError("the imported run's forward is not the source "
                             "net's")
    argv = [a for a in CLUSTER_CLI_ARGS if a != "--fused_loss"] + [
        "--restart", "--out_root", imp, "--num_epochs", "2"]
    _, history = cluster_sobel_twohead.main(argv)
    losses = [history[f"epoch_loss_head_{h}"] for h in "AB"]
    _log(f"imported run --restart: epoch losses A, B {losses}, eval acc "
         f"{history['eval'].epoch_acc}")
    if not all(v and np.all(np.isfinite(v)) for v in losses) or len(
            history["eval"].epoch_acc) != 1:
        raise AssertionError(f"the imported run's --restart: {history}")


def _stored_acc(out_root, model_ind):
    """The stored accuracy of the weights an analysis CLI reloads (best,
    else latest)."""
    import os
    import numpy as np
    from iic_tpu_torch.train import checkpoint as ckpt
    meta = ckpt.read_meta(out_root, model_ind)
    ev = meta["history"]["eval"]
    if os.path.exists(os.path.join(out_root, str(model_ind),
                                   "best.pytorch")):
        return ev.epoch_acc[int(np.argmax(ev.epoch_acc))]
    return ev.epoch_acc[meta["last_epoch"]]


def _serve_analysis(root, pngs):
    """The analysis CLIs on the trained runs: eval (model 640) and
    render_general --reassess_acc (model 555) against the stored accuracy
    within 1 / images, print_sub_heads_eval and the fewer-labels tool at pc
    0.1 to their ends; print_examples, render_general's renders and
    colour_scheme_change where PIL is found (``pngs``)."""
    import os
    from iic_tpu_torch.cli.analysis import (
        colour_scheme_change, eval as analysis_eval,
        overcluster_fewer_labels_example, print_examples,
        print_sub_heads_eval, render_general)
    from iic_tpu_torch.data.pipeline import MappingLoader, _twohead_partitions
    from iic_tpu_torch.data.seg_pipeline import seg_partitions
    from iic_tpu_torch.train import checkpoint as ckpt
    from iic_tpu_torch.train.config import config_from_dict

    r640, r555 = os.path.join(root, "640"), os.path.join(root, "555")
    checks = []
    t0 = time.perf_counter()
    stats = analysis_eval.main(["--model_ind", "640", "--out_root", r640])
    cfg = config_from_dict(ckpt.read_meta(r640, 640)["config"])
    n = len(MappingLoader(cfg, _twohead_partitions(cfg)[2]).images)
    checks.append(("eval, model 640", stats["best"], _stored_acc(r640, 640),
                   n, time.perf_counter() - t0))
    t0 = time.perf_counter()
    res = render_general.main(["--model_ind", "555", "--out_root", r555,
                               "--reassess_acc"])
    cfg = config_from_dict(ckpt.read_meta(r555, 555)["config"])
    from iic_tpu_torch.data.seg_pipeline import SegMappingLoader
    n = SegMappingLoader(cfg, seg_partitions(cfg)[1]).total
    checks.append(("render_general --reassess_acc, model 555",
                   res[555]["best"], _stored_acc(r555, 555), n,
                   time.perf_counter() - t0))
    for tag, got, want, n, seconds in checks:
        _log(f"{tag}: {got:.6f} against the stored {want:.6f} (|d| "
             f"{abs(got - want):.3e}, bound 1 / {n} images = {1 / n:.3e}); "
             f"{seconds:.1f} s")
        if abs(got - want) > 1.0 / n:
            raise AssertionError(f"{tag} does not reproduce the stored "
                                 "accuracy")
    t0 = time.perf_counter()
    print_sub_heads_eval.main(["--model_inds", "640", "--out_root", r640])
    _log(f"print_sub_heads_eval: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = overcluster_fewer_labels_example.main([
        "--model_ind", "640", "--out_root", r640, "--pcs", "0.1"])
    _log(f"overcluster_fewer_labels_example at pc 0.1: {res}; "
         f"{time.perf_counter() - t0:.1f} s")
    steps = ("print_examples", "render_general renders",
             "colour_scheme_change")
    if not pngs:
        _log("PNG steps not run here (no PIL): " + ", ".join(steps)
             + "; proved on the CPU only (tests/test_torch_analysis.py)")
        return
    print_examples.main(["--model_ind", "640", "--out_root", r640])
    render_general.main(["--model_ind", "555", "--out_root", r555,
                         "--num", "4", "--imgs_dataloaders", "test"])
    renders = os.path.join(r555, "555", "renders", "test", "best")
    colour_scheme_change.main(["--in_dir", renders, "--file_pattern",
                               "preds_%d.png", "--file_indices", "0", "1",
                               "--num_classes", "3"])
    _log("PNG steps run on the card: " + ", ".join(steps))


def phase_serve():
    """The serving and analysis path at full width: models 640 (f32), 555
    (f32) and 545 (bf16, on a Potsdam fixture tree it writes) trained for
    one --test_code epoch (set-up: launches printed, not counted), then,
    counts set to 0, at PyTorch's TF32 defaults: each run's predictor in
    f32 and in bf16 against the eager eval path, its export with a
    symbolic batch (in f32 and bf16)
    served by a child that imports torch alone at batches 1, 37 and the
    run's own, the eager and exported rates at 1, 64 and the run's batch;
    a reference-layout checkpoint imported and restarted; the analysis
    CLIs. The serving part must launch no kernel. Returns {kernel:
    launches} (none)."""
    import importlib.util
    import os
    from iic_tpu_torch.cli import cluster_sobel_twohead, segmentation_twohead
    from iic_tpu_torch.data.pipeline import MappingLoader, _twohead_partitions
    from iic_tpu_torch.data.seg_pipeline import (
        SegMappingLoader, seg_partitions)

    import torch
    pngs = importlib.util.find_spec("PIL") is not None
    # PyTorch's defaults, as a user's process and the child have them
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    phases = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        potsdam = os.path.join(root, "potsdam")
        _write_potsdam(potsdam)
        c640 = [a for a in CLUSTER_CLI_ARGS if a != "--fused_loss"] + [
            "--num_epochs", "2"]
        setups = (
            ("640", cluster_sobel_twohead.main, c640),
            ("555", segmentation_twohead.main, CLI_ARGS + [
                "--model_ind", "555"]),
            ("545", segmentation_twohead.main, POTSDAM3_ARGS + [
                "--dataset_root", potsdam, "--test_code", "--num_epochs",
                "2", "--model_dtype", "bfloat16"]))
        for tag, main, argv in setups:
            _reset_counts()
            _, history = main(argv + ["--out_root", os.path.join(root, tag)])
            _log(f"set-up run {tag}: eval acc {history['eval'].epoch_acc}; "
                 f"launches (set-up, not the table's) {_read_counts()}")
        phases["set-up"] = time.perf_counter() - t0

        _reset_counts()
        t0 = time.perf_counter()
        work, expected = [], {}

        def cluster_map(cfg):
            return MappingLoader(cfg, _twohead_partitions(cfg)[2],
                                 device="cuda")

        def seg_map(cfg):
            return SegMappingLoader(cfg, seg_partitions(cfg)[1],
                                    device="cuda")

        for tag, model_ind, batch, loaders in (
                ("640", 640, 660, cluster_map),
                ("555", 555, 120, seg_map), ("545", 545, 75, seg_map)):
            for dtype, ids in _serve_run(
                    f"model {tag}", os.path.join(root, tag), model_ind,
                    batch, work, loaders).items():
                expected[f"model {tag} {dtype}"] = ids
        phases["predictors, exports, rates"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        flips = _serve_child(work, expected, root)
        _log(f"exported artifacts: {flips} ids flipped at near ties")
        phases["child"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _serve_import(root, "cuda")
        phases["import"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _serve_analysis(root, pngs)
        phases["analysis"] = time.perf_counter() - t0
        launches = _read_counts()
    _log(f"phase_serve kernel launches: {launches} (total "
         f"{sum(launches.values())})")
    _no_launches("phase_serve", launches)
    _log("serve phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()))
    return {"iid_loss_fwd": 0}


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


MEASURED_KERNELS = ("seg_joint_fwd", "seg_joint_dgrad", "iid_loss_fwd")
# The port's four measurement tools, run at their default shapes, each
# with the launches it must show: (module, kernels required, kernels
# refused)
MEASURE_TOOLS = (
    ("joint_kernel_bench", ("seg_joint_fwd", "seg_joint_dgrad"), ()),
    ("fused_loss_bench", ("iid_loss_fwd",), ()),
    ("eval_cost_bench", (), MEASURED_KERNELS),
    ("e2e_gap_trace", ("seg_joint_fwd", "seg_joint_dgrad"), ()))
# A gap-trace run's wall is at least this share of the device-step-only
# time of its pairs (measured beside it in the same call): the card runs
# the same steps one after another in both
GAP_WALL_FLOOR = 0.8


def _check_joint_bench(records):
    """The joint bench's records: fft not ported, finite times and
    errors, the kernel within K1_F64 (K1_F64_FMA in its CUDA-core form) of
    max of its bf16 function in float64. Then, on the bench's own inputs
    (launches not counted: the counts were read), the kernel's P and both
    input gradients against the plain conv's within the JAX contract."""
    import torch
    from iic_tpu_torch.ops.kernels import seg_joint as sj
    from iic_tpu_torch.tools import joint_kernel_bench as jkb

    by_name = {r["name"]: r for r in records}
    if by_name["fft"]["ported"]:
        raise AssertionError("joint bench: fft reported as ported")
    for rec in (by_name["pallas"], by_name["conv"]):
        nums = [rec["fwd_ms"], rec["grad_ms"], rec["err"]]
        if not all(math.isfinite(v) for v in nums):
            raise AssertionError(f"joint bench: not finite: {rec}")
    kern = by_name["pallas"]
    tol = K1_F64 if kern["form"] == "wgmma" else K1_F64_FMA
    _log(f"  joint bench kernel vs its bf16 function in float64 "
         f"({kern['form']}): {kern['err_bf16_f64']:.3e} of max (bound "
         f"{tol:g})")
    if not kern["err_bf16_f64"] <= tol:
        raise AssertionError("joint bench: K1 off its bf16 function")
    n, k, h, half_t = jkb.DEFAULT_SIZE
    x1, x2 = jkb.inputs(n, k, h, "cuda")
    got = jkb.outputs(sj.displacement_joint_dense_kernel, x1, x2, half_t)
    ref = jkb.outputs(sj.displacement_joint_dense, x1, x2, half_t)
    for tag, a, b in zip(("P", "dx1", "dx2"), got, ref):
        _compare(f"joint bench {tag}, kernel vs conv", a, b)
    del x1, x2, got, ref
    torch.cuda.empty_cache()


def _check_fused_loss_bench(result):
    """The fused-loss bench's loss-only losses, fused against xla within
    K3's contract, and (launches not counted) both impls' gradients on
    the bench's inputs; finite full-step times and losses.
    Logs K3's reading: host ms a call beside the profiler's device ms."""
    import torch
    from iic_tpu_torch.tools import fused_loss_bench as flb

    lo, fs = result["loss_only"], result["full_step"]
    _check("fused-loss bench loss-only loss, fused vs xla",
           torch.tensor(lo["fused"]["loss"]), torch.tensor(lo["xla"]["loss"]),
           K3_RTOL, K3_ATOL)
    z, zt = flb.loss_inputs(device="cuda")
    (_, g_f), (_, g_x) = (flb.loss_and_grads(impl, z, zt)
                          for impl in ("fused", "xla"))
    for tag, a, b in zip(("dz", "dzt"), g_f, g_x):
        _check(f"fused-loss bench {tag}, fused vs xla", a, b, K3_GRAD_RTOL,
               K3_GRAD_ATOL)
    for impl in ("xla", "fused"):
        r = lo[impl]
        _log(f"  K3 reading, loss-only {impl}: host {r['ms']:.4f} ms a "
             f"call (fwd+bwd), device {r['device_ms']:.4f} ms a call, K3's "
             f"kernel {r['k3_device_ms']:.4f}")
        if not all(math.isfinite(v) for v in (
                r["ms"], r["device_ms"], fs[impl]["ms"], fs[impl]["loss"])):
            raise AssertionError(f"fused-loss bench {impl}: not finite")


def _check_eval_bench(records):
    """Each eval's wall finite and positive, its accuracy in [0, 1]."""
    for rec in records:
        if not (math.isfinite(rec["wall_s"]) and rec["wall_s"] > 0
                and 0.0 <= rec["best_acc_sanity"] <= 1.0):
            raise AssertionError(f"eval bench: {rec}")


def _check_gap_trace(result):
    """Each run's wall covers the card's work: at least
    ``GAP_WALL_FLOOR`` of the device-step-only time of the same pairs (a
    clock stopped before the drain reads less), with one wait and one
    host prep a batch; its timed parts tile the wall (each part is its own
    intervals, so a dropped or twice-counted one shows); finite rates."""
    from iic_tpu_torch.tools.e2e_gap_trace import BATCH_SZ

    rates = result["device_step_only"]
    if not all(math.isfinite(v) and v > 0 for v in rates.values()):
        raise AssertionError(f"gap trace: rates {rates}")
    for rec in result["runs"]:
        parts = (rec["wait_data"] + rec["dispatch"] + rec["fetch"]
                 + rec["other"])
        batches = len(rec["waits"])
        step_only = rec["n_pairs"] / rates["mix"]
        _log(f"  gap trace depth {rec['depth']}: wall {rec['wall']} s = "
             f"wait_data {rec['wait_data']} + dispatch {rec['dispatch']} + "
             f"fetch {rec['fetch']} + other {rec['other']} over "
             f"{rec['n_pairs']} pairs, {batches} batches; device-step-only "
             f"{rates}, {step_only} s for these pairs")
        if (abs(parts - rec["wall"]) > 1e-6
                or rec["wall"] < GAP_WALL_FLOOR * step_only
                or len(rec["prep"]) != batches
                or rec["n_pairs"] != batches * BATCH_SZ):
            raise AssertionError(
                f"gap trace: split {parts} of wall {rec['wall']} "
                f"(device-step-only {step_only}), {len(rec['prep'])} "
                f"preps for {batches} batches, {rec['n_pairs']} pairs")
    for rec in result["continuous"]:
        step_only = rec["n_pairs"] / rates["mix"]
        _log(f"  gap trace continuous depth {rec['depth']}: wall "
             f"{rec['wall']} s, {rec['n_pairs']} pairs, wait_data "
             f"{rec['wait_data']} s; device-step-only {step_only} s")
        if rec["wall"] < GAP_WALL_FLOOR * step_only:
            raise AssertionError(f"gap trace continuous: wall {rec['wall']}"
                                 f" under device-step-only {step_only}")


def phase_measure_tools(trace_dir=""):
    """The port's four measurement tools in-process on the card at their
    default shapes (``MEASURE_TOOLS``), counts set to 0 just before each
    and read just after: each must launch the kernels of its path and
    none it does not run. Then their results are checked (``_check_*``;
    the launches of those checks are not counted). Returns {kernel:
    launches of the four}."""
    import importlib

    results, total = {}, {}
    for name, needs, refused in MEASURE_TOOLS:
        tool = importlib.import_module(f"iic_tpu_torch.tools.{name}")
        argv = (["--profile_dir", os.path.join(trace_dir, name)]
                if name == "e2e_gap_trace" and trace_dir else [])
        _log(f"--- {name} {' '.join(argv)}")
        _reset_counts()
        t0 = time.perf_counter()
        results[name] = tool.main(argv)
        sys.stdout.flush()
        launches = {k: v for k, v in _read_counts().items()
                    if k in MEASURED_KERNELS}
        _log(f"{name}: {time.perf_counter() - t0:.1f} s; LAUNCHES "
             f"{launches}")
        if (any(launches[k] < 1 for k in needs)
                or any(launches[k] for k in refused)):
            raise AssertionError(f"{name}: launches {launches}, needs "
                                 f"{needs}, refuses {refused}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    _check_joint_bench(results["joint_kernel_bench"])
    _check_fused_loss_bench(results["fused_loss_bench"])
    _check_eval_bench(results["eval_cost_bench"])
    _check_gap_trace(results["e2e_gap_trace"])
    return total


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
    """Steady head-A and head-B steps of the clustering path (model 640, K3
    on) in ``dtype``. Returns {head: ``_profile``'s result}."""
    from iic_tpu_torch.cli import cluster_sobel_twohead

    return _cluster_profile("cluster", cluster_sobel_twohead,
                            CLUSTER_CLI_ARGS, "AB", dtype, trace_dir)


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
    from iic_tpu_torch.cli import cluster_sobel_twohead
    from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
    from iic_tpu_torch.parallel.train_step import (make_cluster_train_step,
                                                   make_optimizer)

    cfg = cluster_sobel_twohead.config(CLUSTER_CLI_ARGS
                                       + ["--model_dtype", dtype])
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


# ---------------------------------------------------- paper-parity harness

# The harness's rows run on the card (``iic_tpu_torch/tools/paper_parity.py
# run``), each in its child at the row's paper widths and batch, cut by
# --test_code to two steps a head pass: Potsdam-3 runs K1 and K2 (k 24 on
# the tensor cores, k 3 on the CUDA cores), MNIST with --fused_loss K3,
# CIFAR10 the plain loss
PARITY_ROWS = (("potsdam3", []), ("mnist", ["--fused_loss"]),
               ("cifar10", []))
PARITY_EXTRA = ["--test_code", "--num_epochs", "2"]
# the rows whose trees the phase's root holds (Potsdam, MNIST, STL10 with
# its unlabelled split, CIFAR10): ``check`` must say OK for exactly these
PARITY_TREES = ("stl10", "stl10_b", "cifar10", "mnist", "stl10_abl_noaux",
                "stl10_abl_1head", "stl10_abl_norep", "stl10_abl_nounlab",
                "potsdam3", "potsdam6")
# images in each CIFAR10 pickle batch: 5 x 264 training images, two of
# model 640's batches of 660 (and 264 test images)
CIFAR10_BATCH = 264
# the child ``run`` starts, wrapped: the row's CLI, then the child's kernel
# launches and its steps on the log's last line (the parent's counts do
# not see a child's)
PARITY_CHILD = (
    "import json, sys\n"
    "from iic_tpu_torch.ops.kernels import iid_loss, seg_joint\n"
    "from iic_tpu_torch.tools.paper_parity import run_row\n"
    "seg_joint.reset_launch_counts()\n"
    "iid_loss.reset_launch_counts()\n"
    "_, history = run_row(sys.argv[1], sys.argv[2], sys.argv[3:])\n"
    "steps = sum(len(v) for k, v in history.items()\n"
    "            if k.startswith('step_seconds_head_'))\n"
    "print('LAUNCHES ' + json.dumps({**seg_joint.LAUNCHES,\n"
    "                                **iid_loss.LAUNCHES, 'steps': steps}),\n"
    "      flush=True)\n")
# JAX's learning evidence on the TPU (VALIDATION.md:105-106, :260, :276),
# printed beside the port's; one seed an experiment, so not a gate
EVIDENCE_JAX = {"twohead": {"best_acc": 0.514},
                "semisup": {"finetune_best_acc": 0.516},
                "digits_baselines": {"kmeans_raw_pixels_acc": 0.792,
                                     "kmeans_pca32_acc": 0.790}}
EVIDENCE_INERTIA = 1.01  # a fit's inertia against float64 Lloyd's
# the twohead evidence's seeds: its band on the card, printed by seed, not a
# gate (the JAX package stalls there too off the TPU: ROADMAP queue 3)
TWOHEAD_SEEDS = (0, 1, 2)
# a seed's twohead run, in a child of its own (the runs are host-bound, so
# the seeds run at once, one process each): the tool's entry point
# ``run_twohead`` with the seed set on its config, its trainer wrapped only
# to keep the epoch losses; prints the tool's JSON line, then the run's
# accuracies, epoch losses, seconds and kernel launches on its last line
TWOHEAD_CHILD = (
    "import json, sys, time\n"
    "from iic_tpu_torch.ops.kernels import iid_loss, seg_joint\n"
    "from iic_tpu_torch.tools import learning_evidence as le\n"
    "histories = []\n"
    "train = le.train_cluster_twohead\n"
    "def train_keeping(cfg, **kwargs):\n"
    "    net, h = train(cfg, **kwargs)\n"
    "    histories.append(h)\n"
    "    return net, h\n"
    "le.train_cluster_twohead = train_keeping\n"
    "cfg = le.twohead_config(sys.argv[2])\n"
    "cfg.seed = int(sys.argv[1])\n"
    "seg_joint.reset_launch_counts()\n"
    "iid_loss.reset_launch_counts()\n"
    "t0 = time.perf_counter()\n"
    "result = le.run_twohead(config=cfg)\n"
    "h = histories[-1]\n"
    "print('TWOHEAD ' + json.dumps({\n"
    "    'result': result,\n"
    "    'acc': [float(a) for a in h['eval'].epoch_acc],\n"
    "    'A': [float(v) for v in h['epoch_loss_head_A']],\n"
    "    'B': [float(v) for v in h['epoch_loss_head_B']],\n"
    "    'epochs': cfg.num_epochs, 'seconds': time.perf_counter() - t0,\n"
    "    'launches': {**seg_joint.LAUNCHES, **iid_loss.LAUNCHES}}),\n"
    "    flush=True)\n")


def _write_cifar10(root):
    """A CIFAR10 tree under root/cifar-10-batches-py: five training pickle
    batches and a test batch of CIFAR10_BATCH images each ("data" (n,
    3072) uint8, channel planes in order, "labels"), the port's clusterable
    synthetic images standing in for the photographs."""
    import os
    import pickle
    from iic_tpu_torch.data.readers import make_synthetic

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for i, name in enumerate(names):
        d = make_synthetic(CIFAR10_BATCH, 10, 32, 3, seed=i)
        data = d["images"].transpose(0, 3, 1, 2).reshape(CIFAR10_BATCH, -1)
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": data, "labels": d["labels"].tolist()}, f)


def _write_parity_trees(root):
    """The trees the harness's rows read beside the MNIST and STL10 trees
    already in ``root``: Potsdam (``_write_potsdam``) and CIFAR10."""
    _write_potsdam(root)
    _write_cifar10(root)


def _harness(pp, argv):
    """The harness's ``main(argv)`` in-process, its output captured and
    printed. Returns (rc, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pp.main(argv)
    _log(buf.getvalue().rstrip())
    return rc, buf.getvalue()


def _check_status(out):
    """``check``'s output -> {row: OK or MISSING}."""
    return dict(line.split()[:2] for line in out.splitlines()
                if line and not line.startswith(" "))


def _child_launches(log_path):
    """The launches and steps a wrapped child printed last in its log."""
    with open(log_path) as f:
        lines = [ln for ln in f if ln.startswith("LAUNCHES ")]
    if not lines:
        raise AssertionError(f"{log_path}: no LAUNCHES line")
    return json.loads(lines[-1][len("LAUNCHES "):])


def _finite_numbers(result):
    vals = [v for v in result.values() if isinstance(v, (int, float))]
    return all(math.isfinite(v) for v in vals)


def _start_twohead(out_root):
    """``learning_evidence.run_twohead`` whole on cuda:0 at each of
    TWOHEAD_SEEDS, a child each (``TWOHEAD_CHILD``, its output to
    <out_root>/twohead_s<seed>.log), all started at once. Returns {seed:
    (the child, its log's path)}."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out_root, exist_ok=True)
    children = {}
    for seed in TWOHEAD_SEEDS:
        log = os.path.join(out_root, f"twohead_s{seed}.log")
        with open(log, "w") as f:
            children[seed] = (subprocess.Popen(
                [sys.executable, "-c", TWOHEAD_CHILD, str(seed),
                 os.path.join(out_root, f"twohead_s{seed}")],
                cwd=here, stdout=f, stderr=subprocess.STDOUT), log)
    return children


def _finish_twohead(children):
    """Each seed's run, waited for: rc 0, every number finite, the tool's
    JSON line (pre, best and final accuracy, epochs) the run's own, no
    launch of K1-K3 (the plain loss); the best and final accuracy and both
    heads' epoch losses printed by seed, beside JAX's one run on the
    TPU."""
    bests = []
    for seed, (child, log) in children.items():
        child.wait(timeout=900)
        with open(log) as f:
            out = f.read()
        lines = [ln for ln in out.splitlines() if ln.startswith("TWOHEAD ")]
        if child.returncode != 0 or not lines:
            raise AssertionError(f"twohead seed {seed}: rc "
                                 f"{child.returncode}\n{out[-4000:]}")
        run = json.loads(lines[-1][len("TWOHEAD "):])
        result, accs = run["result"], run["acc"]
        losses = {h: run[h] for h in "AB"}
        if len(accs) != run["epochs"] or not all(
                math.isfinite(v) for v in accs + losses["A"] + losses["B"]):
            raise AssertionError(f"twohead seed {seed}: {run}")
        # the tool's JSON line: its numbers finite and the run's own
        if not _finite_numbers(result) or (
                result["pre_acc"], result["best_acc"], result["final_acc"],
                result["epochs"]) != (accs[0], max(accs), accs[-1],
                                      len(accs) - 1):
            raise AssertionError(f"twohead seed {seed}: the tool's line "
                                 f"{result} is not the run's {accs}")
        _no_launches(f"twohead seed {seed}", run["launches"])
        bests.append(max(accs))
        _log(f"learning evidence twohead seed {seed}: "
             f"{run['seconds']:.1f} s; best_acc {max(accs):.4f}, final "
             f"{accs[-1]:.4f} (JAX on the TPU, one run: "
             f"{EVIDENCE_JAX['twohead']['best_acc']:.3f}); losses A "
             f"{' '.join(f'{v:.4f}' for v in losses['A'])}; B "
             f"{' '.join(f'{v:.4f}' for v in losses['B'])}")
    _log(f"learning evidence twohead: best_acc {min(bests):.4f}-"
         f"{max(bests):.4f} over seeds {list(TWOHEAD_SEEDS)} (not a gate: "
         f"the JAX package stalls on the CPU too, ROADMAP queue 3)")


def _evidence(out_root):
    """``learning_evidence``'s twohead config by seed (in children,
    ``_start_twohead`` / ``_finish_twohead``, while the rest runs here),
    semisup and digits_baselines whole on the card: each JSON line finite,
    printed beside JAX's figure, no launch of K1-K3 (none is on these
    paths: the plain loss, IID+, the finetune); the digits k-means fits
    held to float64: each fit's inertia within EVIDENCE_INERTIA of Lloyd's
    in float64 on the host from the same seeds, and its iterations to
    ``replay_float64``. Returns {experiment: seconds}."""
    from iic_tpu_torch.evals.kmeans_eval import lloyd, replay_float64
    from iic_tpu_torch.tools import learning_evidence as le

    t_twohead = time.perf_counter()
    children = _start_twohead(out_root)
    try:
        seconds = _evidence_here(le, lloyd, replay_float64, out_root)
        _finish_twohead(children)
    finally:
        for child, _ in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()
    seconds["twohead"] = time.perf_counter() - t_twohead
    return seconds


def _evidence_here(le, lloyd, replay_float64, out_root):
    """semisup and digits_baselines in this process (``_evidence``)."""
    seconds = {}
    for name, run in (("semisup", lambda: le.run_semisup(out_root)),
                      ("digits_baselines", le.run_digits_baselines)):
        _reset_counts()
        t0 = time.perf_counter()
        result = run()
        seconds[name] = time.perf_counter() - t0
        launches = _read_counts()
        beside = "; ".join(
            f"{k} {result[k]:.4f} (JAX on the TPU {v:.3f})"
            for k, v in EVIDENCE_JAX[name].items())
        _log(f"learning evidence {name}: {seconds[name]:.1f} s; {beside}; "
             f"launches {launches}")
        if not _finite_numbers(result):
            raise AssertionError(f"learning evidence {name}: {result}")
        _no_launches(f"learning evidence {name}", launches)
    for name, (x, fit) in le.digits_fits().items():
        xc = x.double().cpu()
        xc = xc - xc.mean(0)
        tol = float(xc.var(0, unbiased=False).mean()) * fit.tol
        init = fit.init_centers_.double().cpu() - x.double().cpu().mean(0)
        *_, inertia64, iters64 = lloyd(xc, init, fit.max_iter, tol)
        rep = replay_float64(x, fit, tie_rel=KMEANS_TIE_REL)
        ratio = fit.inertia_ / inertia64
        _log(f"digits k-means {name} ({tuple(x.shape)} on {x.device}): "
             f"inertia {fit.inertia_:.6g} in {fit.n_iter_} iterations, "
             f"float64 Lloyd from the same seeds {inertia64:.6g} in "
             f"{iters64} ({ratio:.6f}x); replay: {rep['mismatches']} labels "
             f"off outside ties ({rep['ties']} within {KMEANS_TIE_REL:g}), "
             f"centroids {rep['centre_err']:.3e} of max off")
        if not (ratio <= EVIDENCE_INERTIA and math.isfinite(ratio)):
            raise AssertionError(f"digits k-means {name}: inertia {ratio}x "
                                 f"its float64 Lloyd's")
        if rep["mismatches"] or rep["centre_err"] > KMEANS_CENTRE_REL:
            raise AssertionError(f"digits k-means {name} off its float64 "
                                 f"replay: {rep}")
    try:
        import cv2
        why = (f"OpenCV {cv2.__version__} imports here, but the probe's 120 "
               f"pretrain and 2 x 60 finetune epochs are left out of the "
               f"phase (python -m iic_tpu_torch.tools.learning_evidence "
               f"nuisance_probe runs it)")
    except ImportError as e:
        why = f"OpenCV does not import here ({e})"
    _log(f"learning evidence nuisance_probe: not run: DigitsNuisance draws "
         f"its nuisance with cv2.warpAffine (data/readers.py); {why}; the "
         f"CPU tests run it shrunk (tests/test_torch_learning_evidence.py)")
    return seconds


def _parity_runs(pp, root, out_root):
    """The harness's ``run`` of each of PARITY_ROWS, one call a row.
    Returns {row: (rc, seconds)}."""
    done = {}
    for key, extra in PARITY_ROWS:
        t0 = time.perf_counter()
        rc = pp.main(["run", "--dataset_root", root, "--out_root", out_root,
                      "--rows", key, "--", *PARITY_EXTRA, *extra])
        done[key] = (rc, time.perf_counter() - t0)
    return done


def _check_parity_run(key, extra, row, rc, seconds, log_path):
    """A row's run: rc 0, and its wrapped child's launches (K1 and K2 in
    both heads of a segmentation row, none elsewhere; K3 one a step under
    --fused_loss, else none). Returns the launches."""
    if rc != 0:
        raise AssertionError(f"parity run {key}: rc {rc}")
    got = _child_launches(log_path)
    _log(f"parity run {key} (model {row.model_ind}): rc {rc}, "
         f"{seconds:.1f} s; the child's launches and steps {got}")
    if "segmentation" in row.module:  # both heads: 2 steps each
        ok = got["seg_joint_fwd"] >= 4 and got["seg_joint_dgrad"] >= 8
    else:
        ok = got["seg_joint_fwd"] == 0 == got["seg_joint_dgrad"]
    fused = "--fused_loss" in extra
    if not ok or got["iid_loss_fwd"] != (got["steps"] if fused else 0):
        raise AssertionError(f"parity run {key}: launches {got}")
    return got


def phase_parity(root):
    """The paper-parity harness (``tools/paper_parity.py``) and the
    learning evidence (``tools/learning_evidence.py``) on the card, on the
    trees in ``root`` (MNIST, STL10, Potsdam, CIFAR10): ``check`` of all
    13 rows (OK for exactly ``PARITY_TREES``, rc 1 for the COCO rows and
    CIFAR20) and of an empty root (rc 1, all MISSING); ``run`` of each of
    ``PARITY_ROWS`` on cuda:0 (the default), one call a row, each child
    wrapped to print its launches (``PARITY_CHILD``): rc 0, K1 >= 4 and
    K2 >= 8 in Potsdam-3's child (2 steps a head, both heads), K3 one a
    step in MNIST's, none in CIFAR10's; ``report`` of the three with a
    parsed accuracy each. The runs go on a thread while ``_evidence`` runs
    here (the children are separate processes: their start-up, about 8 s
    each, overlaps the evidence's training), so their seconds are under
    that load. Returns the children's {kernel: launches}."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from iic_tpu_torch.tools import paper_parity as pp

    torch.cuda.empty_cache()  # the children need the card's memory
    t0 = time.perf_counter()
    rc, out = _harness(pp, ["check", "--dataset_root", root])
    status = _check_status(out)
    want = {r.key: "OK" if r.key in PARITY_TREES else "MISSING"
            for r in pp.ROWS}
    if rc != 1 or status != want:
        raise AssertionError(f"check: rc {rc}, {status} (want rc 1, {want})")
    with tempfile.TemporaryDirectory() as empty:
        rc, out = _harness(pp, ["check", "--dataset_root", empty])
    if rc != 1 or set(_check_status(out).values()) != {"MISSING"}:
        raise AssertionError(f"check of an empty root: rc {rc}")
    out_root = os.path.join(root, "parity_runs")
    child = pp.CHILD_CODE
    pp.CHILD_CODE = PARITY_CHILD
    try:
        with ThreadPoolExecutor(1) as pool:
            runs = pool.submit(_parity_runs, pp, root, out_root)
            evidence_s = _evidence(os.path.join(root, "evidence"))
            done = runs.result()
    finally:
        pp.CHILD_CODE = child
    launches = {"seg_joint_fwd": 0, "seg_joint_dgrad": 0, "iid_loss_fwd": 0}
    for key, extra in PARITY_ROWS:
        row = pp.ROW_MAP[key]
        got = _check_parity_run(key, extra, row, *done[key], os.path.join(
            out_root, f"{row.model_ind}.out"))
        for k in launches:
            launches[k] += got[k]
    rc, out = _harness(pp, ["report", "--out_root", out_root, "--rows",
                            *[k for k, _ in PARITY_ROWS]])
    for key, _ in PARITY_ROWS:
        (line,) = [ln for ln in out.splitlines() if ln.startswith(key + " ")]
        best = float(line.split()[3])
        if "no run at" in line or not 0.0 <= best <= 1.0:
            raise AssertionError(f"report: {line}")
    _log(f"parity: {time.perf_counter() - t0:.1f} s (the rows' runs "
         f"{sum(s for _, s in done.values()):.1f} s beside the learning "
         f"evidence's {sum(evidence_s.values()):.1f} s); launches in the "
         f"children {launches}")
    return launches


# --------------------------------------------------------------- multi-GPU

MULTIGPU_MAX = 4  # ranks: the cards the machine shows, at most 4
# the R-rank seg step against one rank on the whole batch (TF32 off, SGD):
# loss, gradients, parameters and BN statistics as a share of each kind's
# largest entry, held within MULTIGPU_PARITY_MULT times what the one rank
# moves by itself when only the batch's row order changes (synced BN's
# var = E[x^2] - E[x]^2, the JAX formula, is that noisy in f32: on the
# CPU a reversed batch moves the gradients by 2e-3 of max at 32^2), and
# never beyond MULTIGPU_PARITY_FLOOR below that
MULTIGPU_PARITY_MULT = 4.0
MULTIGPU_PARITY_FLOOR = 1e-4
MULTIGPU_PROFILE_STEPS = 3
# the sharded eval's gathered output against one rank's, as probabilities:
# within MULTIGPU_EVAL_MULT times the one rank's own difference when its
# batch is reversed, and never beyond MULTIGPU_EVAL_FLOOR below that
MULTIGPU_EVAL_MULT = 4.0
MULTIGPU_EVAL_FLOOR = 1e-4
MULTIGPU_TIMEOUT_S = 600  # a rank stuck in a collective fails the phase


def _multigpu_parity(mesh, device):
    """Model 555's head-A step (uncollapsed loss, K1 and K2) in global mode
    with --bn_sync, TF32 off, on a fixed batch of 120 pairs made on the
    host from a seed: this rank's shard on the mesh, then (rank 0) one rank
    on the whole batch. SGD, so the update shows the reduced gradient.
    Rank 0 also runs the one rank on the batch in reversed row order: the
    same sums in another order, the f32 noise floor. Returns ({kind:
    largest difference as a share of the kind's largest entry}, the same
    for the reversed batch) (rank 0) or None."""
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.models.layers import sync_batch_norm
    from iic_tpu_torch.parallel.train_step import make_seg_train_step

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parse_seg_args(CLI_ARGS + ["--bn_sync"]).finalize(twohead=True)
    torch.manual_seed(0)
    state = models.build(cfg.arch, cfg).state_dict()
    g = torch.Generator().manual_seed(1)
    img1 = torch.rand(N, 4, HW, HW, generator=g)
    img2 = (img1 + 0.1 * torch.randn(img1.shape, generator=g)).clamp(0, 1)
    a = (torch.rand(N, generator=g) - 0.5) * 0.5
    aff = torch.zeros(N, 2, 3)
    aff[:, 0, 0], aff[:, 0, 1] = a.cos(), -a.sin()
    aff[:, 1, 0], aff[:, 1, 1] = a.sin(), a.cos()
    mask = (torch.rand(N, HW, HW, generator=g) > 0.1).float()
    batch = (img1, img2, aff, mask)

    def one(m, rows):
        net = models.build(cfg.arch, cfg).to(device)
        net.load_state_dict(state)
        sync_batch_norm(net, m)
        opt = torch.optim.SGD(net.parameters(), lr=0.05)
        step = make_seg_train_step(
            net, opt, lamb=cfg.lamb_A, head="A", half_T_side_dense=HALF_T,
            half_T_side_sparse_min=0, half_T_side_sparse_max=0, sobel=True,
            include_rgb=True, use_uncollapsed_loss=True, mesh=m)
        loss, _ = step(tuple(x[rows].to(device) for x in batch))
        return (float(loss), {k: v.detach().clone()
                              for k, v in net.state_dict().items()},
                {k: p.grad.detach().clone()
                 for k, p in net.named_parameters()})

    try:
        shard = N // mesh.size
        got = one(mesh, slice(mesh.rank * shard, (mesh.rank + 1) * shard))
        if mesh.rank:
            return None
        ref = one(None, slice(None))
        reversed_rows = one(None, torch.arange(N - 1, -1, -1))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.\
            allow_tf32 = tf32

    def errors(got):
        errs = {"loss": abs(got[0] - ref[0]) / abs(ref[0])}
        for kind, i, pick in (("grads", 2, lambda k: True),
                              ("params", 1, lambda k: "running" not in k
                               and "num_batches" not in k),
                              ("stats", 1, lambda k: "running" in k)):
            keys = [k for k in ref[i] if pick(k)]
            big = max(float(ref[i][k].abs().max()) for k in keys)
            errs[kind] = max(float((got[i][k] - ref[i][k]).abs().max())
                             for k in keys) / big
        return errs

    return errors(got), errors(reversed_rows)


def _multigpu_profile(mesh, device):
    """Model 555's head-A step (f32, TF32 convs, global mode, the trainer's
    pipeline shard and augmentation) on this rank: 2 warm-up steps, then
    MULTIGPU_PROFILE_STEPS timed by the host clock (synchronised), the
    same again under torch.profiler. Returns (wall ms a step, device busy
    ms a step, all-reduce (NCCL kernel) ms a step, the NCCL kernels'
    names, the 8 kernels of most device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from iic_tpu_torch import models
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
    from iic_tpu_torch.parallel.train_step import (make_optimizer,
                                                   make_seg_train_step)

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parse_seg_args(CLI_ARGS).finalize(twohead=True)
    torch.manual_seed(0)
    pipe = SegTrainPipeline(
        cfg, ["train"], seed=0, device=device,
        process_shard=(mesh.rank, mesh.size) if mesh.size > 1 else None)
    net = models.build(cfg.arch, cfg).to(device)
    opt = make_optimizer(net, cfg)
    step = make_seg_train_step(
        net, opt, lamb=cfg.lamb_A, head="A", half_T_side_dense=HALF_T,
        half_T_side_sparse_min=0, half_T_side_sparse_max=0, sobel=True,
        include_rgb=True, use_uncollapsed_loss=True, augment=pipe.augment,
        mesh=mesh)
    batches = []  # model 555's set holds 4 batches of 120: two epochs
    for e_i in (1, 2):
        batches += [((imgs, masks), gen) for imgs, masks, gen in
                    pipe.epoch(e_i)]
    batches = batches[:2 + MULTIGPU_PROFILE_STEPS]
    for batch in batches[:2]:
        float(step(*batch)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[2:]:
        float(step(*batch)[0])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / MULTIGPU_PROFILE_STEPS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches[2:]:
            float(step(*batch)[0])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    n = MULTIGPU_PROFILE_STEPS
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    nccl = [e for e in events if "nccl" in e.key.lower()]
    reduce_ms = sum(e.self_device_time_total for e in nccl) / n / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return (wall, busy, reduce_ms, sorted({e.key[:60] for e in nccl}),
            [(round(e.self_device_time_total / n / 1e3, 3), e.key[:70])
             for e in top])


def _multigpu_eval(mesh, device):
    """The sharded eval (``make_sharded_eval``) of model 555 (eval-mode BN
    on running statistics) and of model 640 (the same, and its double
    eval's train-mode BN, whose batch statistics are taken over the ranks)
    over their CLIs' mapping-assignment sets, on a net built from seed 0
    (the same on every rank), TF32 off: on this rank each batch sharded,
    then unsharded (one rank on the batch padded as the sharded eval pads
    it), each timed (synchronised; both run once untimed on the first
    batch before), the rows of the sharded forwards
    counted by a forward hook (ceil(b / R) for each batch of b), and the
    largest difference of the gathered output from the unsharded one beside
    that rank's own noise (the unsharded eval of the batch in reversed row
    order). Returns {tag: (the rows of its forwards, whether each batch's
    were ceil(b / R), sharded s, unsharded s, difference, noise,
    batches)}."""
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.cli._args import parse_cluster_args, parse_seg_args
    from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
    from iic_tpu_torch.data.seg_pipeline import (
        segmentation_create_dataloaders)
    from iic_tpu_torch.parallel.mesh import make_sharded_eval
    from iic_tpu_torch.parallel.train_step import make_apply_fn

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seg = parse_seg_args(CLI_ARGS).finalize(twohead=True)
    cluster = parse_cluster_args(CLUSTER_CLI_ARGS).finalize(twohead=True,
                                                            sobel=True)
    seg_loader = segmentation_create_dataloaders(seg, device=device)[1]
    cluster_loader = cluster_twohead_create_dataloaders(
        cluster, device=device)[2]
    out = {}
    try:
        for tag, cfg, train_mode, loader in (
                ("model 555 eval", seg, False, seg_loader),
                ("model 640 eval", cluster, False, cluster_loader),
                ("model 640 double eval", cluster, True, cluster_loader)):
            torch.manual_seed(0)
            net = models.build(cfg.arch, cfg).to(device)
            apply = make_apply_fn(net, head="B", sobel=cfg.sobel,
                                  include_rgb=cfg.include_rgb,
                                  using_IR=getattr(cfg, "using_IR", False),
                                  train_mode=train_mode)
            sharded = make_sharded_eval(apply, net, mesh)
            rows, secs, err, noise, n = [], [0.0, 0.0], 0.0, 0.0, 0
            rows_ok = True
            for batch in loader:
                imgs = batch[0]
                b = len(imgs)
                seen = len(rows)
                pad = (-b) % mesh.size
                padded = torch.cat([imgs, imgs[-1:].expand(
                    pad, *imgs.shape[1:])]) if pad else imgs
                if n == 0:  # warm-up: cuDNN picks its algorithms
                    sharded(imgs)
                    apply(padded)
                hook = net.register_forward_pre_hook(
                    lambda m, a: rows.append(int(a[0].shape[0])))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = sharded(imgs)
                torch.cuda.synchronize()
                secs[0] += time.perf_counter() - t0
                hook.remove()
                rows_ok &= rows[seen:] == [-(-b // mesh.size)]
                t0 = time.perf_counter()
                want = apply(padded)[:, :b]
                torch.cuda.synchronize()
                secs[1] += time.perf_counter() - t0
                rev = apply(padded.flip(0)).flip(1)[:, :b]
                err = max(err, float((got - want).abs().max()))
                noise = max(noise, float((rev - want).abs().max()))
                n += 1
            out[tag] = (sorted(set(rows)), rows_ok, secs[0], secs[1], err,
                        noise, n)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.\
            allow_tf32 = tf32
    return out


class _FixedPairs:
    """Head B's pipeline for the sub-head pick, on fixed pairs: unsharded,
    ``epoch(0, augmented=True)`` yields each whole pair; sharded, each
    batch is a base (its index) with all-ones weights and
    ``augment_pair`` gives this rank's contiguous rows of the pair."""

    def __init__(self, pairs, mesh=None):
        self.pairs = pairs
        self.mesh = mesh

    def _rows(self, n):
        shard = n // self.mesh.size
        return slice(self.mesh.rank * shard, (self.mesh.rank + 1) * shard)

    def epoch(self, epoch_idx, augmented=False):
        import torch
        for i, pair in enumerate(self.pairs):
            if augmented:
                yield pair
            else:
                rows = self._rows(len(pair[0]))
                yield (torch.tensor([i]), torch.ones(
                    rows.stop - rows.start, device=pair[0].device)), None

    def augment_pair(self, base, generator):
        imgs, imgs_tf = self.pairs[int(base[0])]
        rows = self._rows(len(imgs))
        return imgs[rows], imgs_tf[rows]


MULTIGPU_PICK_BATCHES = 2
# the sub-heads' summed losses, R ranks against 1, relative to the largest:
# within MULTIGPU_PICK_MULT times one rank's own difference when the pairs'
# rows are reversed, and never beyond MULTIGPU_PICK_REL below that (at 4
# gloo ranks on a cut-down model 640 on the CPU: 2.4e-5)
MULTIGPU_PICK_MULT = 4.0
MULTIGPU_PICK_REL = 1e-4
# head B's init (N(0, 0.01)) scaled up: at init its outputs are so near
# uniform that every sub-head's loss is ~1e-6, at the f32 noise
MULTIGPU_PICK_HEAD_SCALE = 100.0


def _multigpu_pick(mesh, device):
    """The clustering trainer's sub-head pick by loss
    (``_select_sub_head_on_loss``) at model 640's shape with
    ``--batchnorm_track`` off (eval-mode BN on batch statistics), TF32 off,
    head B's weights scaled by MULTIGPU_PICK_HEAD_SCALE, on fixed pairs: head B's first MULTIGPU_PICK_BATCHES augmented batches
    of its unsharded pipeline (the same on every rank), then on this rank
    the pick sharded over the mesh (the rank's rows, BN statistics over the
    ranks), the pick of one rank on the whole pairs and one rank's on the
    pairs' rows reversed (its f32 noise), each sub-head's summed loss
    recorded. Returns (sharded pick, one-rank pick, the largest loss
    difference relative to the largest loss, the same for the reversed
    rows, the losses)."""
    import numpy as np
    import torch
    from iic_tpu_torch import models
    from iic_tpu_torch.cli._args import parse_cluster_args
    from iic_tpu_torch.data.pipeline import cluster_twohead_create_dataloaders
    from iic_tpu_torch.evals import cluster_eval
    from iic_tpu_torch.train import cluster_trainer

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parse_cluster_args([a for a in CLUSTER_CLI_ARGS
                              if a != "--batchnorm_track"]).finalize(
        twohead=True, sobel=True)
    pipe_b = cluster_twohead_create_dataloaders(cfg, device=device)[1]
    pairs = [pair for _, pair in zip(range(MULTIGPU_PICK_BATCHES),
                                     pipe_b.epoch(0, augmented=True))]
    torch.manual_seed(0)
    net = models.build(cfg.arch, cfg).to(device)
    with torch.no_grad():  # confident sub-heads: losses well off zero
        for p in net.head_B.parameters():
            p.mul_(MULTIGPU_PICK_HEAD_SCALE)
    # each pick's per-sub-head losses, from whichever loss it calls (the
    # sharded pick IID_loss, one rank's iid_loss_multihead)
    losses = {"sharded": [], "one": [], "reversed": []}
    current = []
    real = (cluster_trainer.IID_loss, cluster_eval.iid_loss_multihead)

    def recorded(fn, pick):
        def call(*a, **kw):
            out = fn(*a, **kw)
            losses[current[-1]].append(
                out[pick].detach().double().cpu().numpy())
            return out
        return call

    reversed_pairs = [(a.flip(0), b.flip(0)) for a, b in pairs]
    cluster_trainer.IID_loss = recorded(real[0], 0)
    cluster_eval.iid_loss_multihead = recorded(real[1], 2)
    try:
        current.append("sharded")
        sharded = cluster_trainer._select_sub_head_on_loss(
            cfg, net, _FixedPairs(pairs, mesh), mesh)
        current.append("one")
        one = cluster_trainer._select_sub_head_on_loss(
            cfg, net, _FixedPairs(pairs), None)
        current.append("reversed")
        cluster_trainer._select_sub_head_on_loss(
            cfg, net, _FixedPairs(reversed_pairs), None)
    finally:
        cluster_trainer.IID_loss, cluster_eval.iid_loss_multihead = real
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.\
            allow_tf32 = tf32
    want = np.sum(losses["one"], axis=0)
    got = np.sum(losses["sharded"], axis=0)
    scale = np.abs(want).max()
    rel = float(np.abs(got - want).max() / scale)
    noise = float(np.abs(np.sum(losses["reversed"], axis=0)
                         - want).max() / scale)
    return sharded, one, rel, noise, got.tolist()


def _multigpu_sharded_rank(device, out_root, n_ranks):
    """The sharded part of one rank of ``phase_multigpu``: the CLIs with
    --n_devices in the group the spawn made (counts set to 0 just before
    each run; their evals sharded), the sharded eval against one rank
    (``_multigpu_eval``) and the sub-head pick (``_multigpu_pick``).
    Returns its readings."""
    import numpy as np
    from iic_tpu_torch.cli import cluster_sobel_twohead, segmentation_twohead
    from iic_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_ranks, device)
    ranks = ["--n_devices", str(n_ranks)]
    out = {"rank": mesh.rank, "runs": {}}
    for tag, main, argv in (
            ("model 555 float32", segmentation_twohead.main, CLI_ARGS),
            ("model 555 bfloat16", segmentation_twohead.main,
             CLI_ARGS + ["--model_dtype", "bfloat16"]),
            ("model 640 float32", cluster_sobel_twohead.main,
             CLUSTER_CLI_ARGS),
            ("model 640 float32 --select_sub_head_on_loss",
             cluster_sobel_twohead.main,
             CLUSTER_CLI_ARGS + ["--select_sub_head_on_loss"])):
        _reset_counts()
        t0 = time.perf_counter()
        _, history = main(argv + ranks + ["--out_root", out_root],
                          device=device)
        seconds = time.perf_counter() - t0
        losses = {h: history[f"epoch_loss_head_{h}"] for h in "AB"}
        if not all(np.all(np.isfinite(v)) and v for v in losses.values()):
            raise AssertionError(f"rank {mesh.rank} {tag}: losses {losses}")
        steps = {h: [round(s, 4) for s in history[f"step_seconds_head_{h}"]]
                 for h in "AB"}
        out["runs"][tag] = dict(launches=_read_counts(), losses=losses,
                                steps=steps, seconds=seconds,
                                acc=history["eval"].epoch_acc)
    out["eval"] = _multigpu_eval(mesh, device)
    out["pick"] = _multigpu_pick(mesh, device)
    return out


def _multigpu_rank(device, root, out_root, n_ranks):
    """One rank of ``phase_multigpu``: its sharded part
    (``_multigpu_sharded_rank``), the parity check, one finetune step, the
    profile. Returns its readings."""
    import numpy as np
    from iic_tpu_torch.cli import IID_semisup_STL10
    from iic_tpu_torch.parallel.mesh import make_mesh
    from iic_tpu_torch.train.semisup_trainer import make_finetune

    out = _multigpu_sharded_rank(device, out_root, n_ranks)
    mesh = make_mesh(n_ranks, device)
    out["parity"] = _multigpu_parity(mesh, device)
    cfg = IID_semisup_STL10.config(SEMISUP698_ARGS + [
        "--n_devices", str(n_ranks), "--out_root",
        os.path.join(root, "multigpu_old_runs")])
    _reset_counts()
    ft = make_finetune(cfg, device, mesh)
    imgs, labels, gen = next(ft.loader.epoch(0))
    loss = float(ft.step((imgs, labels), gen))
    out["finetune"] = dict(loss=loss, rows=len(imgs),
                           launches=_read_counts())
    if not np.isfinite(loss):
        raise AssertionError(f"rank {mesh.rank} model 698 step: {loss}")
    out["profile"] = _multigpu_profile(mesh, device)
    return out


def _report_sharded(results, n_ranks, smi):
    """Log and check the ranks' readings of ``_multigpu_sharded_rank``: each
    CLI run's K1 / K2 launches (K3 none under a mesh), the sharded eval's
    rows, seconds and difference from one rank within its bound, the pick
    equal to one rank's on every rank. Returns {kernel: launches} of the
    seg runs summed over ranks."""
    launches = {"seg_joint_fwd": 0, "seg_joint_dgrad": 0}
    for res in results:
        r = res["rank"]
        for tag, run in res["runs"].items():
            got = run["launches"]
            _log(f"multigpu rank {r} {tag}: losses {run['losses']}, step "
                 f"seconds {run['steps']}, eval acc {run['acc']}, "
                 f"{run['seconds']:.1f} s, launches {got}")
            if got["iid_loss_fwd"]:
                raise AssertionError(f"rank {r} {tag}: K3 launched under a "
                                     f"mesh: {got}")
            if tag.startswith("model 555"):
                if got["seg_joint_fwd"] < 4 or got["seg_joint_dgrad"] < 8:
                    raise AssertionError(f"rank {r} {tag} missed K1/K2: "
                                         f"{got}")
                for k in launches:
                    launches[k] += got[k]
    for res in results:
        r = res["rank"]
        for tag, (rows, rows_ok, sharded_s, one_s, err, noise, n) in \
                res["eval"].items():
            bound = max(MULTIGPU_EVAL_MULT * noise, MULTIGPU_EVAL_FLOOR)
            _log(f"multigpu rank {r} sharded {tag} ({n} batches, TF32 off): "
                 f"rows a forward {rows} at R = {n_ranks}, {sharded_s:.3f} s "
                 f"sharded against {one_s:.3f} s for one rank on the whole "
                 f"batches; gathered output {err:.3e} off the one rank's "
                 f"(its reversed batches {noise:.3e}, bound {bound:.3e}); "
                 f"{smi}")
            if not rows_ok or err > bound:
                raise AssertionError(f"multigpu rank {r} sharded {tag}: rows "
                                     f"{rows}, difference {err} beyond "
                                     f"{bound}")
        sharded, one, rel, noise, losses = res["pick"]
        bound = max(MULTIGPU_PICK_MULT * noise, MULTIGPU_PICK_REL)
        _log(f"multigpu rank {r} sub-head pick, model 640 with "
             f"--batchnorm_track off on fixed pairs: {sharded} at R = "
             f"{n_ranks}, {one} at R = 1; losses {losses}, {rel:.3e} of max "
             f"off one rank's (its reversed rows {noise:.3e}, bound "
             f"{bound:.3e})" + (" (trivial: one rank)" if n_ranks == 1
                                else ""))
        if sharded != one or rel > bound:
            raise AssertionError(f"multigpu rank {r} pick: {sharded} against "
                                 f"{one}, losses {rel} off")
    picks = {res["pick"][0] for res in results}
    if len(picks) != 1:
        raise AssertionError(f"multigpu: the ranks picked {picks}")
    return launches


def phase_multigpu(root):
    """Data parallelism (``iic_tpu_torch/parallel/mesh.py``) over R =
    min(visible cards, MULTIGPU_MAX) ranks, one process a card over NCCL
    (R = 1 runs world size 1 through the same group, collectives and
    synced BN, and says that no cross-card check ran): model 555's
    two-head seg CLI with --n_devices R in f32 and bf16 (120 pairs global,
    --test_code) and model 640's clustering CLI (its --fused_loss falls
    back to the plain loss under a mesh), each rank's K1, K2 and K3
    launches read after each run (K1 and K2 on every rank, K3 on none); the
    R-rank step against one rank on the whole batch (global mode,
    --bn_sync, TF32 off) within MULTIGPU_PARITY_MULT times the one rank's
    own f32 noise (its batch reversed); the sharded eval of models 555 and
    640 (and 640's double eval) against one rank on the same weights,
    each rank's rows a forward and the eval's seconds at R beside one rank
    (``_multigpu_eval``); model 640's CLI with --select_sub_head_on_loss,
    and its pick with --batchnorm_track off on fixed pairs at R ranks
    against one rank (``_multigpu_pick``: the same sub-head on every rank,
    the losses within MULTIGPU_PICK_REL); one step of model
    698's finetune from the semisup phase's f32 model-650 run; each rank's
    device time a head-A step and its all-reduce time by torch.profiler.
    Returns {kernel: launches} of the seg runs summed over ranks."""
    import torch
    from iic_tpu_torch.parallel.mesh import spawn

    n_ranks = min(torch.cuda.device_count(), MULTIGPU_MAX)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    _log(f"multigpu: {torch.cuda.device_count()} cards visible, {n_ranks} "
         f"rank(s) over NCCL; {smi}")
    if n_ranks == 1:
        _log("multigpu: one card: world size 1 through the process group; "
             "no cross-card check ran")
    out_root = os.path.join(root, "multigpu_runs")
    # rank 0 shares card 0 with this process: hand back its cached blocks
    torch.cuda.empty_cache()
    results = spawn(_multigpu_rank, n_ranks,
                    args=(root, out_root, n_ranks), device_type="cuda",
                    timeout=MULTIGPU_TIMEOUT_S)
    launches = _report_sharded(results, n_ranks, smi)
    for res in results:
        r = res["rank"]
        ft = res["finetune"]
        _log(f"multigpu rank {r} model 698 step: loss {ft['loss']:.5f} on "
             f"{ft['rows']} rows, launches {ft['launches']}")
        _no_launches(f"rank {r} model 698 step", ft["launches"])
        wall, busy, reduce_ms, names, top = res["profile"]
        _log(f"multigpu rank {r} model 555 head A f32 ({N // n_ranks} pairs "
             f"a rank): {wall:.2f} ms a step wall, device busy {busy:.2f} "
             f"ms a step, all-reduce (NCCL kernels) {reduce_ms:.3f} ms a "
             f"step {names or '(no NCCL kernel)'}; {smi}; top kernels "
             f"(ms a step) {top}")
    errs, floor = results[0]["parity"]
    _log(f"multigpu parity, {n_ranks} rank(s) against 1 on the whole batch "
         f"(share of each kind's largest entry): {errs}"
         + (" (trivial: one rank)" if n_ranks == 1 else "")
         + f"; 1 rank on the batch reversed: {floor}")
    for kind, err in errs.items():
        bound = max(MULTIGPU_PARITY_MULT * floor[kind], MULTIGPU_PARITY_FLOOR)
        if err > bound:
            raise AssertionError(f"multigpu parity: {kind} {err} beyond "
                                 f"{bound}")
    return launches


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
    # the rest of clustering's paper workloads: K3's launches of the
    # two-head runs (and K1's and K2's of the profiled seg epoch) add to
    # the table's; then the paper-parity harness's rows, whose children's
    # K1, K2 and K3 launches add to it too
    with tempfile.TemporaryDirectory() as data_root:
        for tag, write, phase in (
                ("mnist", _write_mnist, phase_mnist),
                ("stl", _write_stl10, phase_stl),
                ("data paths", None, phase_data_paths),
                ("semisup", None, phase_semisup),
                ("digits guard", None, lambda _: phase_digits_guard()),
                ("semisup guard", None, lambda _: phase_semisup_guard()),
                ("baselines", None, phase_baselines),
                ("parity", _write_parity_trees, phase_parity)):
            t0 = time.perf_counter()
            if write is not None:
                write(data_root)
                _log(f"{tag} fixture tree written in "
                     f"{time.perf_counter() - t0:.1f} s")
            _clocks(f"phase {tag}")
            t1 = time.perf_counter()
            run = phase(data_root)
            _log(f"phase {tag}: {time.perf_counter() - t1:.1f} s")
            for k, v in run.items():
                launches[k] += v
        # data parallelism: K1 and K2 launches of its seg runs (every rank)
        # add to the table's
        _clocks("phase multigpu")
        t0 = time.perf_counter()
        for k, v in phase_multigpu(data_root).items():
            launches[k] += v
        _log(f"phase multigpu: {time.perf_counter() - t0:.1f} s")
    # the serving and analysis path: no kernel, nothing added to the table
    _clocks("phase serve")
    t0 = time.perf_counter()
    phase_serve()
    _log(f"phase serve: {time.perf_counter() - t0:.1f} s")
    _clocks("the tool runs")
    launches.update({k: v for k, v in phase_tool().items()
                     if k in TOOL_KERNELS})
    # the measurement tools: their K1, K2 and K3 launches add to the
    # table's
    _clocks("phase measure tools")
    t0 = time.perf_counter()
    for k, v in phase_measure_tools(args.trace_dir).items():
        launches[k] += v
    _log(f"phase measure tools: {time.perf_counter() - t0:.1f} s")
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
