#!/usr/bin/env python3
"""Drives the PyTorch port (``iic_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--trace_dir DIR]

Phases, in order; any failure raises and the exit code is non-zero:
  1. require CUDA; print the device, its name and power limit; set TF32;
  2. build the CUDA kernels from ``iic_tpu_torch/csrc`` and print the time;
  3. hold K1 (joint forward) and K2 (input gradient, dx1 and dx2) against
     their plain PyTorch versions at the main path's shapes (n=120, 128^2,
     T=21, k=15 and k=3), within the JAX package's own kernel contract
     (rtol 5e-3, atol 5e-3 * max); print errors and CUDA-event times, and
     both versions' errors against a float64 plain version;
  4. run the two-head segmentation CLI (COCO-Stuff-3 shape, model 555,
     on SyntheticSeg3x146x480) with --test_code; require finite losses, a
     filled eval history and at least 4 K1 and 8 K2 launches;
  5. profile steady head-A and head-B steps of the same path: step time,
     device busy share and device time by kernel (chrome traces go to
     --trace_dir when it is given);
  6. print the kernel table as one JSON line, then the result line.
"""

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time

N, HW, HALF_T = 120, 128, 10
KS = (15, 3)  # head A, head B
RTOL = 5e-3   # tests/test_pallas_kernels.py:95-96, :119-122
SOURCE = "iic_tpu_torch/csrc/seg_joint.cu"
REPLACES = {"seg_joint_fwd": "iic_tpu/ops/pallas/seg_joint_kernel.py:83",
            "seg_joint_dgrad": "iic_tpu/ops/pallas/seg_joint_kernel.py:191"}

CLI_ARGS = [
    "--mode", "IID", "--dataset", "SyntheticSeg3x146x480",
    "--dataset_root", "", "--arch", "SegmentationNet10aTwoHead",
    "--lamb_A", "1.0", "--lamb_B", "1.5", "--num_sub_heads", "1",
    "--batch_sz", "120", "--num_dataloaders", "1", "--output_k_A", "15",
    "--output_k_B", "3", "--gt_k", "3", "--input_sz", "128",
    "--half_T_side_sparse_min", "0", "--half_T_side_sparse_max", "0",
    "--half_T_side_dense", "10", "--include_rgb", "--use_uncollapsed_loss",
    "--batchnorm_track", "--test_code", "--num_epochs", "2"]


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


def phase_build():
    from iic_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.library("seg_joint")
    _log(f"build: seg_joint in {time.perf_counter() - t0:.2f} s "
         f"(nvcc {_build.BUILD_SECONDS['seg_joint']:.2f} s)")


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


def _compare(tag, got, ref):
    import torch
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = bool(torch.all((got - ref).abs() <= RTOL * scale + RTOL * ref.abs()))
    _log(f"  {tag}: max_abs_err {err:.3e} (atol {RTOL * scale:.3e}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{tag} disagrees with its plain version")
    return err


def phase_kernels():
    """K1 and K2 against their plain versions at the main path's shapes.
    Returns {kernel: {"max_abs_err", "ms", "plain_ms"}} (ms at head A's
    k=15; the k=3 numbers are printed)."""
    import torch
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {name: {"max_abs_err": 0.0} for name in REPLACES}
    for k in KS:
        t = 2 * HALF_T + 1

        def softmax_maps():
            z = torch.randn((N, k, HW, HW), device="cuda", generator=gen)
            return torch.softmax(z, dim=1).contiguous()

        x1, x2 = softmax_maps(), softmax_maps()
        g = torch.randn((k, k, t, t), device="cuda", generator=gen)
        g2d, g2d_swap = sj.adjoints(g)
        _log(f"k={k}: n={N}, {HW}x{HW}, T={t}")

        got = sj.joint_fwd(x1, x2, HALF_T)
        ref = sj.displacement_joint_dense(x1, x2, HALF_T)
        torch.cuda.synchronize()
        e_fwd = _compare("K1 joint", got, ref)
        got1 = sj.joint_dgrad(g2d, x2, HALF_T)
        ref1 = sj.dgrad_plain(g2d, x2, HALF_T)
        got2 = sj.joint_dgrad(g2d_swap, x1, HALF_T)
        ref2 = sj.dgrad_plain(g2d_swap, x1, HALF_T)
        torch.cuda.synchronize()
        e_bwd = max(_compare("K2 dx1", got1, ref1),
                    _compare("K2 dx2", got2, ref2))
        del got, ref, got1, ref1, got2, ref2
        _f64_errors(k, x1, x2, g2d)

        times = {
            "seg_joint_fwd": (
                _time_ms(lambda: sj.joint_fwd(x1, x2, HALF_T)),
                _time_ms(lambda: sj.displacement_joint_dense(x1, x2,
                                                             HALF_T))),
            "seg_joint_dgrad": (
                _time_ms(lambda: sj.joint_dgrad(g2d, x2, HALF_T)),
                _time_ms(lambda: sj.dgrad_plain(g2d, x2, HALF_T))),
        }
        for name, (ms, plain_ms) in times.items():
            _log(f"  {name} k={k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
                 f"ms (CUDA events, mean of 5)")
        stats["seg_joint_fwd"]["max_abs_err"] = max(
            stats["seg_joint_fwd"]["max_abs_err"], e_fwd)
        stats["seg_joint_dgrad"]["max_abs_err"] = max(
            stats["seg_joint_dgrad"]["max_abs_err"], e_bwd)
        if k == KS[0]:
            for name, (ms, plain_ms) in times.items():
                stats[name].update(ms=ms, plain_ms=plain_ms)
        del x1, x2
        torch.cuda.empty_cache()
    return stats


def phase_trainer():
    """The CLI slice in-process. Returns {kernel: launches in the run}."""
    import numpy as np
    from iic_tpu_torch.cli import segmentation_twohead
    from iic_tpu_torch.ops.kernels import seg_joint as sj

    with tempfile.TemporaryDirectory() as out_root:
        sj.reset_launch_counts()
        _, history = segmentation_twohead.main(
            CLI_ARGS + ["--out_root", out_root])
        launches = dict(sj.LAUNCHES)
    for head in ("A", "B"):
        losses = history[f"epoch_loss_head_{head}"]
        steps = history[f"step_seconds_head_{head}"]
        _log(f"head {head}: epoch loss {losses}, step seconds "
             f"{[round(s, 4) for s in steps]}")
        if not losses or not np.all(np.isfinite(losses)):
            raise AssertionError(f"head {head} loss not finite: {losses}")
    acc = history["eval"].epoch_acc
    _log(f"eval acc per epoch (pre-train first): {acc}")
    if len(acc) < 2 or not np.all(np.isfinite(acc)):
        raise AssertionError(f"eval history not filled: {acc}")
    _log(f"launches in the trainer run: {launches}")
    if launches["seg_joint_fwd"] < 4 or launches["seg_joint_dgrad"] < 8:
        raise AssertionError(f"main path missed the kernels: {launches}")
    return launches


def _f64_errors(k, x1, x2, g2d):
    """Max error over max |ref| of K1, K2 and their f32 plain versions
    against the plain version run in float64."""
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


def phase_profile(trace_dir, steps=3):
    """Steady head-A and head-B steps of the main path under
    torch.profiler: step time (host clock, synchronised), device busy share
    and device time by kernel. Launches here are not counted: the counts
    were read after the trainer run."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from iic_tpu_torch import models
    from iic_tpu_torch.cli._args import parse_seg_args
    from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
    from iic_tpu_torch.parallel.train_step import (make_optimizer,
                                                   make_seg_train_step)

    cfg = parse_seg_args(CLI_ARGS).finalize(twohead=True)
    torch.manual_seed(0)
    pipe = SegTrainPipeline(cfg, ["train"], seed=0, device="cuda")
    net = models.build(cfg.arch, cfg).cuda()
    opt = make_optimizer(net, cfg)
    batches = list(pipe.epoch(1))
    for head, lamb in (("A", cfg.lamb_A), ("B", cfg.lamb_B)):
        step = make_seg_train_step(
            net, opt, lamb=lamb, head=head, half_T_side_dense=HALF_T,
            half_T_side_sparse_min=0, half_T_side_sparse_max=0, sobel=True,
            include_rgb=True, use_uncollapsed_loss=True, augment=pipe.augment)
        for imgs, masks, gen in batches[:2]:  # warm-up
            float(step((imgs, masks), gen)[0])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                imgs, masks, gen = batches[i % len(batches)]
                float(step((imgs, masks), gen)[0])
            wall = (time.perf_counter() - t0) / steps
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in events) / steps / 1e3
        _log(f"profile head {head}: {wall * 1e3:.2f} ms/step wall, device "
             f"busy {busy:.2f} ms/step ({100 * busy / (wall * 1e3):.1f}%), "
             f"mean of {steps} steps")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:12]:
            _log(f"    {e.self_device_time_total / steps / 1e3:9.3f} ms "
                 f"x{e.count // steps:<4d} {e.key[:90]}")
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir,
                                                  f"trace_head_{head}.json"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--trace_dir", default="",
                        help="write the profiled steps' chrome traces here")
    args = parser.parse_args(argv)

    name, _ = phase_device()
    phase_build()
    stats = phase_kernels()
    launches = phase_trainer()
    phase_profile(args.trace_dir)
    table = [{"name": k, "route": "cuda", "source": SOURCE,
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
