"""Experiments on the displacement-joint kernels (``tools/joint_kernel_exp.py``
of the JAX package), with X1-X9 ported.

    python -m iic_tpu_torch.tools.joint_kernel_exp [only] [n k h half_t] \\
        [--device cpu]

Defaults: n=120, k=15, h=w=128, half_t=10 (the segmentation path's head A),
on cuda:0; no GPU is an error unless ``--device cpu`` is given, and then
every kernel wrapper takes its plain version.

  (default)  E1: the backward (dx1 + dx2) as two ``F.conv2d`` with the
             (T, T) adjoint as filters, f32 and bf16 (the TPU tool's XLA
             convs, ``bwd_conv``), and as two K2 launches ("pallas-cur");
             E2: X2 in ``full`` mode; E0: K1 ("pallas-cur fwd"); then X2's
             ablations mm-only, copies-only and aligned-copies.
  ablate     X2 for rb in (16, 32, 64) x modes (full, mm-only, copies-only,
             rank3).
  mmprobe    X1 for rb in (16, 32) x forms (mk-nk, mk-kn).
  v3         X3 for rb in (16, 32) x flat (True, False), then K1 ("E0
             pallas-cur fwd").
  v4         X4 ("V4 slot-split").
  v5         X5 ("V5 2-unroll straight-line").
  v6         X6 for roll_build in (False, True). The TPU tool's
             ``roll_build=True`` fails off the TPU (``pltpu.roll`` with a
             negative shift) and prints FAILED there; the port computes
             what that code states, the joint of the same stacks, and
             reports it.
  kpad       X5 and X2 ``full`` on x1, x2 zero-padded from k to 16
             channels, the output sliced back to (k, k, T, T) ("v5+kpad16",
             "v2+kpad16").
  v8         for rb in (16, 32, 64): X7 ("V8 fwd") and the backward as two
             X8 launches ("V8 bwd", ``bwd_v8``).
  v7         X9 ("V7 fused bwd": dx1 and dx2 in one launch, each
             per-displacement partial rounded to bf16), then the backward
             as two K2 launches ("E1 pallas-cur bwd(dx1+dx2)").

Inputs are softmax maps from ``torch.randn`` under seed 0 on the device, and
a normal cotangent g (k, k, T, T). The TPU tool's reference is the FFT joint
and its vjp, which the port does not have (ROADMAP "Not ported"); the
reference here is the plain conv (``seg_joint.displacement_joint_dense`` and
``dgrad_plain``) in float64. Errors are max |got - ref| / max |ref|, and
max |P - plain| for the ablations that are exact; V7 also reports
mean |dx - ref| / mean |ref| against its own plain version in float64
(the per-displacement partials rounded to bf16 from float64), the
criterion that tells its rounding apart from X8's. Times are CUDA events
around 20 calls after one warm-up, as the TPU tool's ``time_fn`` (the host
clock with ``--device cpu``). As in the TPU tool, a variant that raises
prints a ``FAILED`` line. ``main`` also returns each variant's record.
"""

import sys
import time

import torch
import torch.nn.functional as F

from iic_tpu_torch.device import pop_device, resolve_device
from iic_tpu_torch.ops.kernels import joint_exp as jx
from iic_tpu_torch.ops.kernels import seg_joint as sj

DEFAULT_SIZE = (120, 15, 128, 10)
RUNS = ("ablate", "mmprobe", "v3", "v4", "v5", "v6", "kpad", "v8", "v7")
KPAD = 16  # the kpad run's channel count


def time_fn(fn, *args, iters=20, cuda=True):
    """Mean ms of ``fn(*args)`` over ``iters`` calls after one warm-up:
    CUDA events on the current stream, or the host clock when not
    ``cuda``."""
    fn(*args)
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref):
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def bwd_conv(x1, x2, g, half_t):
    """dx1, dx2 as convs with the adjoint as (T, T) filters:
    dx1 = conv(x2, g flipped in (u, v)), dx2 = conv(x1, g with i, j
    swapped), both padded by half_t."""
    with sj.full_f32():
        dx1 = F.conv2d(x2, g.flip(2, 3), padding=half_t)
        dx2 = F.conv2d(x1, g.transpose(0, 1), padding=half_t)
    return dx1, dx2


def bwd_conv_bf16(x1, x2, g, half_t):
    dx1, dx2 = bwd_conv(x1.to(torch.bfloat16), x2.to(torch.bfloat16),
                        g.to(torch.bfloat16), half_t)
    return dx1.float(), dx2.float()


def bwd_k2(x1, x2, g, half_t):
    """dx1, dx2 through K2 on the two reordered adjoints (``_joint_bwd``)."""
    g2d, g2d_swap = sj.adjoints(g)
    return (sj.joint_dgrad(g2d, x2, half_t),
            sj.joint_dgrad(g2d_swap, x1, half_t))


def _parse(argv):
    argv, device = pop_device(argv)
    only = None
    if argv and not argv[0].isdigit():
        only, argv = argv[0], argv[1:]
    size = tuple(int(a) for a in argv) or DEFAULT_SIZE
    if len(size) != 4:
        raise ValueError(f"expected n k h half_t, got {size}")
    return only, size, device


def _inputs(n, k, h, half_t, device):
    gen = torch.Generator(device=device).manual_seed(0)
    t = 2 * half_t + 1

    def maps():
        z = torch.randn((n, k, h, h), device=device, generator=gen)
        return torch.softmax(z, dim=1).contiguous()

    x1, x2 = maps(), maps()
    g = torch.randn((k, k, t, t), device=device, generator=gen)
    return x1, x2, g


def _variant(records, name, fn, args, check, cuda):
    """Runs one variant: its output, its errors {label: value} by ``check``,
    its time. Appends its record {"name", "ms", "errs", "failed"} to
    ``records`` and prints it; as in the TPU tool, a variant that raises is
    reported FAILED."""
    try:
        errs = check(fn(*args))
        rec = {"name": name, "ms": time_fn(fn, *args, cuda=cuda),
               "errs": errs, "failed": None}
    except Exception as e:  # noqa: BLE001 -- the TPU tool's report
        rec = {"name": name, "ms": None, "errs": {},
               "failed": f"{type(e).__name__}: {str(e)[:160]}"}
    if rec["failed"]:
        print(f"{name:28s} FAILED: {rec['failed']}")
    else:
        print(f"{name:28s} {rec['ms']:8.2f} ms  " + "  ".join(
            f"{label} {v:.2e}" for label, v in rec["errs"].items()))
    records.append(rec)


def mean_rel_err(got, ref):
    """mean |got - ref| / mean |ref|."""
    ref = ref.double()
    return float((got.double() - ref).abs().mean() / ref.abs().mean())


def _exact(got, ref):
    return {"max |P - plain|": float((got - ref).abs().max())}


def _rel(ref):
    return lambda got: {"rel err": rel_err(got, ref)}


def run_mmprobe(n, k, h, half_t, device):
    records = []
    for rb in (16, 32):
        ref = jx.mm_probe_plain(n, k, h, half_t, rb, device)
        for form in jx.FORMS:
            _variant(records, f"MM probe rb={rb:2d} {form}", jx.mm_probe,
                     (n, k, h, half_t, rb, form, device),
                     lambda out: _exact(out, ref), device.type == "cuda")
    return records


def _ablation_check(x1, x2, half_t, mode, rb):
    """How far an ablation's output is from its plain version: relative
    for aligned-copies (against the plain version in float64), absolute for
    the exact ones (mm-only's count of terms, copies-only's checksum)."""
    ref = jx.joint_fwd_v2_plain(x1.double(), x2.double(), half_t, mode, rb)
    if mode == "aligned-copies":
        return lambda P: {"rel err vs plain": rel_err(P, ref)}
    return lambda P: _exact(P, ref)


def run_ablate(x1, x2, half_t, P_ref):
    cuda = x1.device.type == "cuda"
    records = []
    for rb in (16, 32, 64):
        for mode in ("full", "mm-only", "copies-only", "rank3"):
            check = (_rel(P_ref) if mode in ("full", "rank3")
                     else _ablation_check(x1, x2, half_t, mode, rb))
            _variant(records, f"E2 rb={rb:2d} {mode}", jx.joint_fwd_v2,
                     (x1, x2, half_t, mode, rb), check, cuda)
    return records


def _grad_refs(x1, x2, g, half_t):
    """dx1, dx2 of the joint in float64: K2's plain version on the two
    reordered adjoints."""
    g2d, g2d_swap = sj.adjoints(g)
    return (sj.dgrad_plain(g2d.double(), x2.double(), half_t),
            sj.dgrad_plain(g2d_swap.double(), x1.double(), half_t))


def _grad_errs(dx1_ref, dx2_ref):
    return lambda dx: {"dx1 rel err": rel_err(dx[0], dx1_ref),
                       "dx2 rel err": rel_err(dx[1], dx2_ref)}


def run_default(x1, x2, g, half_t, P_ref):
    cuda = x1.device.type == "cuda"
    records = []
    check = _grad_errs(*_grad_refs(x1, x2, g, half_t))
    for name, fn in (("conv-f32", bwd_conv), ("conv-bf16", bwd_conv_bf16),
                     ("pallas-cur", bwd_k2)):
        _variant(records, f"E1 {name} bwd(dx1+dx2)", fn, (x1, x2, g, half_t),
                 check, cuda)
    del check
    _variant(records, "E2 bf16 fwd (X2)", jx.joint_fwd_v2, (x1, x2, half_t),
             _rel(P_ref), cuda)
    _variant(records, "E0 pallas-cur fwd", sj.joint_fwd, (x1, x2, half_t),
             _rel(P_ref), cuda)
    for mode in ("mm-only", "copies-only", "aligned-copies"):
        _variant(records, f"E2 ablation {mode}", jx.joint_fwd_v2,
                 (x1, x2, half_t, mode),
                 _ablation_check(x1, x2, half_t, mode, 16), cuda)
    return records


def kpad16(x1, x2, half_t, fn):
    """``fn``'s joint of x1, x2 zero-padded from k to 16 channels, sliced
    back to (k, k, T, T) (the TPU tool's kpad ``padded``)."""
    k = x1.shape[1]
    if k > KPAD:
        raise ValueError(f"kpad pads k={k} up to {KPAD} channels")
    pad = (0, 0, 0, 0, 0, KPAD - k)
    return fn(F.pad(x1, pad), F.pad(x2, pad), half_t)[:k, :k]


def run_pipelined(only, x1, x2, half_t, P_ref):
    """The v3, v4, v5, v6 and kpad runs: X3-X6 (and K1, X2) against the
    float64 joint."""
    cuda = x1.device.type == "cuda"
    variants = {
        "v3": [(f"V3 rb={rb:2d} flat={flat}", jx.joint_fwd_v3, (rb, flat))
               for rb in (16, 32) for flat in (True, False)]
        + [("E0 pallas-cur fwd", sj.joint_fwd, ())],
        "v4": [("V4 slot-split", jx.joint_fwd_v4, ())],
        "v5": [("V5 2-unroll straight-line", jx.joint_fwd_v5, ())],
        "v6": [(f"V6 roll={roll}", jx.joint_fwd_v6, (roll,))
               for roll in (False, True)],
        "kpad": [(f"v{v}+kpad16", kpad16, (fn,))
                 for v, fn in ((5, jx.joint_fwd_v5), (2, jx.joint_fwd_v2))],
    }[only]
    records = []
    for name, fn, extra in variants:
        _variant(records, name, fn, (x1, x2, half_t, *extra), _rel(P_ref),
                 cuda)
    return records


def run_v8(x1, x2, g, half_t, P_ref):
    cuda = x1.device.type == "cuda"
    records = []
    check = _grad_errs(*_grad_refs(x1, x2, g, half_t))
    for rb in (16, 32, 64):
        _variant(records, f"V8 fwd rb={rb:2d}", jx.joint_fwd_v8,
                 (x1, x2, half_t, rb), _rel(P_ref), cuda)
        _variant(records, f"V8 bwd rb={rb:2d}", jx.bwd_v8,
                 (g, x1, x2, half_t, rb), check, cuda)
    return records


def run_v7(x1, x2, g, half_t):
    cuda = x1.device.type == "cuda"
    records = []
    dx1_ref, dx2_ref = _grad_refs(x1, x2, g, half_t)
    r1, r2 = jx.dgrad_fused_v7_plain(g.double(), x1.double(), x2.double(),
                                     half_t)

    def check_v7(dx):
        return {"dx1 rel err": rel_err(dx[0], dx1_ref),
                "dx2 rel err": rel_err(dx[1], dx2_ref),
                "dx1 mean err vs v7 plain": mean_rel_err(dx[0], r1),
                "dx2 mean err vs v7 plain": mean_rel_err(dx[1], r2)}

    _variant(records, "V7 fused bwd", jx.dgrad_fused_v7, (g, x1, x2, half_t),
             check_v7, cuda)
    del r1, r2
    _variant(records, "E1 pallas-cur bwd(dx1+dx2)", bwd_k2,
             (x1, x2, g, half_t), _grad_errs(dx1_ref, dx2_ref), cuda)
    return records


def main(argv=None, device=None):
    """Runs ``only`` (default or one of ``RUNS``) and returns its records,
    one per variant: {"name", "ms", "errs": {label: value}, "failed"}."""
    only, (n, k, h, half_t), dev_arg = _parse(
        sys.argv[1:] if argv is None else argv)
    if only not in (None, *RUNS):
        raise ValueError(f"unknown run {only!r}")
    device = resolve_device(device or dev_arg)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"joint_kernel_exp {only or 'default'}: n={n} k={k} h=w={h} "
          f"half_t={half_t} on {name}")

    if only == "mmprobe":
        return run_mmprobe(n, k, h, half_t, device)
    x1, x2, g = _inputs(n, k, h, half_t, device)
    if only == "v7":
        return run_v7(x1, x2, g, half_t)
    P_ref = sj.displacement_joint_dense(x1.double(), x2.double(), half_t)
    if only == "ablate":
        return run_ablate(x1, x2, half_t, P_ref)
    if only == "v8":
        return run_v8(x1, x2, g, half_t, P_ref)
    if only is not None:
        return run_pipelined(only, x1, x2, half_t, P_ref)
    return run_default(x1, x2, g, half_t, P_ref)


if __name__ == "__main__":
    main()
