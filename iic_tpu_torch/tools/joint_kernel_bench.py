"""Microbenchmark of the displacement joint on the paper's shape
(``tools/joint_kernel_bench.py`` of the JAX package).

    python -m iic_tpu_torch.tools.joint_kernel_bench [n k h half_t] \\
        [--device cpu]

Defaults: n=120, k=15, h=w=128, half_t=10 (model 555's head A), on cuda:0;
no GPU is an error unless ``--device cpu`` is given, and then the kernel
wrappers take their plain versions.

Implementations, in the TPU tool's order:
  fft     not ported (ROADMAP "Not ported"): one line says so.
  pallas  K1 forward and two K2 launches backward, through
          ``seg_joint.displacement_joint_dense_kernel`` (``SegJoint``).
  conv    the plain version, ``seg_joint.displacement_joint_dense``: an f32
          ``F.conv2d`` with the activations as filters, TF32 off.

Each is timed, as in the TPU tool, on scalars: the forward of sum(P), and
forward + backward of the sum of both input gradients of sum(P**2)
(``torch.autograd.grad``). Times are CUDA events around 20 calls after one
warm-up (``joint_kernel_exp.time_fn``): the card's time for the calls, not
the host's; with ``--device cpu`` the host clock. The TPU tool's "max rel
err vs fft" is here max |P - ref| / max |ref| against the plain conv run
in float64 (as ``joint_kernel_exp``); the kernel is also held against
``seg_joint.joint_fwd_bf16_plain`` in float64, the function it computes on
the card (bf16 operands, f32 sums).
"""

import sys

import torch

from iic_tpu_torch.device import card_line, pop_device, resolve_device
from iic_tpu_torch.ops.kernels import seg_joint as sj
from iic_tpu_torch.tools.joint_kernel_exp import rel_err, time_fn

DEFAULT_SIZE = (120, 15, 128, 10)
ITERS = 20
# name -> the joint (x1, x2, half_t) -> P; None: not ported
IMPLS = {"fft": None,
         "pallas": sj.displacement_joint_dense_kernel,
         "conv": sj.displacement_joint_dense}


def inputs(n, k, h, device, seed=0):
    """Two softmax maps (n, k, h, h) over the channels, from ``torch.randn``
    under ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.softmax(torch.randn((n, k, h, h), device=device,
                                           generator=gen), dim=1)
                 for _ in range(2))


def fwd_sum(fn, half_t):
    """(x1, x2) -> sum(P): the forward timed."""
    return lambda a, b: fn(a, b, half_t).sum()


def grads(fn, x1, x2, half_t):
    """(dx1, dx2) of sum(P**2) by ``torch.autograd.grad``."""
    a = x1.detach().requires_grad_()
    b = x2.detach().requires_grad_()
    return torch.autograd.grad((fn(a, b, half_t) ** 2).sum(), (a, b))


def grad_sum(fn, half_t):
    """(x1, x2) -> the sum of both input gradients: forward + backward
    timed."""
    return lambda a, b: sum(d.sum() for d in grads(fn, a, b, half_t))


def outputs(fn, x1, x2, half_t):
    """(P, dx1, dx2) of one implementation: what the tool times."""
    with torch.no_grad():
        p = fn(x1, x2, half_t)
    return (p, *grads(fn, x1, x2, half_t))


def measure(x1, x2, half_t, iters=ITERS):
    """One record per implementation, in ``IMPLS``' order: {"name",
    "ported", "fwd_ms", "grad_ms", "err"} (err: P against the plain conv in
    float64), the kernel's with "err_bf16_f64" (against its bf16 function in
    float64) and "form" (K1's form at this k)."""
    cuda = x1.device.type == "cuda"
    ref = sj.displacement_joint_dense(x1.double(), x2.double(), half_t)
    records = []
    for name, fn in IMPLS.items():
        if fn is None:
            records.append({"name": name, "ported": False})
            continue
        with torch.no_grad():
            p = fn(x1, x2, half_t)
            rec = {"name": name, "ported": True, "err": rel_err(p, ref)}
            if name == "pallas":
                rec["err_bf16_f64"] = rel_err(p, sj.joint_fwd_bf16_plain(
                    x1.double(), x2.double(), half_t))
                rec["form"] = sj.k1_form(x1.shape[1], half_t)
            del p
            rec["fwd_ms"] = time_fn(fwd_sum(fn, half_t), x1, x2,
                                    iters=iters, cuda=cuda)
        rec["grad_ms"] = time_fn(grad_sum(fn, half_t), x1, x2, iters=iters,
                                 cuda=cuda)
        records.append(rec)
    return records


def report(records):
    for rec in records:
        if not rec["ported"]:
            print(f"{rec['name']:8s} not ported (ROADMAP 'Not ported'): "
                  "no time, no error")
            continue
        line = (f"{rec['name']:8s} fwd {rec['fwd_ms']:7.2f} ms   "
                f"grad(fwd+bwd) {rec['grad_ms']:7.2f} ms   max rel err vs "
                f"conv float64: {rec['err']:.2e}")
        if "err_bf16_f64" in rec:
            line += (f"   vs its bf16 function in float64 ({rec['form']}): "
                     f"{rec['err_bf16_f64']:.2e}")
        print(line)


def _parse(argv):
    argv, device = pop_device(argv)
    size = tuple(int(a) for a in argv) or DEFAULT_SIZE
    if len(size) != 4:
        raise ValueError(f"expected n k h half_t, got {size}")
    return size, device


def main(argv=None, device=None):
    """Measures and prints every implementation at ``n k h half_t``;
    returns the records of ``measure``."""
    (n, k, h, half_t), dev_arg = _parse(sys.argv[1:] if argv is None
                                        else argv)
    device = resolve_device(device or dev_arg)
    print(card_line(device))
    print(f"joint_kernel_bench: n={n} k={k} h=w={h} half_t={half_t}")
    x1, x2 = inputs(n, k, h, device)
    records = measure(x1, x2, half_t)
    report(records)
    return records


if __name__ == "__main__":
    main()
