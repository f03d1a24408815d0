"""K3, the fused clustering IID-loss kernel (``--fused_loss``), against the
plain loss at the paper's MNIST shape (``tools/fused_loss_bench.py`` of the
JAX package; reference examples/commands.txt:30: ClusterNet6cTwoHead,
batch_sz 700, k_B=10, k_A=50, 5 sub-heads, input 24).

    python -m iic_tpu_torch.tools.fused_loss_bench [--device cpu]

On cuda:0 by default; no GPU is an error unless ``--device cpu`` is given,
and then K3's wrapper takes its plain version. Two measurements, each with
``impl`` "xla" (the plain torch loss, the JAX package's name for it) and
"fused" (K3; the TPU tool's "pallas"):

  1. loss-only: the 5-sub-head IID loss, forward and backward
     (``torch.autograd.grad`` of the mean loss), at (5, 700, k).
  2. full train step: model 685's step (augment, greyscale double forward,
     loss, Adam) by ``make_cluster_train_step(..., loss_impl=impl)``.

Every timing barrier is a value fetch (``float(loss)``), as in the TPU tool:
the times are the host's clock between fetches, so a call that costs the
host more than the card reads as the host's cost. K3 is such a call (a few
µs of device work under tens of µs of wrapper), so the loss-only run also
prints each impl's device ms a call from torch.profiler over the same
calls (all kernels, and K3's kernel alone), on a line of its own.
"""

import copy
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from iic_tpu_torch import models
from iic_tpu_torch.device import card_line, pop_device, resolve_device
from iic_tpu_torch.ops.iid_loss import IID_loss
from iic_tpu_torch.parallel.train_step import make_cluster_train_step

IMPLS = ("xla", "fused")
K3_KERNEL = "iid_loss"  # K3's kernels' names start with it


def time_fn(fn, *args, warmup=3, iters=20):
    """Mean seconds a call of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, between value fetches of the last output's loss."""
    for _ in range(warmup):
        _fetch(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fetch(out)
    return (time.perf_counter() - t0) / iters


def _fetch(out):
    return float(out[0])


def loss_inputs(bn=700, k=10, sub=5, device=None):
    """(z, zt), (sub, bn, k) softmax rows of normals from
    ``np.random.default_rng(0)``, z drawn first, as the TPU tool draws
    them, on ``device`` (``resolve_device``: cuda:0 unless given)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    return tuple(
        torch.softmax(torch.from_numpy(
            rng.normal(size=(sub, bn, k)).astype(np.float32)), -1).to(device)
        for _ in range(2))


def loss_and_grads(impl, z, zt):
    """(mean loss over the sub-heads, (dz, dzt)): the TPU tool's
    ``value_and_grad`` of the vmapped loss."""
    z = z.detach().requires_grad_()
    zt = zt.detach().requires_grad_()
    losses, _ = IID_loss(z, zt, lamb=1.0, impl=impl)
    loss = losses.mean()
    return loss.detach(), torch.autograd.grad(loss, (z, zt))


def device_ms(fn, *args, calls=20):
    """(device ms a call of all kernels, of K3's kernels) by torch.profiler
    over ``calls`` calls; None off CUDA."""
    if args[0].device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    _fetch(fn(*args))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    k3 = sum(e.self_device_time_total for e in events
             if K3_KERNEL in e.key)
    return total / calls / 1e3, k3 / calls / 1e3


def loss_only(bn=700, k=10, sub=5, device=None):
    """{impl: {"ms", "loss", "device_ms", "k3_device_ms"}}, printed; on
    ``device`` (cuda:0 unless given)."""
    z, zt = loss_inputs(bn, k, sub, device)
    out = {}
    for impl in IMPLS:
        def f(a, b, impl=impl):
            return loss_and_grads(impl, a, b)
        ms = time_fn(f, z, zt) * 1e3
        val = float(f(z, zt)[0])
        dev = device_ms(f, z, zt)
        out[impl] = {"ms": ms, "loss": val, "device_ms": dev and dev[0],
                     "k3_device_ms": dev and dev[1]}
        print(f"loss-only fwd+bwd ({bn}x{k}x{sub} sub-heads) {impl}: "
              f"{ms:.3f} ms  (loss {val:.5f})")
        if dev is None:
            print(f"  {impl}: host ms a call {ms:.4f}; device ms not "
                  "measured (no card)")
        else:
            print(f"  {impl}: host ms a call {ms:.4f}; device ms a call "
                  f"{dev[0]:.4f} (torch.profiler, 20 calls), K3's kernel "
                  f"{dev[1]:.4f}")
    return out


def full_step_config(batch=700, k=10, sub=5):
    """The TPU tool's ``SimpleNamespace`` config of model 685's step, field
    for field."""
    return SimpleNamespace(
        dataset=f"Synthetic10x28x1x{batch}", dataset_root="",
        mode="IID", batch_sz=batch, num_dataloaders=5, input_sz=24,
        gt_k=10, output_k_A=50, output_k_B=k, num_sub_heads=sub,
        crop_orig=True, rand_crop_sz=20, include_rgb=False,
        mix_train=False, batchnorm_track=True, greyscale=True,
        tf1_crop="random", tf1_crop_sz=20, tf2_crop="random",
        tf2_crop_szs=(16, 20, 24), tf3_crop_diff=False, tf3_crop_sz=20,
        rot_val=25.0, always_rot=False, no_flip=True, no_jitter=False,
        crop_other=True)


def full_step(batch=700, k=10, sub=5, device=None, iters=30):
    """{impl: {"ms", "loss"}}: ``iters`` steps after 3 warm-up steps, each
    impl from the same initial weights (seed 0) and Adam state, on the
    same base batch and draws (generator seed 1) every step, printed; on
    ``device`` (``resolve_device``: cuda:0 unless given)."""
    from iic_tpu_torch.data.pipeline import ClusterTrainPipeline

    device = resolve_device(device)
    cfg = full_step_config(batch, k, sub)
    pipe = ClusterTrainPipeline(cfg, [True], device=device)
    torch.manual_seed(0)
    # a torch conv needs its input's channels, which flax reads off the
    # input: 1 (greyscale, no sobel)
    net = models.build("ClusterNet6cTwoHead", SimpleNamespace(
        **vars(cfg), in_channels=1)).to(device)
    state0 = copy.deepcopy(net.state_dict())
    base, = pipe.upload(np.ascontiguousarray(
        pipe.images[:cfg.batch_sz // cfg.num_dataloaders]))
    gen = torch.Generator(device=device)

    out = {}
    for impl in IMPLS:
        net.load_state_dict(state0)
        step = make_cluster_train_step(
            net, torch.optim.Adam(net.parameters(), lr=1e-3),
            pipe.augment_pair, lamb=1.0, head="B", sobel=False,
            loss_impl=impl)

        def run():
            return step(base, gen.manual_seed(1))
        for _ in range(3):
            float(run()[0])
        t0 = time.perf_counter()
        for _ in range(iters):
            loss, _ = run()
        loss = float(loss)
        ms = (time.perf_counter() - t0) / iters * 1e3
        out[impl] = {"ms": ms, "loss": loss}
        print(f"full train step (MNIST paper shape, head B) {impl}: "
              f"{ms:.2f} ms  (loss {loss:.5f})")
    return out


def main(argv=None, device=None):
    """Both measurements; returns {"loss_only": ..., "full_step": ...}."""
    argv, dev_arg = pop_device(sys.argv[1:] if argv is None else argv)
    if argv:
        raise ValueError(f"usage: [--device DEVICE], got {argv}")
    device = resolve_device(device or dev_arg)
    print(card_line(device))
    lo = loss_only(device=device)
    fs = full_step(device=device)
    print(f"\nsummary: loss-only fused/xla = "
          f"{lo['fused']['ms'] / lo['xla']['ms']:.2f}x, "
          f"full-step fused/xla = "
          f"{fs['fused']['ms'] / fs['xla']['ms']:.2f}x")
    return {"loss_only": lo, "full_step": fs}


if __name__ == "__main__":
    main()
