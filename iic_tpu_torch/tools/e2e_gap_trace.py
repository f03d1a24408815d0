"""Where the wall of a training run goes beyond the device-step-only rate
(``tools/e2e_gap_trace.py`` of the JAX package).

    python -m iic_tpu_torch.tools.e2e_gap_trace [--passes 4] \\
        [--depths 2 ...] [--reps 3] [--profile_dir DIR] [--device cpu]

Model 555's training at ``bench.py``'s headline config (``bench_config``, a
copy of ``bench.py``'s ``_config()``: batch 120 at 128^2, k 15 / 3, T=21,
sobel + rgb, bf16, ``SyntheticSeg3x146x480``), heads A and B alternating
whole passes behind the prefetch thread, each batch's host-side time split
into:

  wait_data  blocked in ``next()`` on the prefetch thread (host prep or
             upload not ready);
  dispatch   inside the step call: the host's time to queue the step's
             kernels, and the whole step wherever the step (or a wrapper
             under it) waits for the card;
  fetch      the final ``float(loss)``: the drain of the queued work.

and the rest of the loop body ("other": the bookkeeping between steps and
the ``next()`` that ends the stream). Each part is timed on its own
intervals, which tile the run's wall. It prints that split against the
device-step-only rate of one resident batch, for each prefetch depth,
then ``--reps`` steady-state runs of one prefetch stream across the warm
and timed passes. On the prefetch thread, the host prep that
``SegTrainPipeline.epoch`` runs (``_native_batch`` when the native prep is
built, else ``_numpy_batch``; the output names it) and ``pipe.upload``
(``DeviceUpload``: pinning and queueing the copy on its own stream) are
timed where they run. ``--profile_dir`` writes a torch.profiler trace of
the first depth's run (``gap_trace.json``, chrome format).

Every time is the host's clock; the barriers are value fetches
(``float(loss)``), which wait for the card. On cuda:0 by default; no GPU
is an error unless ``--device cpu`` is given.
"""

import argparse
import copy
import os
import time
from types import SimpleNamespace

import torch

from iic_tpu_torch import models
from iic_tpu_torch.data.prefetch import prefetch_epochs
from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
from iic_tpu_torch.device import card_line, resolve_device
from iic_tpu_torch.parallel.train_step import make_seg_train_step

# bench.py's constants, copied: the port reads nothing of bench.py
BATCH_SZ = 120
INPUT_SZ = 128
RAW_SZ = 146  # host crop 146 -> 128 per image, like the pre-scaled COCO path
HEADS = ("A", "B")  # the reference epoch: one full A pass, then one B pass
LAMBS = {"A": 1.0, "B": 1.5}  # commands.txt:74 --lamb_A 1.0 --lamb_B 1.5
STEP_ONLY_STEPS = 20


def bench_config():
    """``bench.py``'s ``_config()``, field for field."""
    return SimpleNamespace(
        dataset=f"SyntheticSeg3x{RAW_SZ}x480", dataset_root="", mode="IID",
        batch_sz=BATCH_SZ, num_dataloaders=1, dataloader_batch_sz=BATCH_SZ,
        input_sz=INPUT_SZ, gt_k=3, output_k=3, output_k_A=15, output_k_B=3,
        num_sub_heads=1, use_coarse_labels=False,
        pre_scale_all=False, pre_scale_factor=0.33,
        use_random_scale=False, scale_min=0.6, scale_max=1.4,
        jitter_brightness=0.4, jitter_contrast=0.4, jitter_saturation=0.4,
        jitter_hue=0.125, flip_p=0.5, use_random_affine=False,
        sobel=True, no_sobel=False, include_rgb=True, using_IR=False,
        in_channels=5, eval_batch_sz=None, batchnorm_track=True,
        half_T_side_dense=10, half_T_side_sparse_min=0,
        half_T_side_sparse_max=0, model_dtype="bfloat16")


def _timed(fn, times):
    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times.append(time.perf_counter() - t0)
        return out
    return timed


class ProducerTimes:
    """Seconds of each host prep and upload of ``pipe``, timed where they
    run (the prefetch thread): wraps the prep that ``pipe.epoch`` calls
    and ``pipe.upload`` on the instance."""

    def __init__(self, pipe):
        self.prep_name = ("_native_batch" if pipe._native is not None
                          else "_numpy_batch")
        self.prep, self.upload = [], []
        setattr(pipe, self.prep_name,
                _timed(getattr(pipe, self.prep_name), self.prep))
        pipe.upload = _timed(pipe.upload, self.upload)

    def clear(self):
        self.prep.clear()
        self.upload.clear()

    def summary(self):
        if self.prep:
            print(f"  producer prep ({self.prep_name}) ms/batch: "
                  + " ".join(f"{1000 * t:.0f}" for t in self.prep))
        if self.upload:
            print(f"  producer upload: {len(self.upload)} uploads, total "
                  f"{sum(self.upload):5.2f}s, max {max(self.upload):.3f}s")


class GapTrace:
    """Model 555's net, its initial weights, the train pipeline with its
    producer timed, and the two heads' steps."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        torch.manual_seed(0)
        self.net = models.build("SegmentationNet10aTwoHead", cfg).to(device)
        self.init = copy.deepcopy(self.net.state_dict())
        self.pipe = SegTrainPipeline(cfg, ["train"], device=device)
        self.producer = ProducerTimes(self.pipe)

    def fresh_steps(self):
        """{head: step} from the initial weights and a new Adam (lr 1e-4):
        the TPU tool's ``create_train_state(variables, tx)``."""
        self.net.load_state_dict(self.init)
        opt = torch.optim.Adam(self.net.parameters(), lr=1e-4)
        return {h: make_seg_train_step(
            self.net, opt, lamb=LAMBS[h], head=h,
            half_T_side_dense=self.cfg.half_T_side_dense,
            half_T_side_sparse_min=0, half_T_side_sparse_max=0, sobel=True,
            include_rgb=True, use_uncollapsed_loss=True,
            augment=self.pipe.augment) for h in HEADS}

    def run(self, first_pass, n_passes, depth, instrument=False):
        """Passes ``first_pass`` .. + ``n_passes`` through a fresh prefetch
        stream at ``depth``, from fresh weights. Returns {"depth", "wall",
        "n_pairs", "wait_data", "dispatch", "fetch", "other", "waits",
        "prep", "upload"} (seconds; prep and upload a batch each); prints
        the split when ``instrument``."""
        steps = self.fresh_steps()
        self.producer.clear()
        n_pairs, waits, dispatch, other = 0, [], 0.0, 0.0
        it = iter(prefetch_epochs(
            self.pipe, range(first_pass, first_pass + n_passes),
            depth=depth))
        t_start = t2 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            other += t0 - t2
            try:
                e_i, imgs, masks, gen = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            loss, _ = steps[HEADS[e_i % 2]]((imgs, masks), gen)
            t2 = time.perf_counter()
            waits.append(t1 - t0)
            dispatch += t2 - t1
            n_pairs += int(imgs.shape[0])
        t3 = time.perf_counter()
        other += t3 - t0  # the next() that ended the stream
        float(loss)
        t4 = time.perf_counter()
        rec = {"depth": depth, "wall": t4 - t_start, "n_pairs": n_pairs,
               "wait_data": sum(waits), "dispatch": dispatch,
               "fetch": t4 - t3, "other": other, "waits": waits,
               "prep": list(self.producer.prep),
               "upload": list(self.producer.upload)}
        if instrument:
            print(f"depth={depth}: wall {rec['wall']:6.2f}s  rate "
                  f"{n_pairs / rec['wall']:6.1f} pairs/s | wait_data "
                  f"{rec['wait_data']:5.2f}s  dispatch {dispatch:5.2f}s  "
                  f"final fetch/drain {rec['fetch']:5.2f}s  "
                  f"(loop body other {rec['other']:5.2f}s)")
            print("  per-batch wait_data (s): "
                  + " ".join(f"{w:.3f}" for w in waits))
            self.producer.summary()
        return rec

    def run_continuous(self, n_warm, n_timed, depth, instrument=False):
        """Steady state: ONE prefetch stream across the warm and timed
        passes (like a real training run); a value-fetch barrier after
        the warm passes, then the timer. The prefetch thread is already
        ahead when the timer starts, the state the reference's mid-epoch
        log timestamps measure. Returns {"depth", "wall", "n_pairs",
        "wait_data", "waits"}."""
        steps = self.fresh_steps()
        self.producer.clear()
        n_pairs, waits, loss, t_start = 0, [], None, None
        it = iter(prefetch_epochs(self.pipe, range(n_warm + n_timed),
                                  depth=depth))
        while True:
            t0 = time.perf_counter()
            try:
                e_i, imgs, masks, gen = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            if e_i == n_warm and t_start is None:
                float(loss)  # barrier: the warm work fully drained
                t_start = time.perf_counter()
                t0 = t1 = t_start  # this batch's wait was warm time
            loss, _ = steps[HEADS[e_i % 2]]((imgs, masks), gen)
            if t_start is not None:
                waits.append(t1 - t0 if t1 > t0 else 0.0)
                n_pairs += int(imgs.shape[0])
        float(loss)
        wall = time.perf_counter() - t_start
        if instrument:
            print(f"continuous depth={depth}: wall {wall:6.2f}s  rate "
                  f"{n_pairs / wall:6.1f} pairs/s over {n_pairs} pairs | "
                  f"wait_data {sum(waits):5.2f}s")
            print("  per-batch wait_data (s): "
                  + " ".join(f"{w:.3f}" for w in waits))
            self.producer.summary()
        return {"depth": depth, "wall": wall, "n_pairs": n_pairs,
                "wait_data": sum(waits), "waits": waits}

    def device_step_rates(self):
        """Pairs/s of each head's step on one resident batch (the same
        measurement as bench.py's): one warm step, then
        ``STEP_ONLY_STEPS`` between value fetches. Returns {"A", "B",
        "mix"}, printed."""
        steps = self.fresh_steps()
        epoch = self.pipe.epoch(0)
        imgs, masks, gen = next(epoch)
        epoch.close()
        rates = {}
        for h in HEADS:
            loss, _ = steps[h]((imgs, masks), gen)
            float(loss)
            t0 = time.perf_counter()
            for _ in range(STEP_ONLY_STEPS):
                loss, _ = steps[h]((imgs, masks), gen)
            float(loss)
            rates[h] = (STEP_ONLY_STEPS * int(imgs.shape[0])
                        / (time.perf_counter() - t0))
        rates["mix"] = 2.0 / (1.0 / rates["A"] + 1.0 / rates["B"])
        print(f"device-step-only: A {rates['A']:.1f}  B {rates['B']:.1f}  "
              f"mix {rates['mix']:.1f} pairs/s "
              f"(= {2 * self.pipe.total / rates['mix']:.2f}s per A+B pass "
              f"pair)")
        return rates


def profiled(trace_dir, device, fn):
    """``fn()`` under torch.profiler (the host, and the card's kernels on
    CUDA), the trace written to ``trace_dir``/gap_trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = fn()
    path = os.path.join(trace_dir, "gap_trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path}")
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--passes", type=int, default=4)
    parser.add_argument("--profile_dir", type=str, default="")
    parser.add_argument("--depths", type=int, nargs="+", default=[2])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="default cuda:0; cpu runs on the host")
    return parser.parse_args(argv)


def main(argv=None, device=None, cfg=None):
    """The TPU tool's runs at ``cfg`` (``bench_config()`` by default).
    Returns {"device_step_only", "runs", "continuous"}: the records of
    ``device_step_rates``, ``run`` at each depth and ``run_continuous``."""
    args = parse_args(argv)
    device = resolve_device(device or args.device)
    print(card_line(device))
    trace = GapTrace(cfg or bench_config(), device)
    print(f"producer: host prep SegTrainPipeline.{trace.producer.prep_name}"
          f", upload DeviceUpload, timed on the prefetch thread")

    trace.run(0, 2, 2)  # warm up
    rates = trace.device_step_rates()
    runs = []
    for depth in args.depths:
        def one(depth=depth):
            return trace.run(2, args.passes, depth, instrument=True)
        runs.append(profiled(args.profile_dir, device, one)
                    if args.profile_dir and depth == args.depths[0]
                    else one())
    # steady-state (mid-stream) measurement, repeated for variance
    continuous = [trace.run_continuous(2, args.passes, args.depths[-1],
                                       instrument=True)
                  for _ in range(args.reps)]
    return {"device_step_only": rates, "runs": runs,
            "continuous": continuous}


if __name__ == "__main__":
    main()
