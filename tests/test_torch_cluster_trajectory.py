"""The port's two-head clustering training held to the JAX package's over a
trajectory at lr 1e-3: ClusterNet5gTwoHead (ResNet-34) at 32^2 on the
sobel + rgb input (5 channels), k 20 / 10, 2 sub-heads,
``--batchnorm_track``, from the JAX trainer's own init
(``build_net_and_state``, seed 0) carried across by the flax bridge.

Data: ``Synthetic10x32x3x8`` (8 + 40 images, the trainer's train + test
partitions), 12 images a batch tiled over 2 dataloaders: 24 pairs a step.
The pairs are JAX's ``augment_pair`` (tf1 / tf2 of
``make_sobel_pair_transforms``) drawn from the pipelines' own keys (head
A's pipeline seeded 0, head B's 1; epochs 1 and 2) and given as numpy to
both steps, which build the 5-channel input themselves. Steps: head B's
pass, A's, B's, A's, 4 steps each, the trainer's order: 16 Adam steps.

The passes run in lockstep: at the start of each head pass the port takes
JAX's state at that point (params, BN running statistics, Adam's moments
and count, carried by the bridge), so every pass is held at the scale of
the first. Without it the bound could hold nothing after a few steps: at
lr 1e-3 Adam moves every weight by about lr whatever its gradient, so a
gradient within rounding of zero flips its step, and two f32 runs part
from one another by the second pass (a step's loss 0.29 apart by step 14).

Checked beside JAX, in each pass:

- every step's loss;
- every BatchNorm's running statistics at the end of the pass: the stem's
  (the first BN, after the 5-channel conv) and all of them together
  (relative L2 distance).

And after the last pass, the final weights' eval (``cluster_eval``: tf3,
eval-mode BN on the running statistics, the best sub-head, Hungarian
matching): the per-sub-head accuracies and the eval-mode IID loss of head
B on the first pair; and the port's eval of JAX's final weights gives
JAX's accuracies exactly and its loss within 1e-5.

The bound is the port's own f32 distance from its float64 run on the same
batches from the same (JAX's) pass starts (the float64 twin of
``test_torch_baseline_train.py``), the largest over runs on 1, 2, 4 and 8
torch threads, each with oneDNN's convs and without (the summation order
moves the f32 rounding), measured by ``PYTHONPATH=. python
tests/test_torch_cluster_trajectory.py`` and written below, times a
factor. The losses (the running maximum over a pass's steps) and the
final eval are held to LOSS_FACTOR = 30 times it: JAX's f32 on the CPU
sat at up to 7.5x the constants (step 0, a forward from equal weights:
1.1e-7 apart), 4.4x after it. The running statistics are held to
BN_FACTOR = 6 (JAX at up to 2.6x). So the first pass, where Adam's first
steps from zero moments flip the sign of near-zero gradients under
rounding, is held to 0.09 on a loss and 0.064 / 0.30 on the stem's / all
the statistics, and the later passes to 1e-3 on a loss and 2.9e-3 on the
statistics or less. The final accuracies must equal JAX's (no f32 run
moved one) and the eval loss keep within 5e-4 of JAX's.

It fails mutants of the step (``test_mutants_fail``), in the first pass
(head B) and in the last (head A, from JAX's state after 12 steps): BN's
running update at momentum 0.9, and the 5-channel input as [dx, dy, r, g,
b]."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iic_tpu.data import pipeline as jpipe
from iic_tpu.evals import cluster_eval as jax_cluster_eval
from iic_tpu.ops import IID_loss as jax_IID_loss
from iic_tpu.parallel import make_cluster_train_step as jax_cluster_step
from iic_tpu.train.cluster_trainer import (
    build_net_and_state, head_order as jax_head_order, make_eval_apply)
from iic_tpu.train.config import ClusterConfig as JaxClusterConfig
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import load_cluster_net
from iic_tpu_torch.data import pipeline as tpipe
from iic_tpu_torch.evals.cluster_eval import cluster_eval
from iic_tpu_torch.ops.iid_loss import IID_loss
from iic_tpu_torch.parallel import train_step
from iic_tpu_torch.parallel.train_step import (
    make_apply_fn, make_cluster_train_step, make_optimizer)
from iic_tpu_torch.train.config import ClusterConfig

FLAGS = dict(arch="ClusterNet5gTwoHead", mode="IID",
             dataset="Synthetic10x32x3x8", dataset_root="", gt_k=10,
             output_k_A=20, output_k_B=10, lr=1e-3, num_epochs=3,
             batch_sz=24, num_dataloaders=2, num_sub_heads=2,
             crop_orig=True, rand_crop_sz=28, input_sz=32, include_rgb=True,
             batchnorm_track=True, seed=0)
EPOCHS = (1, 2)
LOSS_FACTOR, BN_FACTOR = 30.0, 6.0

# The port's f32 distance from its float64 run, both from JAX's state at
# each pass's start (PYTHONPATH=. python
# tests/test_torch_cluster_trajectory.py): the running maximum over a
# pass's steps of |loss|; at the end of each pass, the stem BN's and all
# BNs' statistics; the final eval's accuracy (largest over sub-heads) and
# loss.
LOSS64 = [1.46e-08, 4.48e-06, 0.003, 0.003, 1.04e-07, 4.15e-07, 4.9e-06,
          4.1e-05, 2.25e-07, 1.04e-06, 2.36e-05, 3.28e-05, 6.47e-08,
          9.89e-08, 9.89e-08, 8.14e-07]
STEM64 = [0.0107, 2.94e-05, 0.00022, 4.16e-07]
ALL64 = [0.0494, 0.000492, 0.000188, 6.1e-07]
ACC64, EVAL_LOSS64 = 0.0, 1.65e-05


def _configs():
    jcfg = JaxClusterConfig(**FLAGS)
    jcfg.finalize(twohead=True, sobel=True)
    tcfg = ClusterConfig(**FLAGS)
    tcfg.finalize(twohead=True, sobel=True)
    return jcfg, tcfg


def _bn_stats(net):
    """Every BatchNorm's (running mean, running var) in module order."""
    return [(m.running_mean.double().numpy().copy(),
             m.running_var.double().numpy().copy())
            for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_start(state):
    """JAX's state as numpy: params, running statistics, Adam's moments
    and count."""
    adam = state.opt_state.inner_state[0]
    return _numpy({"params": state.params, "batch_stats": state.batch_stats,
                   "mu": adam.mu, "nu": adam.nu, "count": adam.count})


def _run_jax():
    """JAX's trajectory, pass by pass: each pass's head, pairs, starting
    state, losses and BN statistics at its end; the final weights and
    their eval."""
    jcfg, tcfg = _configs()
    jnet, tx, state = build_net_and_state(jcfg)
    pipe_a, pipe_b, map_assign, map_test = \
        jpipe.cluster_twohead_create_dataloaders(jcfg, seed=jcfg.seed)
    pipes = {"A": pipe_a, "B": pipe_b}
    augment = {h: jax.jit(p.augment_pair) for h, p in pipes.items()}
    passes = []
    for e_i in EPOCHS:
        for head in jax_head_order(jcfg):
            passes.append(dict(head=head, pairs=[
                tuple(np.asarray(x) for x in augment[head](base, key))
                for base, key in pipes[head].epoch(e_i, augmented=False,
                                                   prefetch=False)]))
    steps = {h: jax_cluster_step(jnet, tx, lambda batch, key: batch,
                                 lamb=1.0, head=h, sobel=True,
                                 include_rgb=True) for h in "AB"}
    key = jax.random.PRNGKey(0)
    bridge = tmodels.build(tcfg.arch, tcfg)
    for p in passes:
        p["start"], p["losses"] = _jax_start(state), []
        for imgs, imgs_tf in p["pairs"]:
            state, loss, _ = steps[p["head"]](
                state, (jnp.asarray(imgs), jnp.asarray(imgs_tf)), key)
            p["losses"].append(float(loss))
        p["bns"] = _bn_stats(load_cluster_net(
            {"params": p["start"]["params"],
             "batch_stats": state.batch_stats}, bridge))
    # the eval forward (sobel inside) compiled once, at the batch of 24
    apply = make_eval_apply(jnet, state, jcfg)
    _, stats = jax_cluster_eval(jcfg, apply, map_assign, map_test)
    outs = [apply(jnp.asarray(x)) for x in passes[0]["pairs"][0]]
    eval_loss = float(jnp.mean(jax.vmap(
        lambda a, b: jax_IID_loss(a, b)[0])(*outs)))
    return dict(passes=passes, accs=list(stats["test_accs"]),
                eval_loss=eval_loss, final=_numpy(
                    {"params": state.params,
                     "batch_stats": state.batch_stats}))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port's steps on two torch threads (the test workers share the
    cores; LOSS64 and the rest hold for 1 to 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    return _run_jax()


def _float64_twin(net):
    """The port net in float64, its convs computing in float64."""
    twin = copy.deepcopy(net).double()
    for m in twin.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return twin


def _load_start(net, opt, start, scratch):
    """JAX's state at a pass's start into the port's net and Adam: params
    and running statistics through the bridge, each moment tree through it
    into ``scratch`` (a net of the same build) and on into Adam's state,
    parameter by parameter."""
    load_cluster_net(start, net)
    moments = {}
    for name in ("mu", "nu"):
        load_cluster_net({"params": start[name],
                          "batch_stats": start["batch_stats"]}, scratch)
        moments[name] = [q.detach().clone() for q in scratch.parameters()]
    for p, mu, nu in zip(net.parameters(), moments["mu"], moments["nu"]):
        opt.state[p] = {"step": torch.tensor(float(start["count"])),
                        "exp_avg": mu.to(p.dtype),
                        "exp_avg_sq": nu.to(p.dtype)}


def _port_eval(net, tcfg, first_pair, dtype=torch.float32):
    """The port's eval of ``net``: per-sub-head accuracies and the
    eval-mode IID loss of head B on ``first_pair``."""
    _, _, map_assign, map_test = tpipe.cluster_twohead_create_dataloaders(
        tcfg, seed=tcfg.seed, device="cpu")
    apply = make_apply_fn(net, head="B", sobel=True, include_rgb=True)
    _, stats = cluster_eval(tcfg, lambda x: apply(x.to(dtype)), map_assign,
                            map_test)
    outs = [apply(torch.tensor(x, dtype=dtype)) for x in first_pair]
    return list(stats["test_accs"]), float(IID_loss(*outs)[0].mean())


def _run_port(run, passes=None, float64=False):
    """The port's passes ``passes`` (all by default) on JAX's pairs, each
    from JAX's state at its start: {pass: (its losses, the BN statistics
    at its end)}, and after a whole run the final eval."""
    _, tcfg = _configs()
    net = tmodels.build(tcfg.arch, tcfg)
    scratch = tmodels.build(tcfg.arch, tcfg)
    dtype = torch.float64 if float64 else torch.float32
    if float64:
        net = _float64_twin(net)
    opt = make_optimizer(net, tcfg)
    steps = {h: make_cluster_train_step(net, opt, None, lamb=1.0, head=h,
                                        sobel=True, include_rgb=True)
             for h in "AB"}
    ks = range(len(run["passes"])) if passes is None else passes
    out = {"passes": {}}
    for k in ks:
        p = run["passes"][k]
        _load_start(net, opt, p["start"], scratch)
        losses = [float(steps[p["head"]]((torch.tensor(a, dtype=dtype),
                                          torch.tensor(b, dtype=dtype)))[0])
                  for a, b in p["pairs"]]
        out["passes"][k] = (losses, _bn_stats(net))
    if passes is None:
        out["accs"], out["eval_loss"] = _port_eval(
            net, tcfg, run["passes"][0]["pairs"][0], dtype)
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bn_distances(got, ref):
    """(the stem BN's distance: the larger of its mean's and var's, all
    BNs' statistics as one vector's)."""
    stem = max(_rel(got[0][i], ref[0][i]) for i in (0, 1))
    flat = [np.concatenate([s[i] for s in x for i in (0, 1)])
            for x in (got, ref)]
    return stem, _rel(*flat)


def _first_steps(run):
    """The global index of each pass's first step."""
    return np.cumsum([0] + [len(p["pairs"]) for p in run["passes"]])


def _pass_gaps(port, ref):
    """{pass: (the running maximum over its steps of the loss gap, the
    stem and all-BN distances at its end)} of ``port`` from ``ref``."""
    gaps = {}
    for k, (losses, bns) in port["passes"].items():
        gaps[k] = (np.maximum.accumulate(np.abs(
            np.array(losses) - ref["passes"][k]["losses"])),
            *_bn_distances(bns, ref["passes"][k]["bns"]))
    return gaps


def _violations(port, ref):
    """{pass: the bounds that the port's pass breaks against ``ref``'s}
    (pass None: the final eval's)."""
    first = _first_steps(ref)
    out = {}
    for k, (loss_gap, stem, flat) in _pass_gaps(port, ref).items():
        bound = LOSS_FACTOR * np.array(LOSS64[first[k]:first[k + 1]])
        out[k] = [f"step {first[k] + i}: the losses {g:.3e} apart, over "
                  f"{b:.3e}" for i, (g, b) in enumerate(zip(loss_gap, bound))
                  if g > b]
        if stem > BN_FACTOR * STEM64[k]:
            out[k].append(f"the stem BN's statistics {stem:.3e} apart, over "
                          f"{BN_FACTOR} x {STEM64[k]:.3e}")
        if flat > BN_FACTOR * ALL64[k]:
            out[k].append(f"the BN statistics {flat:.3e} apart, over "
                          f"{BN_FACTOR} x {ALL64[k]:.3e}")
    if "accs" in port:
        acc_gap = max(abs(a - b) for a, b in zip(port["accs"], ref["accs"]))
        loss_gap = abs(port["eval_loss"] - ref["eval_loss"])
        out[None] = [m for m, bad in (
            (f"accuracies {port['accs']}, JAX's {ref['accs']}",
             acc_gap > LOSS_FACTOR * ACC64),
            (f"eval loss {port['eval_loss']}, JAX's {ref['eval_loss']}",
             loss_gap > LOSS_FACTOR * EVAL_LOSS64)) if bad]
    return out


def test_trajectory_matches_jax(jax_run):
    """16 steps (B, A, B, A passes, each from JAX's state at its start),
    the BN statistics after each pass and the final eval, within the
    bounds above; and the port's eval of JAX's final weights equal to
    JAX's."""
    port = _run_port(jax_run)
    assert [len(p["losses"]) for p in jax_run["passes"]] == [4] * 4
    assert [p["head"] for p in jax_run["passes"]] == list("BABA")
    bad = {k: v for k, v in _violations(port, jax_run).items() if v}
    assert not bad, bad
    # the check has teeth: the heads leave the uniform start
    assert min(min(p["losses"]) for p in jax_run["passes"]) < -0.2
    _, tcfg = _configs()
    net = load_cluster_net(jax_run["final"], tmodels.build(tcfg.arch, tcfg))
    accs, eval_loss = _port_eval(net, tcfg, jax_run["passes"][0]["pairs"][0])
    assert accs == jax_run["accs"]
    assert abs(eval_loss - jax_run["eval_loss"]) <= 1e-5


def _channels_swapped(sobel_process):
    def swapped(imgs, include_rgb, **kwargs):
        return sobel_process(imgs, include_rgb, **kwargs)[:, [3, 4, 0, 1, 2]]
    return swapped


def _momentum(m):
    forward = torch.nn.BatchNorm2d.forward

    def forward_at(self, x):
        self.momentum = m
        return forward(self, x)
    return forward_at


@pytest.mark.parametrize("k", [0, 3], ids=["pass0_B", "pass3_A"])
@pytest.mark.parametrize("mutant", ["bn_momentum_0.9", "channels_dx_dy_rgb"])
def test_mutants_fail(jax_run, mutant, k, monkeypatch):
    """Pass ``k`` (4 steps from JAX's state at its start) of a mutated
    port step breaks the bounds that the port keeps
    (``test_trajectory_matches_jax``)."""
    if mutant == "bn_momentum_0.9":
        monkeypatch.setattr(torch.nn.BatchNorm2d, "forward", _momentum(0.9))
    else:
        monkeypatch.setattr(train_step, "sobel_process",
                            _channels_swapped(train_step.sobel_process))
    assert _violations(_run_port(jax_run, [k]), jax_run)[k]


def measure_float64_distances(threads=(1, 2, 4, 8), onednn=(True, False)):
    """The constants above: the port's f32 runs on JAX's pairs from JAX's
    pass starts (one for each torch thread count, with oneDNN's convs and
    without: the summation order moves the f32 rounding) beside its
    float64 run, the largest distance of any; and JAX's distance from each
    f32 run over those constants."""
    run = _run_jax()
    f64 = _run_port(run, float64=True)
    runs = {}
    for n in threads:
        for on in onednn:
            torch.set_num_threads(n)
            with torch.backends.mkldnn.flags(enabled=on):
                runs[n, on] = _run_port(run)
    ks = range(len(run["passes"]))
    gaps = [_pass_gaps(r, {"passes": [
        {"losses": f64["passes"][k][0], "bns": f64["passes"][k][1]}
        for k in ks]}) for r in runs.values()]
    loss64 = np.max([np.concatenate([g[k][0] for k in ks]) for g in gaps], 0)
    bn64 = np.max([[g[k][1:] for k in ks] for g in gaps], 0)
    acc64 = max(max(abs(a - b) for a, b in zip(r["accs"], f64["accs"]))
                for r in runs.values())
    eval64 = max(abs(r["eval_loss"] - f64["eval_loss"])
                 for r in runs.values())
    print("LOSS64 =", [float(f"{v:.3g}") for v in loss64])
    print("STEM64 =", [float(f"{v:.3g}") for v in bn64[:, 0]])
    print("ALL64 =", [float(f"{v:.3g}") for v in bn64[:, 1]])
    print("ACC64, EVAL_LOSS64 =", acc64, f"{eval64:.3g}")
    for (n, on), r in runs.items():
        g = _pass_gaps(r, run)
        loss = np.concatenate([g[k][0] for k in ks])
        bns = np.array([g[k][1:] for k in ks])
        print(f"JAX beside the port's f32 on {n} threads, oneDNN {on}, over "
              f"the constants: losses {np.round(loss / loss64, 2).tolist()}, "
              f"stem {np.round(bns[:, 0] / bn64[:, 0], 2).tolist()}, all "
              f"{np.round(bns[:, 1] / bn64[:, 1], 2).tolist()}; accuracies "
              f"{r['accs']} (JAX {run['accs']}), eval loss "
              f"{abs(r['eval_loss'] - run['eval_loss']) / eval64:.3g}x")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    measure_float64_distances()
