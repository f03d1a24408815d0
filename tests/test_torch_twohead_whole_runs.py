"""Whole runs of the two-head learning evidence (ClusterNet5gTwoHead,
sobel + rgb, ``Synthetic10x32x3x2048``, lr 1e-3, 16 epochs: the config of
``tools/tpu_learning_evidence.py`` and of the port's
``learning_evidence.twohead_config``) through either package's trainer,
with the seed, the epochs and the port's precision set here, not in the
tools:

    python tests/test_torch_twohead_whole_runs.py jax --seeds 0            # the CPU
    python tests/test_torch_twohead_whole_runs.py port --seeds 0 --device cpu
    python tests/test_torch_twohead_whole_runs.py port_on_jax_pairs --seeds 0  # CPU
    python tests/test_torch_twohead_whole_runs.py port --seeds 0 1 2 \\
        [--model_dtype bfloat16] [--no_tf32]                       # cuda:0

``jax`` runs the JAX package on the CPU (its f32 convs and matmuls at
XLA's CPU precision); ``port`` runs ``iic_tpu_torch`` and imports nothing
of JAX; ``port_on_jax_pairs`` runs the port's trainer on the CPU from the
JAX trainer's init on the pairs JAX's pipelines draw. The port's trainer turns cuDNN's TF32 on for its convs;
``--no_tf32`` turns it off again once the trainer has set it, so every
conv and matmul runs in full f32. Prints each epoch's log and, per run, one
line ``RUN {json}``: the package, seed, precision, every eval's best
sub-head accuracy (the pre-training eval first), both heads' epoch losses
and the seconds. Run directories go under ``--out_root``.

Both JAX modes build JAX's config in one place (``_jax_config``) from the
fields the port's ``twohead_config`` sets, and
``test_jax_config_is_the_tools`` holds it to the config that JAX's
``tools/tpu_learning_evidence.py`` trains, field for field."""

import argparse
import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


# the fields the evidence's config sets (``twohead_config``); the rest keep
# their defaults in both packages
FIELDS = ("model_ind", "arch", "mode", "dataset", "dataset_root", "gt_k",
          "output_k_A", "output_k_B", "lr", "num_epochs", "batch_sz",
          "num_dataloaders", "num_sub_heads", "out_root", "crop_orig",
          "rand_crop_sz", "input_sz", "include_rgb", "batchnorm_track",
          "save_freq", "seed")


def _port_config(seed, num_epochs, out_root):
    from iic_tpu_torch.tools.learning_evidence import twohead_config

    cfg = twohead_config(out_root)
    cfg.seed, cfg.num_epochs = seed, num_epochs
    return cfg


def _jax_config(seed, num_epochs, out_root):
    """JAX's ClusterConfig of the evidence's run, from the port's
    ``twohead_config``'s fields."""
    from iic_tpu.train.config import ClusterConfig

    cfg = _port_config(seed, num_epochs, out_root)
    jcfg = ClusterConfig(**{k: getattr(cfg, k) for k in FIELDS})
    jcfg.finalize(twohead=True, sobel=True)
    return jcfg


def _run_jax(seed, num_epochs, out_root):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from iic_tpu.train import train_cluster_twohead

    _, history = train_cluster_twohead(_jax_config(seed, num_epochs,
                                                   out_root))
    return history


def _run_port(seed, num_epochs, out_root, device, model_dtype, no_tf32):
    import torch
    from iic_tpu_torch.train import cluster_trainer

    cfg = _port_config(seed, num_epochs, out_root)
    cfg.model_dtype = model_dtype
    if no_tf32:
        # the trainer sets the flags just before this call
        adjust = cluster_trainer.adjust_batch_for_mesh

        def adjust_without_tf32(*args, **kwargs):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            return adjust(*args, **kwargs)

        cluster_trainer.adjust_batch_for_mesh = adjust_without_tf32
    try:
        _, history = cluster_trainer.train_cluster_twohead(cfg, device=device)
    finally:
        if no_tf32:
            cluster_trainer.adjust_batch_for_mesh = adjust
    return history


def _run_port_on_jax_pairs(seed, num_epochs, out_root):
    """The port's trainer on the CPU from the JAX trainer's init
    (``build_net_and_state``, carried across by the flax bridge) on the
    pairs JAX's pipelines draw (their batches, keys and ``augment_pair``):
    the port's steps, optimiser, BN and eval on JAX's inputs."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from iic_tpu.data import pipeline as jpipe
    from iic_tpu.train.cluster_trainer import build_net_and_state
    from iic_tpu_torch import models
    from iic_tpu_torch.compat.flax_bridge import load_cluster_net
    from iic_tpu_torch.train import cluster_trainer

    cfg = _port_config(seed, num_epochs, out_root)
    jcfg = _jax_config(seed, num_epochs, out_root)
    _, _, state = build_net_and_state(jcfg)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    jpipes = jpipe.cluster_twohead_create_dataloaders(jcfg, seed=seed)[:2]

    def with_jax_pairs(pipe, jpipe_):
        augment = jax.jit(jpipe_.augment_pair)

        def epoch(e_i, augmented=False):
            for base, key in jpipe_.epoch(e_i, augmented=False,
                                          prefetch=False):
                yield torch.from_numpy(np.asarray(base)), key

        def augment_pair(base, key):
            return tuple(torch.from_numpy(np.array(x)) for x in
                         augment(jnp.asarray(base.numpy()), key))

        pipe.epoch, pipe.augment_pair = epoch, augment_pair
        return pipe

    create = cluster_trainer.cluster_twohead_create_dataloaders
    build = models.build

    def create_on_jax_pairs(*args, **kwargs):
        pipe_a, pipe_b, *maps = create(*args, **kwargs)
        return (with_jax_pairs(pipe_a, jpipes[0]),
                with_jax_pairs(pipe_b, jpipes[1]), *maps)

    cluster_trainer.cluster_twohead_create_dataloaders = create_on_jax_pairs
    models.build = lambda arch, config: load_cluster_net(
        variables, build(arch, config))
    try:
        _, history = cluster_trainer.train_cluster_twohead(cfg, device="cpu")
    finally:
        cluster_trainer.cluster_twohead_create_dataloaders = create
        models.build = build
    return history


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("package", choices=("jax", "port", "port_on_jax_pairs"))
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--num_epochs", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="the port's device (default cuda:0)")
    p.add_argument("--model_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--no_tf32", action="store_true")
    p.add_argument("--out_root", default="build/twohead_runs")
    args = p.parse_args(argv)
    if args.package != "port" and (args.model_dtype != "float32"
                                   or args.no_tf32 or args.device):
        p.error("the precision options and --device are the port's")
    runs = []
    for seed in args.seeds:
        out_root = os.path.join(args.out_root, f"{args.package}_s{seed}")
        t0 = time.time()
        if args.package == "jax":
            history = _run_jax(seed, args.num_epochs, out_root)
        elif args.package == "port_on_jax_pairs":
            history = _run_port_on_jax_pairs(seed, args.num_epochs, out_root)
        else:
            history = _run_port(seed, args.num_epochs, out_root, args.device,
                                args.model_dtype, args.no_tf32)
        run = {"package": args.package, "seed": seed,
               "model_dtype": args.model_dtype,
               "tf32": args.package == "port" and not args.no_tf32,
               "acc": [float(a) for a in history["eval"].epoch_acc],
               "loss_A": [float(v) for v in history["epoch_loss_head_A"]],
               "loss_B": [float(v) for v in history["epoch_loss_head_B"]],
               "seconds": time.time() - t0}
        run["best_acc"] = max(run["acc"])
        if args.package != "jax":
            import torch
            # the flags the run's convs saw: the trainer's, or --no_tf32's
            run["cudnn_allow_tf32"] = torch.backends.cudnn.allow_tf32
        print("RUN " + json.dumps(run), flush=True)
        runs.append(run)
    return runs


if __name__ == "__main__":
    main()


def test_jax_config_is_the_tools(monkeypatch, tmp_path):
    """``_jax_config`` is the config JAX's tool hands its trainer (its
    seed 0 and 16 epochs), field for field, and the port's carries the
    same fields."""
    import dataclasses
    import importlib.util

    import iic_tpu.train as jax_train

    spec = importlib.util.spec_from_file_location(
        "tpu_learning_evidence", os.path.join(
            os.path.dirname(__file__), "..", "tools",
            "tpu_learning_evidence.py"))
    jle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jle)
    trained = []

    def record(config):
        trained.append(config)
        raise StopIteration

    monkeypatch.setattr(jle, "OUT", str(tmp_path))
    monkeypatch.setattr(jax_train, "train_cluster_twohead", record)
    with pytest.raises(StopIteration):
        jle.run_twohead()
    assert dataclasses.asdict(_jax_config(0, 16, str(tmp_path))) == \
        dataclasses.asdict(trained[0])
    port = _port_config(3, 5, str(tmp_path))
    jcfg = _jax_config(3, 5, str(tmp_path))
    assert {k: getattr(port, k) for k in FIELDS} == \
        {k: getattr(jcfg, k) for k in FIELDS}


@pytest.mark.parametrize("argv", [
    ["jax", "--model_dtype", "bfloat16"], ["port_on_jax_pairs", "--no_tf32"],
    ["jax", "--device", "cpu"]])
def test_precision_options_are_the_ports(argv):
    """The precision options and ``--device`` are refused outside
    ``port``."""
    with pytest.raises(SystemExit):
        main(argv)
