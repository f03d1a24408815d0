"""The port's host prefetch thread (``iic_tpu_torch/data/prefetch.py``) and
the two CLIs' ``--model_dtype``, ``--prefetch_depth`` and
``--no_host_prefetch``: ordering, an exception re-raised in the consumer,
``close()`` mid-epoch, ``prefetch_epochs``' epoch indices, the same losses
with and without the thread in bf16, the run directory's dtype and f32
checkpoint, and an unknown dtype refused."""

import pickle
import shutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from iic_tpu_torch.cli import cluster_sobel_twohead, segmentation_twohead
from iic_tpu_torch.cli._args import parse_seg_args
from iic_tpu_torch.data.prefetch import (
    DeviceUpload, ThreadedPrefetch, host_prefetch_iter, prefetch_epochs)
from iic_tpu_torch.data.seg_pipeline import SegTrainPipeline
from test_torch_cluster_train import CLI as CLUSTER_CLI
from test_torch_train import CLI as SEG_CLI


@pytest.fixture(autouse=True)
def _drop_run_dirs(request):
    """Removes a test's temporary directory (its CLI runs' directories,
    each a checkpoint or more) once the test is done: pytest keeps the
    temporary directories of its last runs."""
    root = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if root is not None:
        shutil.rmtree(root, ignore_errors=True)


def test_items_arrive_in_order():
    it = ThreadedPrefetch(iter(range(50)), depth=2)
    assert list(it) == list(range(50))
    assert not it._thread.is_alive()


def test_an_exception_in_the_generator_reraises_in_the_consumer():
    def gen():
        yield from range(3)
        raise ValueError("bad batch")

    it = ThreadedPrefetch(gen(), depth=1)
    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for x in it:
            got.append(x)
    assert got == [0, 1, 2]
    assert not it._thread.is_alive()


def test_close_mid_epoch_runs_the_generators_finally():
    """close() after two of 100 items: the worker stops, the queue is
    emptied and the generator's finally block has run when close()
    returns; the iterator then ends."""
    closed = threading.Event()

    def gen():
        try:
            yield from range(100)
        finally:
            closed.set()

    it = ThreadedPrefetch(gen(), depth=3)
    assert [next(it), next(it)] == [0, 1]
    it.close()
    assert closed.is_set()
    assert not it._thread.is_alive()
    assert it._q.empty()
    assert list(it) == []


class _Pipe:
    """A pipeline whose epoch e yields (10 e + i, i) for i < 3 and records
    the epochs whose generator was closed."""

    def __init__(self):
        self.finished = []

    def epoch(self, e_i, scale=1):
        try:
            for i in range(3):
                yield 10 * e_i * scale + i, i
        finally:
            self.finished.append(e_i)


def test_prefetch_epochs_chains_epochs_with_their_indices():
    pipe = _Pipe()
    got = list(prefetch_epochs(pipe, [4, 7], depth=2, scale=2))
    assert got == [(4, 80, 0), (4, 81, 1), (4, 82, 2),
                   (7, 140, 0), (7, 141, 1), (7, 142, 2)]
    assert pipe.finished == [4, 7]


def test_prefetch_epochs_close_closes_the_open_epoch():
    pipe = _Pipe()
    it = prefetch_epochs(pipe, [0, 1, 2], depth=1)
    assert next(it) == (0, 0, 0)
    it.close()
    assert pipe.finished == [0]


def test_host_prefetch_iter_follows_the_flags():
    cfg = SimpleNamespace(no_host_prefetch=False, prefetch_depth=3)
    gen = iter(range(5))
    it = host_prefetch_iter(gen, cfg)
    assert isinstance(it, ThreadedPrefetch) and it._q.maxsize == 3
    assert list(it) == list(range(5))
    cfg.no_host_prefetch = True
    gen = iter(range(5))
    assert host_prefetch_iter(gen, cfg) is gen


def test_cpu_upload_is_the_plain_copy():
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    (t,) = DeviceUpload("cpu")(a)
    assert t.device.type == "cpu" and t.dtype == torch.uint8
    assert torch.equal(t, torch.from_numpy(a))


def test_seg_epoch_behind_the_thread_equals_the_synchronous_one():
    """The same crops, masks and augmentation draws with and without the
    prefetch thread: each batch's generator keeps its seed (seed, epoch,
    batch)."""
    cfg = parse_seg_args(SEG_CLI).finalize(twohead=True)
    pipe = SegTrainPipeline(cfg, ["train"], seed=3)
    sync = list(pipe.epoch(1))
    threaded = list(ThreadedPrefetch(pipe.epoch(1), depth=2))
    assert len(sync) == len(threaded) == len(pipe) > 1
    for (i1, m1, g1), (i2, m2, g2) in zip(sync, threaded):
        assert torch.equal(i1, i2) and torch.equal(m1, m2)
        assert torch.equal(torch.rand(4, generator=g1),
                           torch.rand(4, generator=g2))


def _run(main, argv, out_root):
    _, history = main(argv + ["--out_root", str(out_root)], device="cpu")
    return {h: history[f"epoch_loss_head_{h}"] for h in "AB"}


@pytest.mark.parametrize("main,cli", [
    (segmentation_twohead.main, SEG_CLI),
    (cluster_sobel_twohead.main, CLUSTER_CLI)], ids=["seg", "cluster"])
def test_cli_bf16_with_and_without_prefetch(tmp_path, main, cli):
    """``--model_dtype bfloat16 --prefetch_depth 2`` and the same run under
    ``--no_host_prefetch``: equal losses, finite; config.pickle records
    bfloat16 and the checkpoint holds f32 parameters."""
    argv = cli + ["--model_dtype", "bfloat16"]
    threaded = _run(main, argv + ["--prefetch_depth", "2"], tmp_path / "a")
    sync = _run(main, argv + ["--no_host_prefetch"], tmp_path / "b")
    assert threaded == sync
    assert all(np.isfinite(v).all() for v in threaded.values())
    run = tmp_path / "a" / "0"
    with open(run / "config.pickle", "rb") as f:
        meta = pickle.load(f)
    assert meta["config"]["model_dtype"] == "bfloat16"
    assert meta["config"]["prefetch_depth"] == 2
    saved = torch.load(run / "latest.pytorch", weights_only=True)
    floats = [v for v in saved["net"].values() if v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)


@pytest.mark.parametrize("main,cli", [
    (segmentation_twohead.main, SEG_CLI),
    (cluster_sobel_twohead.main, CLUSTER_CLI)], ids=["seg", "cluster"])
def test_unknown_model_dtype_raises(tmp_path, main, cli):
    with pytest.raises(ValueError, match="float16"):
        main(cli + ["--out_root", str(tmp_path), "--model_dtype", "float16"],
             device="cpu")
