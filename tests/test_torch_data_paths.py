"""The clustering data entry points of the port against the JAX package,
on fixture trees written under ``tmp_path`` in the JAX tests' layouts
(tests/test_lazy_readers.py, tests/test_lazy_imagefolder.py):

- the memory-mapped MNIST and STL10 readers (``--lazy_images``) equal to
  JAX's eager and lazy readers under every access pattern the pipelines
  use; ``--mix_train``'s reorder, the lazy join of partitions, the
  truncated mapping loader and a rank's shard reading only their rows
  (rows counted through ``_materialise``); a batch read on the prefetch
  thread; host memory flat over a 1.1 GB sparse split (a child process);
- the ImageFolder readers, eager and lazy, equal to JAX's on a tree with
  mixed sizes, an EXIF-rotated JPEG, a file only PIL decodes, an
  undecodable file and a non-image file;
- ``create_basic_clustering_dataloaders``: the seeded epoch order and the
  uint8 batches equal to JAX's (sharded too), the ``none`` gate, head B
  sharing head A's arrays, and cuda:0 as its default device;
- ``DigitsNuisance`` equal to JAX's array for array;
- the two-head sobel CLI and the triplets CLI on STL10 with
  ``--mix_train --lazy_images``, equal to the eager runs' losses;
- ``--profile_dir``: a chrome trace of one epoch with its step spans from
  the clustering and segmentation trainers, and the rank gate."""

import json
import os
import shutil
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from iic_tpu.data import pipeline as jpipe
from iic_tpu.data import readers as jreaders
from iic_tpu.train.config import ClusterConfig as JaxClusterConfig
from iic_tpu_torch.cli import (
    cluster_greyscale_twohead, cluster_sobel_twohead, segmentation_twohead,
    triplets_sobel)
from iic_tpu_torch.data import pipeline as tpipe
from iic_tpu_torch.data import readers as treaders
from iic_tpu_torch.data.prefetch import host_prefetch_iter
from iic_tpu_torch.train.config import ClusterConfig
from iic_tpu_torch.train.seg_trainer import (
    start_epoch_trace, stop_epoch_trace)
from test_lazy_readers import _make_mnist, _make_stl10
from test_torch_cluster_grey import GREY_CLI
from test_torch_train import CLI as SEG_CLI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LazyBinaryArray = treaders.LazyBinaryArray


def _patterns(n):
    """(name, index) of every access the pipelines make of an array of
    ``n`` images."""
    mask = np.zeros(n, bool)
    mask[[1, n - 2]] = True
    return [("int", 3), ("negative int", -1), ("numpy int", np.int64(2)),
            ("slice", slice(2, 9)), ("step slice", slice(1, None, 3)),
            ("fancy", np.array([5, 1, 1, n - 1])), ("list", [0, 4]),
            ("bool mask", mask), ("empty", np.array([], np.int64))]


def _assert_same_array(got, ref, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype == np.uint8, name
    assert got.shape == ref.shape, name
    assert np.array_equal(got, ref), name


def _reads(monkeypatch):
    """Count the rows each ``_materialise`` gathers from memory maps (the
    leaves; a lazy join's own calls are not page reads)."""
    rows = []
    real = LazyBinaryArray._materialise

    def counted(self, gidx):
        if isinstance(self.parts[0], np.memmap):
            rows.append(len(gidx))
        return real(self, gidx)

    monkeypatch.setattr(LazyBinaryArray, "_materialise", counted)
    return rows


# ------------------------------------------------- the memory-mapped readers

@pytest.mark.parametrize("name,part", [
    ("MNIST", True), ("MNIST", False), ("STL10", "train"),
    ("STL10", "test"), ("STL10", "unlabeled"), ("STL10", "train+unlabeled")])
def test_lazy_binary_readers_equal_jax(tmp_path, name, part):
    """The port's lazy array against JAX's eager and lazy readers: shape,
    length, dtype, labels, and every access pattern, ``.select`` (twice
    composed) and ``np.asarray``."""
    root = str(tmp_path)
    (_make_mnist if name == "MNIST" else _make_stl10)(root)
    lazy = treaders.load_dataset(name, root, part, lazy=True)
    eager = treaders.load_dataset(name, root, part)
    j_eager = jreaders.load_dataset(name, root, part)
    j_lazy = jreaders.load_dataset(name, root, part, lazy=True)
    imgs = lazy["images"]
    assert isinstance(imgs, LazyBinaryArray)
    assert isinstance(eager["images"], np.ndarray)
    ref = j_eager["images"]
    assert imgs.shape == ref.shape and len(imgs) == len(ref)
    assert imgs.dtype == np.uint8
    for labels in (lazy["labels"], eager["labels"]):
        assert labels.dtype == np.int32
        assert np.array_equal(labels, j_eager["labels"])
    _assert_same_array(imgs, ref, "asarray")
    _assert_same_array(eager["images"], ref, "eager")
    for pname, idx in _patterns(len(ref)):
        _assert_same_array(imgs[idx], ref[idx], pname)
        _assert_same_array(imgs[idx], j_lazy["images"][idx], pname)
    ids = np.array([len(ref) - 1, 3, 3, 0, 7])
    sel = imgs.select(ids)
    assert isinstance(sel, LazyBinaryArray) and len(sel) == len(ids)
    _assert_same_array(sel, ref[ids], "select")
    _assert_same_array(sel.select([4, 0])[1], ref[ids[0]], "select twice")
    _assert_same_array(np.asarray(sel, dtype=np.float32).astype(np.uint8),
                       ref[ids], "asarray with a dtype")


def test_gz_mnist_decodes_eagerly_as_in_jax(tmp_path):
    """A ``.gz`` idx file cannot be memory-mapped: lazy returns the eager
    array, as JAX's reader does."""
    import gzip

    root = str(tmp_path)
    _make_mnist(root)
    raw = os.path.join(root, "train-images-idx3-ubyte")
    with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb") as g:
        g.write(f.read())
    os.remove(raw)
    got = treaders.load_dataset("MNIST", root, True, lazy=True)
    ref = jreaders.load_dataset("MNIST", root, True, lazy=True)
    assert isinstance(got["images"], np.ndarray)
    assert isinstance(ref["images"], np.ndarray)
    _assert_same_array(got["images"], ref["images"])


@pytest.mark.parametrize("name", ["CIFAR10", "Digits"])
def test_eager_only_readers_ignore_lazy(tmp_path, name):
    """CIFAR (pickled) and the Digits sets decode eagerly under lazy too."""
    from test_torch_cluster_data import _write_cifar

    _write_cifar(tmp_path)
    got = treaders.load_dataset(name, str(tmp_path), True, lazy=True)
    ref = jreaders.load_dataset(name, str(tmp_path), True, lazy=True)
    assert isinstance(got["images"], np.ndarray)
    _assert_same_array(got["images"], ref["images"])


def _stl_cfg(root, lazy, **kw):
    flags = dict(dataset="STL10", dataset_root=root, mix_train=True,
                 lazy_images=lazy, batch_sz=6, num_dataloaders=3,
                 rand_crop_sz=64, input_sz=64, crop_orig=True)
    flags.update(kw)
    return (ClusterConfig(**flags).finalize(twohead=True, sobel=True),
            JaxClusterConfig(**flags).finalize(twohead=True, sobel=True))


def test_mix_train_and_the_lazy_join_stay_lazy(tmp_path, monkeypatch):
    """Head A's partitions under --mix_train --lazy_images: loading reads
    no page, a batch reads its own rows and no others, and every array
    equals the eager port's and JAX's lazy and eager ones."""
    root = str(tmp_path)
    _make_stl10(root, n_train=4, n_test=3, n_unlab=8)
    tcfg, jcfg = _stl_cfg(root, True)
    rows = _reads(monkeypatch)
    imgs, labels = tpipe._load_partitions(tcfg, ["train+unlabeled", "test"])
    assert isinstance(imgs, LazyBinaryArray)
    assert all(isinstance(p, LazyBinaryArray) for p in imgs.parts)
    assert rows == [] and len(imgs) == len(labels) == 15
    batch = imgs[np.array([0, 1, 12, 14])]  # across the join
    assert sum(rows) == 4
    rows.clear()
    e_imgs, e_labels = tpipe._load_partitions(
        _stl_cfg(root, False)[0], ["train+unlabeled", "test"])
    j_imgs, j_labels = jpipe._load_partitions(jcfg,
                                              ["train+unlabeled", "test"])
    jcfg.lazy_images = False
    je_imgs, je_labels = jpipe._load_partitions(
        jcfg, ["train+unlabeled", "test"])
    _assert_same_array(batch, je_imgs[[0, 1, 12, 14]])
    for got in (imgs, e_imgs, j_imgs):
        _assert_same_array(got, je_imgs)
    for got in (labels, e_labels, j_labels):
        assert np.array_equal(got, je_labels)
    # the mix itself: labelled image i, then its 2 unlabelled ones
    assert np.array_equal(labels[:6] >= 0, [1, 0, 0, 1, 0, 0])


def test_lazy_pipelines_read_only_their_rows(tmp_path, monkeypatch):
    """The train pipeline reads a batch's rows a batch; a rank's shard
    reads only that rank's rows; ``truncate_pc`` keeps the mapping loader
    lazy and it reads only the kept rows. Batches equal the eager
    pipeline's."""
    root = str(tmp_path)
    _make_stl10(root, n_train=4, n_test=3, n_unlab=8)
    tcfg, _ = _stl_cfg(root, True)
    ecfg, _ = _stl_cfg(root, False)
    rows = _reads(monkeypatch)
    parts = ["train+unlabeled", "test"]
    lazy = tpipe.ClusterTrainPipeline(tcfg, parts)
    eager = tpipe.ClusterTrainPipeline(ecfg, parts)
    got = [b.numpy() for b, _ in lazy.epoch(0)]
    assert rows == [2] * 7 + [1]  # 15 images in batches of 2
    ref = [b.numpy() for b, _ in eager.epoch(0)]
    assert len(got) == len(ref) == 8
    assert all(np.array_equal(g, r) for g, r in zip(got, ref))
    for rank in (0, 1):
        rows.clear()
        shard = tpipe.ClusterTrainPipeline(tcfg, parts,
                                           process_shard=(rank, 2))
        e_shard = tpipe.ClusterTrainPipeline(ecfg, parts,
                                             process_shard=(rank, 2))
        for ((b, w), _), ((eb, ew), _) in zip(shard.epoch(0),
                                              e_shard.epoch(0)):
            assert np.array_equal(b.numpy(), eb.numpy())
            assert np.array_equal(w.numpy(), ew.numpy())
        assert rows == [1] * 8
    rows.clear()
    loader = tpipe.MappingLoader(tcfg, parts, truncate_pc=0.5)
    e_loader = tpipe.MappingLoader(ecfg, parts, truncate_pc=0.5)
    assert isinstance(loader.images, LazyBinaryArray) and rows == []
    assert len(loader.images) == 7
    for (x, y), (ex, ey) in zip(loader, e_loader):
        assert torch.equal(x, ex) and np.array_equal(y, ey)
    assert sum(rows) == 7


def test_a_lazy_batch_is_read_on_the_prefetch_thread(tmp_path,
                                                     monkeypatch):
    """Behind ``host_prefetch_iter`` (the trainers' thread) every page
    read of an epoch runs off the consumer's thread."""
    root = str(tmp_path)
    _make_stl10(root, n_train=4, n_test=3, n_unlab=8)
    tcfg, _ = _stl_cfg(root, True)
    threads = []
    real = LazyBinaryArray._materialise

    def recorded(self, gidx):
        threads.append(threading.get_ident())
        return real(self, gidx)

    monkeypatch.setattr(LazyBinaryArray, "_materialise", recorded)
    pipe = tpipe.ClusterTrainPipeline(tcfg, ["train+unlabeled"])
    it = host_prefetch_iter(pipe.epoch(0), tcfg)
    n = sum(1 for _ in it)
    assert n == 6 and len(threads) >= 6
    assert threading.get_ident() not in threads


_RSS_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
root = sys.argv[2]


def rss_mb():
    # the current VmRSS, not ru_maxrss (which counts the fork window in
    # which the child shares its parent's pages)
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS")


stages = [("start", rss_mb())]
from iic_tpu_torch.data.readers import LazyBinaryArray, load_dataset
stages.append(("import", rss_mb()))
imgs = load_dataset("STL10", root, "unlabeled", lazy=True)["images"]
assert isinstance(imgs, LazyBinaryArray) and len(imgs) == 40000
stages.append(("load", rss_mb()))
rng = np.random.default_rng(0)
for i in range(4):  # eval-sized batches across the whole range
    batch = imgs[rng.integers(0, len(imgs), 256)]
    assert batch.shape == (256, 96, 96, 3)
    stages.append((f"batch{i}", rss_mb()))
print(" ".join(f"{n}={v:.1f}" for n, v in stages), file=sys.stderr)
after = dict(stages)["import"]
print(max(v for _, v in stages[2:]) - after)
"""


def test_host_memory_stays_flat_over_a_large_lazy_split(tmp_path):
    """A 40 000-image STL10 unlabelled split (1.1 GB, a sparse file: no
    disk is used): the lazy load and four random 256-image batches grow
    the child's resident memory by less than 200 MB over its size after
    the import (the eager reader would add the whole 1.1 GB)."""
    base = tmp_path / "stl10_binary"
    base.mkdir()
    with open(base / "unlabeled_X.bin", "wb") as f:
        f.truncate(40000 * 3 * 96 * 96)
    proc = subprocess.run(
        [sys.executable, "-c", _RSS_CHILD, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    growth = float(proc.stdout.strip())
    assert growth < 200, f"grew {growth:.0f} MB: {proc.stderr.strip()}"


# ------------------------------------------------------------- ImageFolder

def _write_folder(root, sizes_by_class, seed=0):
    """Random RGB PNGs, ``sizes_by_class`` {class: [(h, w), ...]}."""
    import cv2

    rng = np.random.default_rng(seed)
    for cname in sorted(sizes_by_class):
        cdir = os.path.join(root, cname)
        os.makedirs(cdir, exist_ok=True)
        for i, (h, w) in enumerate(sizes_by_class[cname]):
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(cdir, f"im_{i}.png"), img)


def _write_odd_files(cdir, seed=0):
    """An EXIF-orientation-6 JPEG (header 28 wide x 20 high: 20 x 28
    decoded, turned), a PCX image named .png (PIL decodes it, cv2 does
    not), an undecodable .jpg and a text file."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(rng.integers(0, 256, (20, 28, 3)).astype(np.uint8)).save(
        os.path.join(cdir, "exif6.jpg"), "JPEG", exif=exif.tobytes())
    Image.fromarray(rng.integers(0, 256, (24, 24, 3)).astype(np.uint8)).save(
        os.path.join(cdir, "pcx_inside.png"), "PCX")
    with open(os.path.join(cdir, "broken.jpg"), "wb") as f:
        f.write(b"not an image at all")
    with open(os.path.join(cdir, "notes.txt"), "w") as f:
        f.write("not an image")


def test_image_folder_readers_equal_jax(tmp_path):
    """Eager and lazy, the port's arrays equal JAX's bit for bit: the same
    files kept (the broken and text files dropped, the PCX kept), the
    same labels, the EXIF turn and the resize to the modal (24, 24)."""
    import cv2

    root = str(tmp_path)
    _write_folder(os.path.join(root, "train"),
                  {"b": [(24, 24), (24, 24), (20, 28)],
                   "a": [(24, 24), (16, 24), (24, 24)]})
    _write_odd_files(os.path.join(root, "train", "a"))
    assert cv2.imread(os.path.join(root, "train", "a", "pcx_inside.png")) \
        is None
    turned = cv2.imread(os.path.join(root, "train", "a", "exif6.jpg"))
    assert turned.shape[:2] == (28, 20)
    ref = jreaders.load_image_folder(root, "train")
    assert ref["images"].shape == (8, 24, 24, 3)
    for lazy in (False, True):
        got = treaders.load_dataset("ImageFolder", root, True, lazy=lazy)
        j = jreaders.load_dataset("ImageFolder", root, True, lazy=lazy)
        imgs = got["images"]
        assert isinstance(imgs, treaders.LazyImageArray) == lazy
        assert imgs.shape == ref["images"].shape and len(imgs) == 8
        assert np.array_equal(got["labels"], ref["labels"])
        assert np.array_equal(got["labels"], [0] * 5 + [1] * 3)
        _assert_same_array(imgs, ref["images"])
        for pname, idx in _patterns(8):
            _assert_same_array(imgs[idx], ref["images"][idx], pname)
            _assert_same_array(imgs[idx], j["images"][idx], pname)
        if lazy:
            assert imgs.paths == j["images"].paths
            sel = imgs.select(np.array([7, 2, 2]))
            assert isinstance(sel, treaders.LazyImageArray)
            _assert_same_array(sel, ref["images"][[7, 2, 2]])
    with pytest.raises(FileNotFoundError):
        treaders.load_dataset("ImageFolder", root, False)  # no test/


def test_lazy_image_folder_decodes_nothing_up_front(tmp_path, monkeypatch):
    """The lazy scan reads headers only; each access decodes its files."""
    import cv2

    root = str(tmp_path)
    _write_folder(os.path.join(root, "train"), {"a": [(20, 20)] * 5})
    calls = []
    real = cv2.imread
    monkeypatch.setattr(
        cv2, "imread", lambda *a, **k: calls.append(a) or real(*a, **k))
    d = treaders.load_dataset("ImageFolder", root, "train", lazy=True)
    assert calls == []
    d["images"][3]
    assert len(calls) == 1
    d["images"][1:3]
    assert len(calls) == 3


# --------------------------------------- create_basic_clustering_dataloaders

def _basic_cfgs(root, lazy=False, **kw):
    flags = dict(dataset="ImageFolder", dataset_root=root, mode="IID",
                 batch_sz=4, num_dataloaders=2, input_sz=16, gt_k=2,
                 crop_orig=True, rand_crop_sz=20, include_rgb=True,
                 batchnorm_track=True, lazy_images=lazy)
    flags.update(kw)
    return (ClusterConfig(**flags).finalize(twohead=True, sobel=True),
            JaxClusterConfig(**flags).finalize(twohead=True, sobel=True))


def _basic_tree(root, none=True):
    _write_folder(os.path.join(root, "train"),
                  {"a": [(24, 24)] * 6, "b": [(24, 24)] * 4 + [(20, 28)]})
    if none:
        _write_folder(os.path.join(root, "none"),
                      {"a": [(24, 24)] * 4, "b": [(24, 24)] * 3}, seed=1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lazy", [False, True])
def test_basic_dataloaders_equal_jax(tmp_path, seed, lazy):
    """Epochs 0 and 1 of both heads: JAX's seeded order and uint8 batches
    (the ragged last one kept); head B shares head A's arrays and order;
    the mapping loaders over ``none`` equal JAX's (tf3 within 1e-5)."""
    root = str(tmp_path)
    _basic_tree(root)
    tcfg, jcfg = _basic_cfgs(root, lazy)
    got = tpipe.create_basic_clustering_dataloaders(tcfg, seed=seed,
                                                    device="cpu")
    ref = jpipe.create_basic_clustering_dataloaders(jcfg, seed=seed)
    pa, pb, ma, mt = got
    assert pb.images is pa.images and pb.labels is pa.labels
    assert mt.images is ma.images
    assert isinstance(pa.images, treaders.LazyImageArray) == lazy
    for key in ("train_partitions_head_A", "train_partitions_head_B",
                "mapping_assignment_partitions", "mapping_test_partitions"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    for e in (0, 1):
        order = pa.epoch_order(e)
        assert np.array_equal(order, np.random.default_rng(
            np.random.SeedSequence([seed, e])).permutation(11))
        for g, r in zip(got[:2], ref[:2]):
            gb = [b.numpy() for b, _ in g.epoch(e)]
            rb = [np.asarray(b) for b, _ in r.epoch(e, augmented=False,
                                                    prefetch=False)]
            assert [len(b) for b in gb] == [2] * 5 + [1]
            assert len(gb) == len(rb)
            assert all(np.array_equal(a, b) for a, b in zip(gb, rb))
            assert np.array_equal(
                np.concatenate(gb), np.asarray(r.images)[order])
    for g, r in zip(got[2:], ref[2:]):
        assert np.array_equal(g.labels, r.labels)
        for (gi, gl), (ri, rl) in zip(g, r):
            np.testing.assert_allclose(gi.numpy(), np.asarray(ri),
                                       atol=1e-5)
            assert np.array_equal(gl, np.asarray(rl))


@pytest.mark.parametrize("rank", [0, 1])
def test_basic_dataloaders_sharded_order_equals_jax(tmp_path, rank):
    """Under two ranks the seeded order is sharded as JAX's multi-host
    pipeline shards it: each rank's rows and weights, the ragged last
    batch padded with its last image (weight 0)."""
    root = str(tmp_path)
    _basic_tree(root, none=False)
    tcfg, jcfg = _basic_cfgs(root)
    t = tpipe.ClusterTrainPipeline(tcfg, ["train"], seed=3,
                                   deterministic_shuffle=True,
                                   process_shard=(rank, 2))
    j = jpipe.ClusterTrainPipeline(jcfg, ["train"], seed=3,
                                   deterministic_shuffle=True,
                                   process_shard=(rank, 2))
    got = list(t.epoch(1))
    ref = list(j.epoch(1, augmented=False, prefetch=False))
    assert len(got) == len(ref) == 6
    for ((b, w), _), ((rb, rw), _) in zip(got, ref):
        assert np.array_equal(b.numpy(), np.asarray(rb))
        assert np.array_equal(w.numpy(), np.asarray(rw))
    assert got[-1][0][1].tolist() == ([1.0] if rank == 0 else [0.0])


def test_basic_dataloaders_without_none_and_other_datasets(tmp_path):
    """No ``none`` directory: no mapping loaders (JAX's gate). Another
    dataset name: the two-head factory's four pipelines and loaders. An
    image folder in the trainers' partition tables is refused."""
    root = str(tmp_path)
    _basic_tree(root, none=False)
    tcfg, jcfg = _basic_cfgs(root)
    got = tpipe.create_basic_clustering_dataloaders(tcfg, device="cpu")
    ref = jpipe.create_basic_clustering_dataloaders(jcfg)
    assert got[2:] == ref[2:] == (None, None)
    assert not hasattr(tcfg, "mapping_assignment_partitions")
    scfg, _ = _basic_cfgs(root, dataset="Synthetic3x24x3x12")
    pa, pb, ma, mt = tpipe.create_basic_clustering_dataloaders(
        scfg, seed=2, device="cpu")
    assert (pa.seed, pb.seed) == (2, 3) and not pa.deterministic_shuffle
    assert ma is not None and mt is not None
    with pytest.raises(NotImplementedError, match="ImageFolder"):
        tpipe.cluster_twohead_create_dataloaders(tcfg)


def test_basic_dataloaders_need_a_gpu_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _basic_tree(str(tmp_path))
    with pytest.raises(RuntimeError, match="no GPU"):
        tpipe.create_basic_clustering_dataloaders(
            _basic_cfgs(str(tmp_path))[0])


# ------------------------------------------------------------ DigitsNuisance

@pytest.mark.parametrize("train", [True, False])
def test_digits_nuisance_equals_jax(train):
    got = treaders.load_dataset("DigitsNuisance", "", train)
    ref = jreaders.load_dataset("DigitsNuisance", "", train)
    assert got["images"].shape == (1500 if train else 297, 32, 32, 1)
    _assert_same_array(got["images"], ref["images"])
    assert np.array_equal(got["labels"], ref["labels"])
    assert got["labels"].dtype == np.int32


# -------------------------------------------------- the CLIs, lazy and eager

STL_CLI = ["--arch", "ClusterNet5gTwoHead", "--mode", "IID",
           "--dataset", "STL10", "--gt_k", "10", "--output_k_A", "15",
           "--output_k_B", "10", "--lamb", "1.0", "--lr", "0.0001",
           "--num_epochs", "2", "--batch_sz", "6", "--num_dataloaders", "3",
           "--num_sub_heads", "2", "--mix_train", "--crop_orig",
           "--rand_crop_sz", "20", "--input_sz", "32", "--head_A_first",
           "--batchnorm_track", "--test_code"]
TRIPLETS_STL_CLI = ["--dataset", "STL10", "--gt_k", "10", "--lr", "0.0001",
                    "--num_epochs", "2", "--batch_sz", "6",
                    "--num_dataloaders", "3", "--mix_train", "--crop_orig",
                    "--rand_crop_sz", "20", "--input_sz", "32",
                    "--test_code"]


@pytest.mark.parametrize("cli,argv", [
    (cluster_sobel_twohead, STL_CLI), (triplets_sobel, TRIPLETS_STL_CLI)])
def test_lazy_cli_runs_give_the_eager_losses(tmp_path, monkeypatch, cli,
                                            argv):
    """A two-epoch --test_code run on an STL10 tree with --mix_train,
    eager and --lazy_images: the same epoch losses and eval accuracies,
    exactly; only the lazy run reads pages through the memory maps."""
    root = str(tmp_path / "data")
    _make_stl10(root, n_train=4, n_test=3, n_unlab=8)
    rows = _reads(monkeypatch)
    runs = []
    for extra in ([], ["--lazy_images"]):
        out = tmp_path / f"out{len(runs)}"
        _, history = cli.main(argv + extra + ["--dataset_root", root,
                                              "--out_root", str(out)],
                              device="cpu")
        runs.append(history)
        shutil.rmtree(out)
        assert (sum(rows) > 0) == bool(extra)
    eager, lazy = runs
    if cli is triplets_sobel:
        keys = ["epoch_loss", "epoch_acc"]
    else:
        keys = ["epoch_loss_head_A", "epoch_loss_head_B"]
        assert lazy["eval"].epoch_acc == eager["eval"].epoch_acc
    for key in keys:
        assert len(eager[key]) >= 1 and np.isfinite(eager[key]).all()
        assert lazy[key] == eager[key], key


# ------------------------------------------------------------ --profile_dir

def _trace_names(path, cat=None):
    """The names of the trace's events (of category ``cat`` if given)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events
            if cat is None or e.get("cat") == cat]


@pytest.mark.parametrize("cli,argv,steps", [
    (cluster_greyscale_twohead, GREY_CLI, {"A": 2, "B": 4}),
    (segmentation_twohead, SEG_CLI, {"A": 2, "B": 2})])
def test_profile_dir_writes_one_epochs_trace(tmp_path, cli, argv, steps):
    """One --test_code epoch under --profile_dir: a chrome trace of epoch
    1 that parses as JSON and holds a ``step_head_<X>`` span a step."""
    prof_dir = tmp_path / "prof"
    out = tmp_path / "out"
    cli.main(argv + ["--out_root", str(out), "--profile_dir", str(prof_dir)],
             device="cpu")
    shutil.rmtree(out)
    assert os.listdir(prof_dir) == ["trace_epoch_1.json"]
    path = prof_dir / "trace_epoch_1.json"
    spans = _trace_names(path, cat="user_annotation")
    for head, n in steps.items():
        assert spans.count(f"step_head_{head}") == n, head
    assert "aten::convolution" in _trace_names(path)  # the ops under them


def test_epoch_trace_rank_and_epoch_gate(tmp_path):
    """Only the process that writes the run's files traces, only the first
    epoch the run trains, and only under --profile_dir."""
    cfg = SimpleNamespace(profile_dir=str(tmp_path / "p"))
    cpu = torch.device("cpu")
    assert start_epoch_trace(cfg, 3, 3, False, cpu) is None  # rank > 0
    assert start_epoch_trace(cfg, 4, 3, True, cpu) is None  # a later epoch
    assert start_epoch_trace(SimpleNamespace(profile_dir=""), 3, 3, True,
                             cpu) is None
    assert stop_epoch_trace(cfg, None, 3) is None
    assert not os.path.exists(cfg.profile_dir)
    prof = start_epoch_trace(cfg, 3, 3, True, cpu)
    assert prof is not None
    with torch.profiler.record_function("step_head_A"):
        torch.ones(3).sum()
    path = stop_epoch_trace(cfg, prof, 3)
    assert path == os.path.join(cfg.profile_dir, "trace_epoch_3.json")
    assert "step_head_A" in _trace_names(path)
