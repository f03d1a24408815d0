"""Native host prep of segmentation training batches
(``iic_tpu/native/__init__.py``).

``seg_prep.cpp`` is the JAX package's threaded C++ batch assembly, copied
unchanged: for each sample an optional pre-scale and random scale
(bilinear image, nearest label), centre-pad and crop to input_sz about a
given centre, and the label-table remap into a relevancy mask, written
straight into the batch buffers. ``data/seg_pipeline.py`` draws the random
geometry in Python (``_draw_geometry``) and passes it in.

The library is built at first use with ``g++ -O3 -march=native -shared
-fPIC -pthread -std=c++17`` into ``build/native/libseg_prep-<hash>.so`` at
the repository root; the hash covers the source, the compiler and the
flags. The compiler writes to a file of its own and ``os.replace`` moves it
into place, so processes that build at once do not read a half-written
library.

Unlike ``iic_tpu.native.load_seg_prep``, which returns None when the build
fails so that its callers quietly take the numpy path, a failed build here
raises: the pipeline takes the native path only when it was asked for or
picked by the auto rule, and then it runs or the run stops.
"""

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "seg_prep.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-std=c++17")

_LIBS = {}          # library path -> the loaded ctypes.CDLL
BUILD_SECONDS = {}  # library path -> seconds g++ took in this process


def library_path(cxx="g++"):
    """Where the library built by ``cxx`` from ``SRC`` lives."""
    key = SRC.read_bytes() + " ".join((cxx,) + CXX_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"libseg_prep-{digest}.so"


def build_seg_prep(cxx="g++"):
    """Compile ``seg_prep.cpp`` unless its library exists; returns the
    library's path. Raises ``RuntimeError`` when the compiler is missing or
    fails."""
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native seg_prep: cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native seg_prep: {cxx} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[out] = time.perf_counter() - t0
    return out


def load_seg_prep(cxx="g++"):
    """The loaded library (built if needed), ``seg_prepare_batch`` typed.
    Raises ``RuntimeError`` when it cannot be built."""
    path = build_seg_prep(cxx)
    if path in _LIBS:
        return _LIBS[path]
    lib = ctypes.CDLL(str(path))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.seg_prepare_batch.restype = ctypes.c_int
    lib.seg_prepare_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),   # imgs
        ctypes.POINTER(ctypes.c_void_p),   # labels (may be null)
        i32p,                              # heights
        i32p,                              # widths
        ctypes.c_int,                      # channels
        ctypes.c_int,                      # batch
        ctypes.POINTER(ctypes.c_float),    # scales
        i32p,                              # h_cs
        i32p,                              # w_cs
        ctypes.c_int,                      # input_sz
        i32p,                              # label_table
        ctypes.c_int,                      # table_len
        ctypes.POINTER(ctypes.c_uint8),    # imgs_out
        ctypes.POINTER(ctypes.c_uint8),    # masks_out
        ctypes.c_int,                      # num_threads
    ]
    _LIBS[path] = lib
    return lib
