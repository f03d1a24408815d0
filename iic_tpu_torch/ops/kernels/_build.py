"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``iic_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the repository
root, on first use, and loaded with ``ctypes``. The hash covers the source,
the headers it may include (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. The sources have a plain C interface and include no PyTorch header,
so a build takes seconds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -Xptxas -v: each build prints every kernel's registers, shared memory
# and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}
BUILD_SECONDS = {}  # name -> seconds nvcc took in this process (0.0: cached)
LIB_PATHS = {}      # name -> the loaded library's path


def cuda_tool(name="nvcc"):
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", name), shutil.which(name)]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA "
                       f"toolkit (set CUDA_HOME)")


def library(name):
    """The loaded ``ctypes.CDLL`` for ``csrc/<name>.cu``, built if needed."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        if proc.stderr.strip():
            print(proc.stderr.strip())
        os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    LIB_PATHS[name] = out
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]
