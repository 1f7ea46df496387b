"""Build the package's CUDA sources with ``nvcc`` into one shared library
with a plain C interface, and load it with ``ctypes``.

The library goes to ``vaenar_tts_torch/_build/<hash>/``, keyed by a hash of
the sources and flags, at first use; later calls in the process reuse the
loaded handle. Nothing here runs at import time, and nothing includes
PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_ROOT = os.path.join(PACKAGE_DIR, "_build")
LIB_NAME = "libvaenar_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, under $CUDA_HOME/bin, or at /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME/bin or at "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest(srcs: list) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile every ``csrc/*.cu`` into one library; return its path. The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside it as ``ptxas.log``. Raises if the build fails."""
    srcs = sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs))
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


def ptxas_report() -> Optional[str]:
    """The compiler's register and shared-memory report of the current
    build, or None before the first build."""
    log = os.path.join(BUILD_ROOT, _digest(sources()), "ptxas.log")
    if not os.path.isfile(log):
        return None
    with open(log) as f:
        return f.read()


def load_library() -> ctypes.CDLL:
    """Build if needed, then load once per process."""
    if "lib" not in _loaded:
        lib = ctypes.CDLL(build())
        fn = lib.masked_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.masked_attention_fwd_shared_bytes.argtypes = []
        lib.masked_attention_fwd_shared_bytes.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]
