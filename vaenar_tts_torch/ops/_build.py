"""Build the package's CUDA sources with ``nvcc`` into one shared library
with a plain C interface, and load it with ``ctypes``.

The library goes to ``vaenar_tts_torch/_build/<hash>/``, keyed by a hash of
the sources, headers and flags, at first use; later calls in the process
reuse the loaded handle. Each ``.cu`` compiles in its own ``nvcc`` process,
all started together, and one more links the objects. Nothing here runs at
import time, and nothing includes PyTorch's headers, so a build takes
seconds.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (C function, pointer arguments): the fp32 kernels (SIMT FMAs, but for the
# forward at D >= 128, 3xTF32 on the tensor cores) and the bf16 tensor-core
# kernels
KERNELS = (("masked_attention_fwd", 8),
           ("masked_attention_bwd_dq", 11),
           ("masked_attention_bwd_dkv", 11),
           ("masked_attention_fwd_tc", 8),
           ("masked_attention_bwd_dq_tc", 11),
           ("masked_attention_bwd_dkv_tc", 11))

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
    for path in srcs + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
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
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o") for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    tmp = f"{lib}.{tag}"
    cmds.append([nvcc, "-shared", "-o", tmp, *objs])
    if all(proc.returncode == 0 for proc in procs):
        link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        procs.append(link)
        outputs.append(link.stdout)
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write("".join(outputs))
    for obj in objs:
        os.remove(obj)
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


def argtypes(n_ptr: int) -> list:
    """The ctypes argument types of a kernel's C function: ``n_ptr``
    pointers, then B, H, Tq, Tk, D, scale, causal, stream."""
    return ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def load_library() -> ctypes.CDLL:
    """Build if needed, then load once per process."""
    if "lib" not in _loaded:
        lib = ctypes.CDLL(build())
        for name, n_ptr in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = argtypes(n_ptr)
            fn.restype = ctypes.c_int
            shared = getattr(lib, f"{name}_shared_bytes")
            shared.argtypes = []
            shared.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]
