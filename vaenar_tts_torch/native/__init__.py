"""The native batch packer (``batchpack.cc``, after
``vaenar_tts_tpu/native/batchpack.cc`` but one call per batch), built with
``g++`` and loaded with ctypes.

``get_batchpack()`` returns the ``pack_rows`` entry point, or None when the
library cannot be built or loaded; the loader then gathers with numpy and
says so (``BucketedLoader.packer``). The library is built at first use into
``vaenar_tts_torch/_build/native-<fingerprint>/``, the fingerprint a hash of
the source, the machine and the CPU model: a ``-march=native`` binary built
on another host (a shared checkout) is rebuilt, not loaded. The compiler
writes to a name of its own process, renamed into place when it is done,
so that two processes building it at once never expose half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "batchpack.cc")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")
LIB_NAME = "libbatchpack.so"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_state: dict = {}


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def library_path() -> str:
    """Where the library of this source, machine and CPU lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(f"{platform.machine()}|{_cpu_model()}".encode())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}", LIB_NAME)


def build() -> str:
    """Compile ``batchpack.cc`` unless its library is there; return the
    library's path. Raises if ``g++`` fails."""
    lib = library_path()
    if os.path.isfile(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def get_batchpack():
    """The ctypes ``pack_rows`` function, or None when the library cannot
    be built or loaded (the reason stays in ``failure()``). Tried once per
    process."""
    with _lock:
        if "fn" not in _state:
            _state["fn"] = None
            try:
                fn = ctypes.CDLL(build()).pack_rows
                i64, vp = ctypes.c_int64, ctypes.c_void_p
                fn.argtypes = [vp, i64, i64, vp, i64, vp, i64, vp, vp]
                fn.restype = None
                _state["fn"] = fn
            except Exception as e:  # no compiler, a read-only tree, a bad binary
                _state["failure"] = repr(e)
        return _state["fn"]


def failure() -> Optional[str]:
    """Why the library is not available, or None."""
    return _state.get("failure")
