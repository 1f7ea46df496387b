"""The ctypes bindings of the port's CUDA kernels, read statically.

Every ``extern "C" int <name>(...)`` in ``vaenar_tts_torch/csrc/*.cu`` is
parsed, and each kernel function must stand in ``_build.KERNELS`` with the
argument types that ``load_library`` gives ctypes (its pointer count), and
the reverse; each must also export
``<name>_shared_bytes(void)``. A wrong row passes pointers into the wrong
slots on the card, so this is checked here, where there is no nvcc.
"""

import ctypes
import glob
import os
import re

import pytest

from vaenar_tts_torch.ops import _build

_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _ctype(param: str):
    """The ctypes type of one C parameter ("const void* q", "int B", ...)."""
    if "*" in param:
        return ctypes.c_void_p
    kind = param.split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def _declarations() -> dict:
    """{C function: [ctypes type of each parameter]} over every source."""
    decls = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            for name, params in _DECL.findall(f.read()):
                params = " ".join(params.split())
                decls[name] = ([] if params in ("", "void")
                               else [_ctype(p.strip()) for p in params.split(",")])
    return decls


def test_sources_declare_kernels():
    assert _build.sources(), "no csrc/*.cu found"
    assert len(_declarations()) == 2 * len(_build.KERNELS)


@pytest.mark.parametrize("name,n_ptr", _build.KERNELS,
                         ids=[row[0] for row in _build.KERNELS])
def test_kernels_row_matches_its_c_signature(name, n_ptr):
    decls = _declarations()
    assert name in decls, f"{name} is in KERNELS but no source declares it"
    assert decls[name] == _build.argtypes(n_ptr), name
    assert decls.get(f"{name}_shared_bytes") == [], f"{name}_shared_bytes(void) is missing"


def test_every_c_kernel_is_in_kernels():
    bound = {row[0] for row in _build.KERNELS}
    kernels = {n for n in _declarations() if not n.endswith("_shared_bytes")}
    assert kernels == bound
