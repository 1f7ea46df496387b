"""The port stands alone: nothing under vaenar_tts_torch/ and nothing in
chip_smoke.py imports JAX, flax, optax or the JAX package."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "vaenar_tts_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vaenar_tts_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_import_in_the_port():
    files = _port_files()
    assert os.path.join(REPO, "chip_smoke.py") in files and len(files) > 15
    bad = {os.path.relpath(p, REPO): sorted(set(_imported_roots(p)) & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_cli_imports_with_jax_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'optax', 'vaenar_tts_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import vaenar_tts_torch.cli.inference\n"
            "import vaenar_tts_torch.ops.flash_attention\n"
            "import vaenar_tts_torch.interop.weights\n"
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m] is not None]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
