"""The PyTorch port stands alone: no file of ``sm3det_tpu_torch``, nor
``chip_smoke.py`` or the port's profiling scripts
(``tools/profiling/torch_*.py``), imports JAX, its libraries or the JAX
package, and importing every module of the port loads no JAX."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "sm3det_tpu"}
SCRIPTS = [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "tools" / "profiling").glob("torch_*.py"))


def _port_files():
    return sorted((ROOT / "sm3det_tpu_torch").rglob("*.py")) + SCRIPTS


def _imported_names(tree):
    """Top-level names of every import, ``__import__`` and
    ``importlib.import_module`` call with a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_no_jax_imports_in_the_port():
    files = _port_files()
    assert len(files) > 20
    found = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name in _imported_names(tree):
            if name.split(".")[0] in BANNED:
                found.append(f"{path.relative_to(ROOT)}: {name}")
    assert not found, found


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in _port_files() if p not in SCRIPTS]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {sorted(BANNED)!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
