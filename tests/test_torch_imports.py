"""repro_torch stands alone: it imports neither JAX nor anything of the JAX
package ``repro`` (not even its numpy-only modules), and neither does
``chip_smoke.py``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                  # any `import jax` now fails
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro.")
                or m == "jax" and sys.modules[m] is not None)
print(len(names), leaked)
assert not leaked, leaked
"""


def test_port_imports_with_jax_blocked_and_loads_no_repro_module():
    out = subprocess.run([sys.executable, "-c", _PROBE],
                         cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25          # every module of the port was imported


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"
