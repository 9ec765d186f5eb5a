"""The port stands alone: importing ``repro_torch`` and every submodule loads
neither JAX nor the JAX package ``repro``, and neither the port's sources,
``chip_smoke.py``, the GPU tools under ``tools/`` nor the port's examples
(``examples/*_torch.py``) import them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN or top.startswith("jax")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jaxlib', 'repro')\n"
        "             or k.split('.')[0].startswith('jax'))\n"
        "print(len(names), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 15
    assert bad.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "src" / "repro_torch").rglob("*.py"),
              REPO / "chip_smoke.py", *(REPO / "tools").glob("*.py"),
              *(REPO / "examples").glob("*_torch.py")]))
def test_sources_import_no_jax(path):
    bad = [m for m in _imported_modules(REPO / path) if _forbidden(m)]
    assert bad == [], bad
