"""The PyTorch port stands alone: no file under `src/repro_torch/`, and not
`chip_smoke.py` or the port's card tools under `tools/`, imports `jax`,
anything of the JAX package `repro`, or `msgpack` (the card's machine has
none; the port's checkpoints use `repro_torch.ckpt.msgpack_codec`)
(checked on the source, with an AST walk), and importing every module of
the port leaves them out of `sys.modules`. The port keeps its own copies of
the JAX package's numpy-only modules instead.

`chip_smoke.py` needs a CUDA device and the repository beside it: without
either it exits non-zero and prints no result line.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_is_checked():
    """The walk above covers every package of the port (a new subpackage
    cannot slip past it)."""
    packages = {p.parent for p in PORT.rglob("__init__.py")}
    assert packages == {p.parent for p in SOURCES if p.name == "__init__.py"}
    assert {"core", "kernels", "serve", "data", "configs", "models"} <= {
        p.name for p in packages}


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'msgpack'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20, proc.stdout


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ("repo", "alone"))
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the smoke run would run")
        cwd = ROOT
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"kernels"' not in proc.stdout
