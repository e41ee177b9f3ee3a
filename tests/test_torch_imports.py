"""The port stands alone: no module under ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX, anything of the JAX package ``repro``, or
``ml_dtypes`` (bf16 travels as raw bytes), read from the sources and
checked in a fresh interpreter."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_repro(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in FILES if p.name != "chip_smoke.py"]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("module", ["repro_torch.serving.engine",
                                    "repro_torch.serving.serve_step",
                                    "repro_torch.launch.serve"])
def test_serving_imports_with_jax_blocked(module):
    """The serving modules import in an interpreter where ``import jax``
    and ``import repro`` fail, and load nothing of either."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            f"import {module}\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            f"m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
