"""The port imports neither JAX nor anything of the JAX package.

An ``ast`` scan of every module of ``land_trendr_tpu_torch`` (and of
``chip_smoke.py``) compares imported module names exactly — a substring
match would hit the port's own name — and a fresh interpreter imports the
port's main path and checks that no ``jax*`` or ``land_trendr_tpu.*``
module appeared.  The subprocess is needed because this test process
imports JAX through ``tests/conftest.py``.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "land_trendr_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("land_trendr_tpu", "jax", "jaxlib")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imported(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_names_compared_exactly():
    assert _forbidden("land_trendr_tpu")
    assert _forbidden("land_trendr_tpu.ops.segment")
    assert _forbidden("jax.numpy")
    assert not _forbidden("land_trendr_tpu_torch")
    assert not _forbidden("land_trendr_tpu_torch.ops.segment")
    assert _forbidden("jaxlib")
    assert not _forbidden("numpy")


MAIN_PATH = [
    "land_trendr_tpu_torch",
    "land_trendr_tpu_torch.cli",
    "land_trendr_tpu_torch.ops.segment",
    "land_trendr_tpu_torch.ops.segment_cuda",
    "land_trendr_tpu_torch.ops.tile",
    "land_trendr_tpu_torch.ops.ftv",
    "land_trendr_tpu_torch.ops.change",
    "land_trendr_tpu_torch.tools.probe",
    "land_trendr_tpu_torch.tools.population",
    "land_trendr_tpu_torch.runtime",
    "land_trendr_tpu_torch.runtime.driver",
    "land_trendr_tpu_torch.runtime.stack",
    "land_trendr_tpu_torch.runtime.faults",
    "land_trendr_tpu_torch.io",
    "land_trendr_tpu_torch.io.blockcache",
    "land_trendr_tpu_torch.io.blockstore",
    "land_trendr_tpu_torch.obs",
    "land_trendr_tpu_torch.ops.composite",
    "land_trendr_tpu_torch.models.oracle",
    "land_trendr_tpu_torch.utils.profiling",
]


def test_main_path_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {MAIN_PATH!r}: importlib.import_module(m)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "bad = [m for m in new if m.startswith('jax') or m == 'land_trendr_tpu'"
        " or m.startswith('land_trendr_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'port': [m for m in new if m.startswith('land_trendr_tpu_torch')]}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "land_trendr_tpu_torch.runtime.driver" in res["port"]


@pytest.mark.parametrize(
    "module",
    ["obs/events.py", "obs/metrics.py", "obs/telemetry.py", "obs/spans.py",
     "obs/flight.py", "io/blockcache.py", "io/blockstore.py", "runtime/faults.py",
     "models/oracle.py", "ops/composite.py", "utils/profiling.py"],
)
def test_slice_modules_exist_and_scan_clean(module):
    path = PORT / module
    assert path in FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [n for _, n in _imported(tree) if _forbidden(n)]
