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
    # ``tools`` is the JAX package's script directory (the port keeps its
    # own copies of what it needs from there)
    return top in ("land_trendr_tpu", "jax", "jaxlib", "tools")


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
    assert _forbidden("tools._measure")
    assert not _forbidden("land_trendr_tpu_torch.tools.measure")


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
    "land_trendr_tpu_torch.runtime.leases",
    "land_trendr_tpu_torch.parallel",
    "land_trendr_tpu_torch.parallel.mesh",
    "land_trendr_tpu_torch.parallel.multihost",
    "land_trendr_tpu_torch.tune",
    "land_trendr_tpu_torch.tune.store",
    "land_trendr_tpu_torch.tune.probes",
    "land_trendr_tpu_torch.tune.autotune",
    "land_trendr_tpu_torch.obs.publish",
    "land_trendr_tpu_torch.obs.history",
    "land_trendr_tpu_torch.obs.alerts",
    "land_trendr_tpu_torch.obs.aggregate",
    "land_trendr_tpu_torch.serve",
    "land_trendr_tpu_torch.serve.programs",
    "land_trendr_tpu_torch.serve.jobs",
    "land_trendr_tpu_torch.serve.config",
    "land_trendr_tpu_torch.serve.batching",
    "land_trendr_tpu_torch.serve.server",
    "land_trendr_tpu_torch.obs.reqtrace",
    "land_trendr_tpu_torch.fleet",
    "land_trendr_tpu_torch.fleet.config",
    "land_trendr_tpu_torch.fleet.scheduling",
    "land_trendr_tpu_torch.fleet.autoscale",
    "land_trendr_tpu_torch.fleet.journal",
    "land_trendr_tpu_torch.fleet.capacity",
    "land_trendr_tpu_torch.fleet.router",
    "land_trendr_tpu_torch.loadgen",
    "land_trendr_tpu_torch.loadgen.config",
    "land_trendr_tpu_torch.loadgen.trace",
    "land_trendr_tpu_torch.loadgen.runner",
    "land_trendr_tpu_torch.tools.measure",
    "land_trendr_tpu_torch.tools.parity_f32",
    "land_trendr_tpu_torch.tools.impl_identity",
    "land_trendr_tpu_torch.tools.fault_soak",
    "land_trendr_tpu_torch.tools.elastic_worker",
    "land_trendr_tpu_torch.tools.elastic_soak",
    "land_trendr_tpu_torch.tools.lt_request",
    "land_trendr_tpu_torch.tools.capacity_bench",
    "land_trendr_tpu_torch.tools.fleet_bench",
]


def test_main_path_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {MAIN_PATH!r}: importlib.import_module(m)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "bad = [m for m in new if m.startswith('jax') or m == 'land_trendr_tpu'"
        " or m.startswith('land_trendr_tpu.') or m == 'tools' or m.startswith('tools.')]\n"
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
    assert "land_trendr_tpu_torch.serve.server" in res["port"]
    assert "land_trendr_tpu_torch.fleet.router" in res["port"]
    assert "land_trendr_tpu_torch.loadgen.runner" in res["port"]
    assert "land_trendr_tpu_torch.tools.fault_soak" in res["port"]


@pytest.mark.parametrize(
    "module",
    ["obs/events.py", "obs/metrics.py", "obs/telemetry.py", "obs/spans.py",
     "obs/flight.py", "io/blockcache.py", "io/blockstore.py", "runtime/faults.py",
     "models/oracle.py", "ops/composite.py", "utils/profiling.py",
     "runtime/leases.py", "parallel/mesh.py", "parallel/multihost.py",
     "tune/store.py", "tune/probes.py", "tune/autotune.py",
     "obs/publish.py", "obs/history.py", "obs/alerts.py", "obs/aggregate.py",
     "serve/__init__.py", "serve/programs.py", "serve/jobs.py", "serve/config.py",
     "serve/batching.py", "serve/server.py",
     "obs/reqtrace.py", "fleet/__init__.py", "fleet/config.py", "fleet/scheduling.py",
     "fleet/autoscale.py", "fleet/journal.py", "fleet/capacity.py", "fleet/router.py",
     "loadgen/__init__.py", "loadgen/config.py", "loadgen/trace.py", "loadgen/runner.py",
     "tools/measure.py", "tools/parity_f32.py", "tools/impl_identity.py",
     "tools/fault_soak.py", "tools/elastic_worker.py", "tools/elastic_soak.py",
     "tools/lt_request.py", "tools/capacity_bench.py", "tools/fleet_bench.py"],
)
def test_slice_modules_exist_and_scan_clean(module):
    path = PORT / module
    assert path in FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [n for _, n in _imported(tree) if _forbidden(n)]
