"""The port's lint checks, driven through the JAX package's ``lintkit`` by
import (lintkit itself is not edited, and not ported: it never touches a
device).

* **LT011 over the port.**  ``SeamCoverageChecker`` reads
  ``land_trendr_tpu/runtime/faults.py``, ``tools/fault_soak.py`` and the
  ``land_trendr_tpu/`` tree, so the port's package is copied to
  ``tmp/land_trendr_tpu/`` and its soak to ``tmp/tools/fault_soak.py``
  (copied, not linked: ``os.walk`` does not follow symlinked dirs); every
  seam must be registered, fired and soaked.
* **A torch host-sync rule in the spirit of LT002** over the port's
  ``runtime/``, ``obs/``, ``parallel/``, ``serve/`` and ``fleet/``
  (``runtime/fetch.py`` and ``runtime/feed.py`` blessed: they are the
  transfer paths): ``.item()``, ``.cpu()``, ``.numpy()``, ``np.asarray(``
  and ``synchronize()`` are findings unless an inline ``# lt:
  noqa[LT002]`` gives the reason.
* **LT004's config ↔ CLI ↔ README triangles** over the port's
  ``RunConfig``, ``ServeConfig``, ``RouterConfig`` and ``LoadConfig`` and
  its ``cli.py``, against README.md's configuration tables; the only
  finding allowed is the documented exception (``impl``: the device
  decides, no ``--impl``; the JAX ``--platform`` is the port's
  ``--device``, which is not a config field).
"""

import ast
import os
import shutil
from pathlib import Path
from typing import Iterator

import pytest

from land_trendr_tpu.lintkit.configdoc import ConfigDocChecker
from land_trendr_tpu.lintkit.core import Checker, FileCtx, Finding, RepoCtx, run_rules
from land_trendr_tpu.lintkit.seamcover import SeamCoverageChecker

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "land_trendr_tpu_torch"


def _py_files(root: Path) -> "list[str]":
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _dirs, fs in os.walk(root) for f in fs if f.endswith(".py")
    )


@pytest.fixture()
def port_as_reference(tmp_path) -> Path:
    """The port laid out where lintkit's reference rules look."""
    shutil.copytree(PORT, tmp_path / "land_trendr_tpu",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (tmp_path / "tools").mkdir()
    shutil.copy(PORT / "tools" / "fault_soak.py", tmp_path / "tools" / "fault_soak.py")
    return tmp_path


def test_lt011_seam_coverage_over_the_port(port_as_reference):
    repo = RepoCtx(str(port_as_reference), files=_py_files(port_as_reference))
    findings = list(SeamCoverageChecker().check(repo))
    assert findings == [], [f.render() for f in findings]


def test_lt011_flags_a_seam_the_soak_drops(port_as_reference):
    """Negative control: the copied check bites when a seam loses its case."""
    soak = port_as_reference / "tools" / "fault_soak.py"
    src = soak.read_text()
    assert '    "loadgen.tick",' in src
    soak.write_text(src.replace('    "loadgen.tick",', "", 1))
    repo = RepoCtx(str(port_as_reference), files=_py_files(port_as_reference))
    findings = list(SeamCoverageChecker().check(repo))
    assert len(findings) == 1 and "'loadgen.tick'" in findings[0].message


#: the port's modules that handle device values
SYNC_SCOPE = (
    "land_trendr_tpu_torch/runtime/",
    "land_trendr_tpu_torch/obs/",
    "land_trendr_tpu_torch/parallel/",
    "land_trendr_tpu_torch/serve/",
    "land_trendr_tpu_torch/fleet/",
)
#: the transfer paths: each owns its sanctioned wait point
SYNC_BLESSED = (
    "land_trendr_tpu_torch/runtime/fetch.py",
    "land_trendr_tpu_torch/runtime/feed.py",
)


class TorchHostSyncChecker(Checker):
    """LT002 for PyTorch: a blocking device→host read or a device-wide
    sync outside the transfer paths stalls the pipeline for a round trip."""

    rule_id = "LT002"
    title = "blocking host sync outside runtime/fetch.py and runtime/feed.py"

    @staticmethod
    def kind(node: ast.Call) -> "str | None":
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            return None
        bare = not node.args and not node.keywords
        base = fn.value.id if isinstance(fn.value, ast.Name) else None
        if fn.attr in ("item", "cpu", "numpy") and bare:
            return f".{fn.attr}() (device->host read)"
        if fn.attr == "asarray" and base in ("np", "numpy"):
            return "np.asarray (device->host materialization)"
        if fn.attr == "synchronize":
            return "synchronize() (host blocks on the device)"
        return None

    def check_file(self, ctx: FileCtx) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        if path in SYNC_BLESSED or not path.startswith(SYNC_SCOPE):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                kind = self.kind(node)
                if kind is not None:
                    yield Finding(ctx.path, node.lineno, self.rule_id,
                                  f"{kind} outside the transfer paths")


def _port_repo() -> RepoCtx:
    return RepoCtx(str(ROOT), files=[f for f in _py_files(ROOT)
                                     if f.startswith("land_trendr_tpu_torch/")])


def test_torch_host_sync_rule_over_the_port():
    res = run_rules(_port_repo(), [TorchHostSyncChecker()])
    assert res["findings"] == [], [f.render() for f in res["findings"]]
    # the sanctioned sites carry their reasons: the sharded call's gather
    # and summary (parallel/mesh.py) and the pod's host rows
    # (parallel/multihost.py)
    assert res["noqa_suppressed"] == 6


def test_torch_host_sync_rule_bites(tmp_path):
    """Negative control on a synthetic module in scope."""
    mod = tmp_path / "land_trendr_tpu_torch" / "runtime" / "stray.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(
        "import numpy as np\nimport torch\n\n"
        "def f(x):\n"
        "    a = x.item()\n"
        "    b = x.cpu()\n"
        "    c = x.numpy()\n"
        "    d = np.asarray(x)\n"
        "    torch.cuda.synchronize()\n"
        "    e = x.cpu()  # lt: noqa[LT002]\n"
        "    return a, b, c, d, e, x.to('cpu'), x.sum(dim=0)\n"
    )
    blessed = tmp_path / "land_trendr_tpu_torch" / "runtime" / "fetch.py"
    blessed.write_text("def g(x):\n    return x.cpu()\n")
    res = run_rules(RepoCtx(str(tmp_path), files=_py_files(tmp_path)),
                    [TorchHostSyncChecker()])
    assert [f.line for f in res["findings"]] == [5, 6, 7, 8, 9]
    assert res["noqa_suppressed"] == 1


#: LT004's triangles, each file at the path the rule reads
_CONFIG_FILES = {
    "land_trendr_tpu/runtime/driver.py": "runtime/driver.py",
    "land_trendr_tpu/serve/config.py": "serve/config.py",
    "land_trendr_tpu/fleet/config.py": "fleet/config.py",
    "land_trendr_tpu/loadgen/config.py": "loadgen/config.py",
    "land_trendr_tpu/cli.py": "cli.py",
}
#: the documented exceptions: RunConfig.impl has no --impl (the device
#: decides the implementation)
ALLOWED = {("land_trendr_tpu/runtime/driver.py", "RunConfig.impl has no CLI flag")}


def test_lt004_config_cli_readme_triangles_over_the_port(tmp_path):
    for dst, src in _CONFIG_FILES.items():
        (tmp_path / dst).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(PORT / src, tmp_path / dst)
    shutil.copy(ROOT / "README.md", tmp_path / "README.md")
    repo = RepoCtx(str(tmp_path), files=list(_CONFIG_FILES))
    findings = list(ConfigDocChecker().check(repo))
    got = {(f.file, f.message.split(" on the ")[0].split(" (expected")[0]) for f in findings}
    assert got == ALLOWED, [f.render() for f in findings]
    # the port's cli has --device where the JAX one has --platform
    assert "--device" in (PORT / "cli.py").read_text()
