"""The import rule, by whole top-level module name: nothing the benchmark
runs on the card imports JAX or the JAX package (``land_trendr_tpu``, a
prefix of the port's own name), and the reference imports nothing of the
program either."""

from __future__ import annotations

import ast
from pathlib import Path

from lt_bench.harness import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parent.parent


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources(sub: str = "") -> list[Path]:
    root = HERE / sub if sub else HERE
    return sorted(p for p in root.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def test_no_module_on_the_card_imports_jax_or_the_jax_package():
    files = _sources()
    assert len(files) > 10
    for path in files:
        bad = _top_level_imports(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(HERE)} imports {sorted(bad)}"


def test_the_reference_imports_nothing_of_the_program():
    files = _sources("reference")
    assert {p.name for p in files} >= {"segment.py", "ftv.py", "indices.py", "change.py", "tile.py"}
    for path in files:
        names = _top_level_imports(path)
        assert not names & {*FORBIDDEN, "land_trendr_tpu_torch"}, path.name
        assert names <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch", "lt_bench"}


def test_top_level_names_are_compared_whole():
    mods = ["land_trendr_tpu_torch", "land_trendr_tpu_torch.ops.tile", "jaxtyping", "flaxen",
            "numpy"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules([*mods, "land_trendr_tpu.ops", "jax", "jaxlib.xla_client",
                              "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "land_trendr_tpu.ops"]


def test_this_process_would_pass_once_the_port_is_loaded():
    """Loading the program and the harness loads none of them (the CPU
    test process may hold JAX from elsewhere, so this checks what the
    harness's own imports pull in, in a fresh interpreter)."""
    import subprocess
    import sys

    code = (
        "import lt_bench.harness, lt_bench.report, lt_bench.readings, lt_bench.gen;"
        "import land_trendr_tpu_torch.ops.tile, land_trendr_tpu_torch.runtime.fetch;"
        "import land_trendr_tpu_torch.runtime.driver;"
        "from lt_bench.harness import forbidden_modules; print(forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=HERE.parent, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_a_module_loaded_by_a_metric_reader_stops_the_result(monkeypatch, capsys):
    """The look at ``sys.modules`` comes after the result line is built (the
    metric readers are loaded then), so what a reader pulls in stops the
    run: exit 3 and no result printed."""
    import torch

    import lt_bench.__main__ as entry
    import lt_bench.harness as harness
    import lt_bench.report as report

    loaded: list[str] = []

    def result_line(out, traced):
        loaded.append("jax")  # a reader that loads JAX through another module
        return {"correct": True}, {"worst_gap": (0.0, 3e-5)}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"marks": {}})
    monkeypatch.setattr(harness, "forbidden_modules", lambda: list(loaded))
    monkeypatch.setattr(report, "result_line", result_line)
    rc = entry.main(["--workload", "wrs2-nbr40.change", "--seed", "1", "--seconds", "1",
                     "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 3
    assert captured.out == ""
    assert "['jax']" in captured.err
