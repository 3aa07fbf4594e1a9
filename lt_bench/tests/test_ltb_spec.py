"""The benchmark's pieces are found by name, and ``BENCHMARK.json`` keeps
to its contract (names, units, keys, files, bounds)."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from lt_bench.spec import ROOT, load_cell, load_reader, metrics_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _bench(root=ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_its_contract():
    b = _bench()
    assert set(b) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
    names = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in names
            names.add((kind, e["name"]))
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        with open(ROOT / c["file"]) as f:
            assert sorted(json.load(f)["reduced"]) == sorted(c["reduced"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in [*b["end_to_end"], *b["per_layer"]]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    used = set()
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        used.add(w["config"])
        cell = load_cell(w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got
            assert _line(m["layer"])
        assert cell.limits
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for m in [*b["end_to_end"], *b["per_layer"]]:
        assert callable(load_reader(m["name"])), m["name"]


def test_metrics_of_follows_the_workloads_key():
    b = _bench()
    change = {m["name"] for m in metrics_of(b, "end_to_end", "wrs2-nbr40.change")}
    ftv = {m["name"] for m in metrics_of(b, "end_to_end", "wrs2-multiindex.ftv")}
    assert change == {"px_per_s", "tile_p95_ms", "setup_s"}
    assert ftv == {"px_per_s", "setup_s"}


def test_cell_pieces_found_by_name():
    cell = load_cell("wrs2-multiindex.ftv")
    assert cell.config["ftv_indices"] == ["ndvi", "tcw"]
    assert cell.traffic["tile_size"] == 2048
    assert "worst_gap" in cell.limits
    assert load_cell("wrs2-nbr40.change").traffic["tile_size"] == 1024
    with pytest.raises(KeyError, match="no workload"):
        load_cell("no-such.cell")


def test_a_cell_added_from_new_files_alone(tmp_path):
    """A later PR adds a mix, a cell, its limits and a metric as new files
    and entries; the harness, unchanged, finds and runs them."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "lt_bench", root / "lt_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    b = _bench()
    b["workloads"].append({"name": "wrs2-nbr40.aoi32", "config": "wrs2-nbr40",
                           "traffic": "aoi-32", "chips": 1, "why": "small study areas"})
    b["per_layer"].append({"name": "tiles_per_s.aoi", "unit": "1/s", "better": "higher",
                           "source": "host_clock", "layer": "device", "moves": "px_per_s",
                           "workloads": ["wrs2-nbr40.aoi32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "lt_bench/traffic/aoi-32.json").write_text(json.dumps({
        "name": "aoi-32", "why": "test", "tile_size": 32, "products": ["model_valid"],
        "change": True, "check_tiles": 2, "check_rows": 1024}))
    (root / "lt_bench/limits/wrs2-nbr40.aoi32.json").write_text(
        json.dumps({"worst_gap": {"limit": 1e-5}}))
    (root / "lt_bench/metrics/tiles_per_s.aoi.py").write_text(
        "def read(run):\n    return len(run.tiles) / run.window_s\n")
    cell = load_cell("wrs2-nbr40.aoi32", root)
    assert cell.traffic["tile_size"] == 32 and cell.root == root
    assert [m["name"] for m in cell.per_layer][-1] == "tiles_per_s.aoi"
    # the other cells do not report it
    assert "tiles_per_s.aoi" not in {m["name"] for m in load_cell("wrs2-nbr40.change", root).per_layer}

    import time

    from lt_bench.harness import run_cell
    from lt_bench.report import result_line

    out = run_cell(cell, 11, 60.0, True, time.perf_counter(), device="cpu", size=(40, 48),
                   warm_tiles=1, max_tiles=3)
    result, compared = result_line(out, traced=True)
    assert result["correct"] is True and compared["worst_gap"][0] == 0.0
    assert result["metrics"]["tiles_per_s.aoi"]["value"] > 0
