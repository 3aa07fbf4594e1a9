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
    segall = {m["name"] for m in metrics_of(b, "end_to_end", "wrs2-nbr40.segall")}
    assert change == {"px_per_s", "tile_p95_ms", "setup_s"}
    assert ftv == {"px_per_s", "setup_s"}
    assert segall == {"px_per_s", "tile_p95_ms", "setup_s"}
    # a stage a cell does not run is not asked of it
    layers = {w: {m["name"] for m in metrics_of(b, "per_layer", w)}
              for w in ("wrs2-nbr40.change", "wrs2-multiindex.ftv", "wrs2-nbr40.segall")}
    assert {"change_host_ms_per_tile", "change_device_ms_per_tile"} <= (
        layers["wrs2-nbr40.change"] & layers["wrs2-multiindex.ftv"])
    assert not {m for m in layers["wrs2-nbr40.segall"] if m.startswith(("change_", "ftv_"))}
    assert "pack_device_ms_per_tile" in layers["wrs2-nbr40.segall"]


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


_DELEGATE = """from lt_bench.reference import tile

spec_of = tile.spec_of
reference_products = tile.reference_products


def bands_of(config):
    return tile.bands_of(config)


def series_per_px(config):
    return 2
"""


def test_a_configuration_added_from_new_files_alone(tmp_path):
    """A later PR adds a configuration with its own run settings and its
    own reference module, a mix, a cell and its limits as new files and
    entries; the harness, unchanged, builds the program from the
    configuration's ``"run"`` object, checks against the configuration's
    reference and counts the kernel's bytes by its series a pixel."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "lt_bench", root / "lt_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    b = _bench()
    b["configs"].append({"name": "wrs2-pair", "source": "test", "reduced": [], "why": "test",
                         "file": "lt_bench/configs/wrs2-pair.json"})
    b["workloads"].append({"name": "wrs2-pair.seg", "config": "wrs2-pair",
                           "traffic": "seg-32", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    config = json.loads((ROOT / "lt_bench/configs/wrs2-nbr40.json").read_text())
    config.update(name="wrs2-pair", reference="pair", run={"fetch_depth": 1})
    (root / "lt_bench/configs/wrs2-pair.json").write_text(json.dumps(config))
    (root / "lt_bench/reference/pair.py").write_text(_DELEGATE)
    (root / "lt_bench/traffic/seg-32.json").write_text(json.dumps({
        "name": "seg-32", "why": "test", "tile_size": 32, "products": ["rmse", "vertex_years"],
        "change": False, "check_tiles": 2, "check_rows": 1024}))
    (root / "lt_bench/limits/wrs2-pair.seg.json").write_text(
        json.dumps({"worst_gap": {"limit": 1e-5}}))

    import time
    import types

    from lt_bench.harness import program_config, reference_spec, run_cell
    from lt_bench.reference.tile import RefSpec
    from lt_bench.report import result_line
    from lt_bench.spec import load_reference

    cell = load_cell("wrs2-pair.seg", root)
    ref = load_reference(cell)
    assert ref.__file__ == str(root / "lt_bench/reference/pair.py")
    assert program_config(cell).fetch_depth == 1
    assert program_config(load_cell("wrs2-nbr40.change", root)).fetch_depth == 2
    assert reference_spec(cell) == RefSpec(products=("rmse", "vertex_years"))

    def run(seed):
        out = run_cell(cell, seed, 60.0, False, time.perf_counter(), device="cpu",
                       size=(40, 48), warm_tiles=1, max_tiles=3)
        return result_line(out, traced=False)

    result, compared = run(12)
    assert result["correct"] is True and compared["worst_gap"][0] == 0.0
    assert set(result["metrics"]) == {"px_per_s", "setup_s"}

    # the check reads the configuration's module: one that is off fails it
    (root / "lt_bench/reference/pair.py").write_text(_DELEGATE + """

def reference_products(years, dn, qa, spec, chunk):
    out = tile.reference_products(years, dn, qa, spec, chunk)
    out["rmse"] = out["rmse"] + 1e-3
    return out
""")
    result, compared = run(12)
    assert result["correct"] is False and compared["worst_gap"][0] > 1e-4

    # two series a pixel: twice the frozen bytes of the pixels landed
    from lt_bench.yardstick import segment_kernel_bytes

    op = types.SimpleNamespace(kind="kernel", name="segment_fused_kernel<float>",
                               start=0.0, end=1.0)
    fake = types.SimpleNamespace(
        cell=cell, device_kind="NVIDIA H100 80GB HBM3", launches=4,
        tiles=[types.SimpleNamespace(px=1000)], trace=types.SimpleNamespace(ops=[op]))
    got = load_reader("kernel_roofline_pct", root)(fake)
    assert got == 100.0 * segment_kernel_bytes(2000, 40, 6, launches=4) / 3.35e12
