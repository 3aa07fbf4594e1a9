"""The stage metrics read the program's own spans: in a traced run on the
CPU, one record per stage and tile landed gives each stage's host time;
the device side, an untraced run, a count that does not match the tiles
and a program without a span log read as nothing."""

from __future__ import annotations

import dataclasses
import time

import pytest

from lt_bench.harness import run_cell
from lt_bench.report import result_line
from lt_bench.spec import load_cell
from lt_bench.stages import ms_per_tile

STAGES = {"wrs2-nbr40.change": ("prep", "segment", "change"),
          "wrs2-multiindex.ftv": ("prep", "segment", "ftv", "change")}


def _traced(workload: str) -> tuple[dict, dict]:
    cell = load_cell(workload)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "tile_size": 24, "check_tiles": 2,
                                              "check_rows": 64})
    out = run_cell(cell, 2**31 + 77, 60.0, True, time.perf_counter(), device="cpu",
                   size=(40, 48), warm_tiles=1, max_tiles=4)
    return out, result_line(out, traced=True)[0]


@pytest.mark.parametrize("workload", sorted(STAGES))
def test_stage_host_times_reported_device_ones_not(workload):
    out, result = _traced(workload)
    assert result["correct"] is True
    got = result["metrics"]
    for stage in STAGES[workload]:
        assert got[f"{stage}_host_ms_per_tile"]["value"] > 0
        assert got[f"{stage}_host_ms_per_tile"]["unit"] == "ms"
    # the CPU has no device events, and its per-product fetch packs nothing
    assert not [m for m in got if m.endswith("_device_ms_per_tile")]
    assert "pack_host_ms_per_tile" not in got
    assert "ftv_host_ms_per_tile" not in got or workload == "wrs2-multiindex.ftv"
    run = out["run"]
    assert ms_per_tile(run, "lt_tile_prep", "host") == got["prep_host_ms_per_tile"]["value"]
    # a count that is not the window's tiles (as after a dropped record)
    # reads nothing: the same window with two of its tiles
    ends = dataclasses.replace(run, tiles=[run.tiles[0], run.tiles[-1]])
    assert ms_per_tile(ends, "lt_tile_prep", "host") is None
    # nor does an untraced run
    assert ms_per_tile(dataclasses.replace(run, trace=None), "lt_tile_prep", "host") is None


def test_a_program_without_the_span_log_reads_nothing(monkeypatch):
    from land_trendr_tpu_torch.utils import profiling

    out, _ = _traced("wrs2-nbr40.change")
    monkeypatch.delattr(profiling, "SPAN_LOG")
    assert ms_per_tile(out["run"], "lt_tile_prep", "host") is None
