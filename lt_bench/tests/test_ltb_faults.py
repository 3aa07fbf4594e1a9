"""``correct`` comes out false when the timed path is broken underneath.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU (the plain version stands in for the kernel there) at a
small size, with every row of every landed tile checked, with one fault
of those the cells can have planted in the program: a step that hands
back the state of the first tile for every tile, half of the batch left
out (its rows filled from the other half), an answer altered where it is
produced, and the control — the program's own float16 fetch path.  The
exchange between cards has no counterpart: both cells run on one card.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import pytest
import torch

from lt_bench.harness import run_cell
from lt_bench.report import result_line
from lt_bench.spec import load_cell


CELLS = ["wrs2-nbr40.change", "wrs2-multiindex.ftv", "wrs2-nbr40.segall"]


def _run(workload: str, **kw) -> tuple[bool, float]:
    cell = load_cell(workload)
    cell = dataclasses.replace(
        cell, traffic={**cell.traffic, "tile_size": 24, "check_tiles": 7, "check_rows": 576})
    out = run_cell(cell, 2**31 + 21, 60.0, False, time.perf_counter(), device="cpu",
                   size=(40, 60), warm_tiles=1, max_tiles=6, **kw)
    result, compared = result_line(out, traced=False)
    assert out["checked"]["rows"] == 40 * 60  # every row of the scene
    return result["correct"], compared["worst_gap"][0]


def _patch(monkeypatch, wrap):
    import land_trendr_tpu_torch.ops.tile as tile

    real = tile.process_tile_dn
    # wrapped, so that the harness still reads the real parameters' names
    faulty = functools.wraps(real)(lambda *a, **k: wrap(real, *a, **k))
    monkeypatch.setattr(tile, "process_tile_dn", faulty)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    assert _run(workload) == (True, 0.0)


@pytest.mark.parametrize("workload", CELLS)
def test_state_left_unchanged_is_caught(monkeypatch, workload):
    first = []

    def stale(real, *a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]

    _patch(monkeypatch, stale)
    assert _run(workload)[0] is False


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_batch_left_out_is_caught(monkeypatch, workload):
    def half(real, years, dn, qa, **k):
        n = qa.shape[0] // 2
        out = real(years, {b: a[:n] for b, a in dn.items()}, qa[:n], **k)
        twice = lambda t: torch.cat([t, t])  # noqa: E731
        return out._replace(
            seg=type(out.seg)(*(twice(f) for f in out.seg)),
            ftv={name: twice(v) for name, v in out.ftv.items()},
            change=out.change and {name: twice(v) for name, v in out.change.items()},
        )

    _patch(monkeypatch, half)
    assert _run(workload)[0] is False


@pytest.mark.parametrize("product", ["mag", "yod", "ftv", "vertex_years", "rmse"])
def test_an_answer_altered_where_produced_is_caught(monkeypatch, product):
    workload = {"ftv": "wrs2-multiindex.ftv", "mag": "wrs2-nbr40.change",
                "yod": "wrs2-nbr40.change"}.get(product, "wrs2-nbr40.segall")

    def altered(real, *a, **k):
        out = real(*a, **k)
        if product == "ftv":
            out.ftv["tcw"][7, 3] += 1e-3
        elif product in ("mag", "yod"):
            out.change[product][7] += 1e-3 if product == "mag" else 1
        else:
            getattr(out.seg, product)[7] += 1 if product == "vertex_years" else 1e-3
        return out

    _patch(monkeypatch, altered)
    correct, gap = _run(workload)
    assert correct is False and gap > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(workload):
    """The program with its float16 fetch switched on: every float product
    rounded to half precision on the way over."""
    correct, gap = _run(workload, fetch_f16=True)
    assert correct is False and gap > 1e-4
