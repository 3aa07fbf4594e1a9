"""On the card: a run of each cell's own tile shape is correct, and the
control — the program with its float16 fetch path switched on — is not.

The cells' own measurement of the control is ``python3 -m
lt_bench.readings`` at their full size; this keeps it at a size a test
run holds (a smaller scene, the cell's tile).  Skips without a card.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from lt_bench.harness import run_cell
from lt_bench.report import result_line
from lt_bench.spec import load_cell

SIZES = {"wrs2-nbr40.change": (1100, 1300), "wrs2-multiindex.ftv": (2100, 2200),
         "wrs2-nbr40.segall": (1100, 1300)}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_program_correct_and_control_not(card, workload):
    cell = load_cell(workload)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "check_tiles": 5})
    seen = {}
    for control in (False, True):
        out = run_cell(cell, 2**31 + 101, 2.0, True, time.perf_counter(), device=card,
                       fetch_f16=control, size=SIZES[workload], warm_tiles=2)
        result, compared = result_line(out, traced=True)
        seen[control] = (result["correct"], compared["worst_gap"][0])
        assert result["device"]["busy_s"] > 0
        assert "kernel_roofline_pct" in result["metrics"]
    assert seen[False] == (True, 0.0)
    assert seen[True][0] is False and seen[True][1] > 1e-4
