"""The ensemble cell, ``wrs2-ensemble6.seg``, through the unchanged harness.

Its configuration brings a ``"run"`` object (``ensemble_indices``) and its
own reference module (``reference/ensemble.py``): the ``RunConfig`` and
the tile program get the field, the reference gives six bands and six
series a pixel, the port's plain version equals the reference on seeded
tiles, the planted faults and the control come out incorrect, its stage
span is read, and on the card a run is correct and the control is not.
The three older cells' wire bytes are pinned beside the ensemble's.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import types

import numpy as np
import pytest
import torch

from lt_bench.compare import product_gaps
from lt_bench.harness import (
    _bands, make_cell_scene, program_config, reference_spec, run_cell, tile_program_args,
)
from lt_bench.reference.tile import SEG_PRODUCTS, SIGNED_PRODUCTS
from lt_bench.report import result_line
from lt_bench.spec import load_cell, load_reader, load_reference, metrics_of

WORKLOAD = "wrs2-ensemble6.seg"

#: the ensemble configuration's further indices, by its ``"run"`` object
ENSEMBLE = ("ndvi", "ndmi", "tcb", "tcg", "tcw")


def test_run_object_reaches_the_run_config():
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.runtime.driver import RunConfig

    cell = load_cell(WORKLOAD)
    c, t = cell.config, cell.traffic
    assert c["run"] == {"ensemble_indices": list(ENSEMBLE)}
    want = RunConfig(
        index=c["index"], ftv_indices=(), params=LTParams(**c["params"]),
        tile_size=int(t["tile_size"]), products=tuple(t["products"]), change_filt=None,
        scale=float(c["scale"]), offset=float(c["offset"]), ensemble_indices=ENSEMBLE)
    assert program_config(cell) == want
    assert program_config(cell, fetch_f16=True) == dataclasses.replace(want, fetch_f16=True)


def test_tile_program_gets_the_ensemble():
    cfg = program_config(load_cell(WORKLOAD))
    assert tile_program_args(cfg) == dict(
        index="nbr", params=cfg.params, scale=cfg.scale, offset=cfg.offset,
        reject_bits=cfg.reject_bits, chunk=cfg.chunk_px, ftv_indices=(),
        change_filt=None, ensemble_indices=ENSEMBLE,
    )


def test_reference_spec_and_bands():
    from lt_bench.reference.ensemble import EnsembleSpec, series_per_px
    from lt_bench.reference.indices import BANDS
    from lt_bench.reference.params import LTParams

    cell = load_cell(WORKLOAD)
    c = cell.config
    assert c["reference"] == "ensemble"
    assert reference_spec(cell) == EnsembleSpec(
        ensemble=ENSEMBLE, params=LTParams(**c["params"]),
        products=tuple(cell.traffic["products"]))
    assert _bands(cell) == BANDS
    assert series_per_px(c) == 6


def _roofline(cell, launches: int) -> float:
    px = [1024 * 1024, 904 * 1024]
    op = types.SimpleNamespace(kind="kernel", name="segment_fused_kernel<float>",
                               start=0.0, end=0.25)
    run = types.SimpleNamespace(
        cell=cell, device_kind="NVIDIA H100 80GB HBM3", launches=launches,
        tiles=[types.SimpleNamespace(px=p) for p in px],
        trace=types.SimpleNamespace(ops=[op]))
    return load_reader("kernel_roofline_pct")(run)


def test_kernel_bytes_count_six_series_a_pixel():
    """Six series a pixel: six times segall's kernel bytes at equal pixels
    (the years are read once a launch, so six times the launches too)."""
    from lt_bench.yardstick import segment_kernel_bytes

    cell = load_cell(WORKLOAD)
    px = 1024 * 1024 + 904 * 1024
    want = 100.0 * (segment_kernel_bytes(6 * px, 40, 6, launches=8) / 3.35e12) / 0.25
    assert _roofline(cell, 8) == want
    six = 6 * _roofline(load_cell("wrs2-nbr40.segall"), 8)
    assert _roofline(cell, 48) == pytest.approx(six, rel=1e-12)


@pytest.mark.parametrize("workload,per_px", [
    ("wrs2-nbr40.change", 26), ("wrs2-multiindex.ftv", 346), ("wrs2-nbr40.segall", 197),
    (WORKLOAD, 798),
])
def test_wire_bytes_a_pixel(workload, per_px):
    """Each cell's fetch, by the port's own plan: the three older cells'
    bytes as before the ensemble, the ensemble's 133 B/px an index."""
    from land_trendr_tpu_torch.ops.tile import process_tile_dn
    from land_trendr_tpu_torch.runtime.fetch import TileFetcher, plan_wire_bytes

    cell = load_cell(workload)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "tile_size": 16})
    scene = make_cell_scene(cell, 3, "cpu", size=(16, 16))
    cfg = program_config(cell)
    dn, qa = scene.tile_inputs(0)
    fetcher = TileFetcher(cfg, torch.device("cpu"), packed=False)
    fetcher.start(process_tile_dn(scene.years, dn, qa, **tile_program_args(cfg)))
    assert plan_wire_bytes(fetcher.plan) == per_px * fetcher.plan.px


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_reference_equals_the_port_plain_version(seed):
    """Every segmentation product of all six indices, the port's tile
    program and fetch against ``reference/ensemble.py``: gap 0.0, every
    ``ens_*`` key on both sides, each index in its natural orientation."""
    from land_trendr_tpu_torch.ops.tile import process_tile_dn
    from land_trendr_tpu_torch.runtime.fetch import TileFetcher

    cell = load_cell(WORKLOAD)
    cell = dataclasses.replace(
        cell, traffic={**cell.traffic, "tile_size": 24, "products": list(SEG_PRODUCTS)})
    scene = make_cell_scene(cell, seed, "cpu", size=(30, 44))
    cfg = program_config(cell)
    spec = reference_spec(cell)
    reference_products = load_reference(cell).reference_products
    for k in (0, len(scene.tiles) - 1):  # a full tile and the corner tile
        dn, qa = scene.tile_inputs(k)
        px = scene.tiles[k].px
        out = process_tile_dn(scene.years, dn, qa, **tile_program_args(cfg))
        handle = TileFetcher(cfg, torch.device("cpu"), packed=False).start(out)
        port, model_valid = handle.rows(px)
        port.setdefault("model_valid", model_valid)
        ref = reference_products(
            scene.years, {b: a[:px] for b, a in dn.items()}, qa[:px], spec, chunk=128)
        assert set(port) == set(ref)
        assert {f"ens_{i}_{p}" for i in ENSEMBLE for p in SEG_PRODUCTS} == {
            name for name in ref if name.startswith("ens_")}
        gaps = product_gaps(port, ref)
        assert max(gaps.values()) == 0.0, gaps
        for i in ENSEMBLE:
            # TCB lands as fitted, the others flipped back
            sign = 1.0 if i == "tcb" else -1.0
            assert port[f"ens_{i}_model_valid"].any()
            for p in SIGNED_PRODUCTS:
                fitted = getattr(out.ens[i], p)[:px].numpy()
                np.testing.assert_array_equal(port[f"ens_{i}_{p}"], sign * fitted)


def test_metrics_asked_of_the_cell():
    from lt_bench.spec import ROOT
    import json

    with open(ROOT / "BENCHMARK.json") as f:
        b = json.load(f)
    assert {m["name"] for m in metrics_of(b, "end_to_end", WORKLOAD)} == {"px_per_s", "setup_s"}
    ens = {m["name"] for m in metrics_of(b, "per_layer", WORKLOAD)}
    assert {"ensemble_host_ms_per_tile", "ensemble_device_ms_per_tile",
            "kernel_roofline_pct", "segment_device_ms_per_tile"} <= ens
    assert not {m for m in ens if m.startswith(("change_", "ftv_"))}
    for w in ("wrs2-nbr40.change", "wrs2-multiindex.ftv", "wrs2-nbr40.segall"):
        assert not {m["name"] for m in metrics_of(b, "per_layer", w)
                    if m["name"].startswith("ensemble_")}


# -- faults: the run on the CPU with every row checked ------------------------


def _run(**kw) -> tuple[bool, float]:
    cell = load_cell(WORKLOAD)
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


def test_sound_run_is_correct():
    assert _run() == (True, 0.0)


def test_state_left_unchanged_is_caught(monkeypatch):
    first = []

    def stale(real, *a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]

    _patch(monkeypatch, stale)
    assert _run()[0] is False


def test_half_the_batch_left_out_is_caught(monkeypatch):
    def half(real, years, dn, qa, **k):
        n = qa.shape[0] // 2
        out = real(years, {b: a[:n] for b, a in dn.items()}, qa[:n], **k)
        twice = lambda t: torch.cat([t, t])  # noqa: E731
        return out._replace(
            seg=type(out.seg)(*(twice(f) for f in out.seg)),
            ens={name: type(s)(*(twice(f) for f in s)) for name, s in out.ens.items()},
        )

    _patch(monkeypatch, half)
    assert _run()[0] is False


@pytest.mark.parametrize("index", ["tcb", "ndmi"])
def test_an_answer_altered_where_produced_is_caught(monkeypatch, index):
    def altered(real, *a, **k):
        out = real(*a, **k)
        out.ens[index].seg_magnitude[7, 2] += 1e-3
        return out

    _patch(monkeypatch, altered)
    correct, gap = _run()
    assert correct is False and gap > 0


def test_the_control_fails():
    correct, gap = _run(fetch_f16=True)
    assert correct is False and gap > 1e-4


# -- the stage span ------------------------------------------------------------


def test_stage_host_times_reported_device_ones_not():
    from lt_bench.stages import ms_per_tile

    cell = load_cell(WORKLOAD)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "tile_size": 24, "check_tiles": 2,
                                              "check_rows": 64})
    out = run_cell(cell, 2**31 + 77, 60.0, True, time.perf_counter(), device="cpu",
                   size=(40, 48), warm_tiles=1, max_tiles=4)
    result = result_line(out, traced=True)[0]
    assert result["correct"] is True
    got = result["metrics"]
    for stage in ("prep", "ensemble", "segment"):
        assert got[f"{stage}_host_ms_per_tile"]["value"] > 0
        assert got[f"{stage}_host_ms_per_tile"]["unit"] == "ms"
    assert not [m for m in got if m.endswith("_device_ms_per_tile")]
    assert ms_per_tile(out["run"], "lt_tile_ensemble", "host") == (
        got["ensemble_host_ms_per_tile"]["value"])


# -- on the card ---------------------------------------------------------------


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_program_correct_and_control_not_on_card(card):
    cell = load_cell(WORKLOAD)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "check_tiles": 5})
    seen = {}
    for control in (False, True):
        out = run_cell(cell, 2**31 + 101, 2.0, True, time.perf_counter(), device=card,
                       fetch_f16=control, size=(1100, 1300), warm_tiles=2)
        result, compared = result_line(out, traced=True)
        seen[control] = (result["correct"], compared["worst_gap"][0])
        assert result["device"]["busy_s"] > 0
        assert "kernel_roofline_pct" in result["metrics"]
        assert "ensemble_device_ms_per_tile" in result["metrics"]
    assert seen[False] == (True, 0.0)
    assert seen[True][0] is False and seen[True][1] > 1e-4
