"""A configuration's run settings and reference come from its own files,
and the cells that bring neither build what the harness built before it
took them from there: the same ``RunConfig``, tile program call,
reference spec, bands and kernel bytes."""

from __future__ import annotations

import dataclasses
import inspect
import types

import pytest

from lt_bench.harness import (
    DERIVED, _bands, program_config, reference_spec, tile_program_args,
)
from lt_bench.spec import load_cell, load_reader

CELLS = ["wrs2-nbr40.change", "wrs2-multiindex.ftv", "wrs2-nbr40.segall"]


def _old_program_config(cell):
    """``program_config`` as the harness wrote it out field by field."""
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops.change import ChangeFilter
    from land_trendr_tpu_torch.runtime.driver import RunConfig

    c, t = cell.config, cell.traffic
    return RunConfig(
        index=c["index"],
        ftv_indices=tuple(c["ftv_indices"]),
        params=LTParams(**c["params"]),
        tile_size=int(t["tile_size"]),
        products=tuple(t["products"]),
        change_filt=ChangeFilter(**c["change_filter"]) if t["change"] else None,
        scale=float(c["scale"]),
        offset=float(c["offset"]),
    )


def _old_reference_spec(cell):
    from lt_bench.reference.change import ChangeFilter
    from lt_bench.reference.params import LTParams
    from lt_bench.reference.tile import RefSpec

    c, t = cell.config, cell.traffic
    return RefSpec(
        index=c["index"],
        params=LTParams(**c["params"]),
        ftv_indices=tuple(c["ftv_indices"]),
        change_filt=ChangeFilter(**c["change_filter"]) if t["change"] else None,
        products=tuple(t["products"]),
        scale=float(c["scale"]),
        offset=float(c["offset"]),
    )


@pytest.mark.parametrize("workload", CELLS)
def test_program_config_as_before(workload):
    cell = load_cell(workload)
    assert "run" not in cell.config
    assert program_config(cell) == _old_program_config(cell)
    assert program_config(cell, fetch_f16=True) == dataclasses.replace(
        _old_program_config(cell), fetch_f16=True)


@pytest.mark.parametrize("workload", CELLS)
def test_tile_program_call_as_before(workload):
    cfg = program_config(load_cell(workload))
    assert tile_program_args(cfg) == dict(
        index=cfg.index, params=cfg.params, scale=cfg.scale, offset=cfg.offset,
        reject_bits=cfg.reject_bits, chunk=cfg.chunk_px,
        ftv_indices=cfg.ftv_indices, change_filt=cfg.change_filt,
    )


@pytest.mark.parametrize("workload", CELLS)
def test_reference_spec_and_bands_as_before(workload):
    from lt_bench.reference.indices import required_bands

    cell = load_cell(workload)
    assert "reference" not in cell.config
    assert reference_spec(cell) == _old_reference_spec(cell)
    c = cell.config
    assert _bands(cell) == required_bands(c["index"], tuple(c["ftv_indices"]))


@pytest.mark.parametrize("workload", CELLS)
def test_kernel_bytes_as_before(workload):
    """One series a pixel: the reading is the frozen bytes of the real
    pixels landed, as before."""
    from lt_bench.yardstick import segment_kernel_bytes

    cell = load_cell(workload)
    px = [1024 * 1024, 904 * 1024]
    op = types.SimpleNamespace(kind="kernel", name="segment_fused_kernel<float>",
                               start=0.0, end=0.25)
    run = types.SimpleNamespace(
        cell=cell, device_kind="NVIDIA H100 80GB HBM3", launches=8,
        tiles=[types.SimpleNamespace(px=p) for p in px],
        trace=types.SimpleNamespace(ops=[op]))
    old = 100.0 * (segment_kernel_bytes(sum(px), 40, 6, launches=8) / 3.35e12) / 0.25
    assert load_reader("kernel_roofline_pct")(run) == old


def test_every_tile_program_parameter_is_a_run_config_field():
    """A parameter renamed on one side and not the other fails here, not
    by silently taking its default in the window."""
    from land_trendr_tpu_torch.ops.tile import process_tile_dn
    from land_trendr_tpu_torch.runtime.driver import RunConfig

    fields = {f.name for f in dataclasses.fields(RunConfig)}
    params = set(inspect.signature(process_tile_dn).parameters)
    rest = params - {"years", "dn_bands", "qa", "impl", "chunk"}
    assert rest and rest <= fields, sorted(rest - fields)
    assert "chunk_px" in fields


@pytest.mark.parametrize("field", DERIVED)
def test_a_run_object_naming_a_derived_field_raises(field):
    cell = load_cell("wrs2-nbr40.change")
    cell = dataclasses.replace(cell, config={**cell.config, "run": {field: None}})
    with pytest.raises(ValueError, match="derives"):
        program_config(cell)


def test_a_run_object_sets_the_other_fields():
    cell = load_cell("wrs2-nbr40.change")
    run = {"fetch_depth": 1, "chunk_px": 131_072, "reject_bits": 1 | 8}
    cell = dataclasses.replace(cell, config={**cell.config, "run": run})
    cfg = program_config(cell)
    old = _old_program_config(cell)
    assert dataclasses.replace(cfg, **{k: getattr(old, k) for k in run}) == old
    assert (cfg.fetch_depth, cfg.chunk_px, cfg.reject_bits) == (1, 131_072, 9)
    args = tile_program_args(cfg)
    assert (args["chunk"], args["reject_bits"]) == (131_072, 9)
    # a field RunConfig lacks fails as it would in any caller
    cell2 = dataclasses.replace(cell, config={**cell.config, "run": {"no_such_field": 1}})
    with pytest.raises(TypeError):
        program_config(cell2)
