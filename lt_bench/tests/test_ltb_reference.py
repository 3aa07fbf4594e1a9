"""The benchmark's reference against the port's plain version, on small
seeded tiles of both configurations (the only place the two meet)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from lt_bench.compare import product_gaps
from lt_bench.harness import make_cell_scene, program_config, reference_spec
from lt_bench.reference.tile import SEG_PRODUCTS, reference_products
from lt_bench.spec import load_cell


def _port_products(cell, scene, k: int) -> dict[str, np.ndarray]:
    """Tile ``k`` through the port's tile program and its fetch (the
    per-product path the CPU takes), cropped to the real pixels."""
    from land_trendr_tpu_torch.ops.tile import process_tile_dn
    from land_trendr_tpu_torch.runtime.fetch import TileFetcher

    cfg = program_config(cell)
    dn, qa = scene.tile_inputs(k)
    out = process_tile_dn(
        scene.years, dn, qa, index=cfg.index, params=cfg.params, scale=cfg.scale,
        offset=cfg.offset, reject_bits=cfg.reject_bits, chunk=cfg.chunk_px,
        ftv_indices=cfg.ftv_indices, change_filt=cfg.change_filt,
    )
    handle = TileFetcher(cfg, torch.device("cpu"), packed=False).start(out)
    arrays, model_valid = handle.rows(scene.tiles[k].px)
    arrays.setdefault("model_valid", model_valid)
    return arrays


@pytest.mark.parametrize("workload", ["wrs2-nbr40.change", "wrs2-multiindex.ftv",
                                      "wrs2-nbr40.segall"])
@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_reference_equals_the_port_plain_version(workload, seed):
    cell = load_cell(workload)
    # every segmentation product too, not only the cell's fetched set
    cell = dataclasses.replace(
        cell, traffic={**cell.traffic, "tile_size": 24, "products": list(SEG_PRODUCTS)})
    scene = make_cell_scene(cell, seed, "cpu", size=(30, 44))
    spec = reference_spec(cell)
    for k in (0, len(scene.tiles) - 1):  # a full tile and the corner tile
        port = _port_products(cell, scene, k)
        dn, qa = scene.tile_inputs(k)
        px = scene.tiles[k].px
        ref = reference_products(
            scene.years, {b: a[:px] for b, a in dn.items()}, qa[:px], spec, chunk=128)
        assert set(port) == set(ref)
        gaps = product_gaps(port, ref)
        assert max(gaps.values()) == 0.0, gaps
        assert port["model_valid"].any()
        if cell.config["ftv_indices"]:
            assert {"ftv_ndvi", "ftv_tcw"} <= set(ref)
        assert ("change_mag" in ref) == cell.traffic["change"]


def test_gap_rules():
    a = np.array([0.5, 2.0, np.nan], np.float32)
    assert product_gaps({"x": a}, {"x": a.copy()}) == {"x": 0.0}
    b = np.array([0.5 + 1e-3, 2.0 * (1 + 1e-3), np.nan], np.float32)
    g = product_gaps({"x": b}, {"x": a})["x"]
    assert g == pytest.approx(1e-3, rel=1e-3)  # absolute under 1, relative above
    assert product_gaps({"x": np.array([np.nan])}, {"x": np.array([1.0])})["x"] == np.inf
    assert product_gaps({"y": np.array([2023], np.int32)}, {"y": np.array([2022], np.int32)})["y"] == 1
    assert product_gaps({"m": np.array([True])}, {"m": np.array([False])})["m"] == 1
    assert product_gaps({"x": a}, {})["x"] == np.inf
    assert product_gaps({"x": a[:2]}, {"x": a})["x"] == np.inf
