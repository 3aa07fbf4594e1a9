"""The LandTrendr multispectral ensemble on the port: further indices
segmented in the same call as the primary one.

On the CPU (the plain version): the stacked call equals each index
segmented alone, chunked or not; ``RunConfig.ensemble_indices`` is
validated, fingerprinted only when set, and reaches the tile program
through ``Run``, the mesh path and ``segment --ensemble``; the fetch plan
gains ``ens_<index>_<product>`` entries after today's; ``Run.execute()``
writes rasters equal to the benchmark's independent reference
(``lt_bench/reference/ensemble.py``); serve refuses the field.
"""

import os

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io.geotiff import read_geotiff
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.ops.tile import process_tile_dn
from land_trendr_tpu_torch.runtime.driver import (
    Run,
    RunConfig,
    assemble_outputs,
    run_stack,
)
from land_trendr_tpu_torch.runtime.fetch import TileFetcher, build_plan
from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic
from land_trendr_tpu_torch.utils import profiling

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

ENSEMBLE = ("ndvi", "ndmi", "tcb", "tcg", "tcw")
PARAMS = LTParams(max_segments=4, vertex_count_overshoot=2)


@pytest.fixture(scope="module")
def synth():
    return make_stack(SceneSpec(height=16, width=20, year_start=1990, year_end=2013, seed=13))


@pytest.fixture(scope="module")
def tile(synth):
    """The scene as one tile of pixel-major DNs and QA, all six bands."""
    ny, px = len(synth.years), 16 * 20
    dn = {b: torch.from_numpy(np.ascontiguousarray(synth.dn(b).reshape(ny, px).T))
          for b in idx.BANDS}
    qa = torch.from_numpy(np.ascontiguousarray(synth.qa.reshape(ny, px).T.astype(np.uint16)))
    return torch.from_numpy(synth.years.astype(np.int32)), dn, qa


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN where NaN)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("chunk", [None, 448, 1000, 4096])
def test_stacked_segmentation_equals_each_index_alone(tile, chunk):
    # 6 x 320 = 1,920 rows: 448 pads them (five chunks, 320 padding rows),
    # 1,000 chunks the stack where one index alone fits a chunk
    years, dn, qa = tile
    out = process_tile_dn(years, dn, qa, params=PARAMS, chunk=chunk, ensemble_indices=ENSEMBLE)
    assert list(out.ens) == list(ENSEMBLE)
    for name in ("nbr", *ENSEMBLE):
        alone = process_tile_dn(years, dn, qa, index=name, params=PARAMS, chunk=chunk).seg
        got = out.seg if name == "nbr" else out.ens[name]
        for field, a, b in zip(got._fields, got, alone):
            assert _same(a, b), (name, field)
        assert bool(got.model_valid.any())
    assert out.ftv == {} and out.change is None


def test_without_an_ensemble_the_tile_program_is_todays(tile):
    years, dn, qa = tile
    out = process_tile_dn(years, dn, qa, params=PARAMS, chunk=448)
    assert dict(out.ens) == {}
    cfg = RunConfig(products=("rmse", "vertex_years"))
    plan = build_plan(out, cfg)
    assert [e.key for e in plan.entries] == ["vertex_years", "rmse", ""]


def test_plan_adds_each_index_after_todays_entries(tile):
    years, dn, qa = tile
    products = ("vertex_fit_vals", "seg_magnitude", "rmse")
    out = process_tile_dn(years, dn, qa, params=PARAMS, ensemble_indices=("tcb", "ndmi"))
    plan = build_plan(out, RunConfig(products=products, ensemble_indices=("tcb", "ndmi")))
    today = build_plan(out._replace(ens={}), RunConfig(products=products))
    assert plan.entries[:len(today.entries)] == today.entries
    rest = plan.entries[len(today.entries):]
    assert [e.key for e in rest] == [f"ens_{i}_{p}" for i in ("tcb", "ndmi") for p in products]
    # each index flips by its own sign: TCB rises under disturbance
    signs = {(e.key, e.signed, e.sign) for e in rest if e.key.endswith("_seg_magnitude")}
    assert signs == {("ens_tcb_seg_magnitude", True, 1.0), ("ens_ndmi_seg_magnitude", True, -1.0)}
    arrays, _ = TileFetcher(RunConfig(products=products), torch.device("cpu"),
                            packed=False).start(out).rows(320)
    assert set(arrays) == {*products, *(e.key for e in rest)}
    np.testing.assert_array_equal(arrays["ens_tcb_seg_magnitude"],
                                  out.ens["tcb"].seg_magnitude.numpy())
    np.testing.assert_array_equal(arrays["ens_ndmi_seg_magnitude"],
                                  -out.ens["ndmi"].seg_magnitude.numpy())


def test_ensemble_stage_span_between_prep_and_segment(tile):
    years, dn, qa = tile
    profiling.SPAN_LOG.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        process_tile_dn(years, dn, qa, params=PARAMS, chunk=448, ensemble_indices=("tcb",))
        process_tile_dn(years, dn, qa, params=PARAMS, chunk=448)
    names = [r.name for r in profiling.SPAN_LOG.records()]
    profiling.SPAN_LOG.clear()
    assert names == ["lt_tile_prep", "lt_tile_ensemble", "lt_tile_segment",
                     "lt_tile_prep", "lt_tile_segment"]


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(ensemble_indices=("evi",)), "unknown ensemble_indices"),
        (dict(ensemble_indices=["ndvi"]), "must be a tuple"),
        (dict(ensemble_indices=("ndvi", "NDVI")), "each index once"),
        (dict(ensemble_indices=("nbr",)), "not the primary index"),
        (dict(index="tcb", ensemble_indices=("tcb", "nbr")), "not the primary index"),
    ],
)
def test_run_config_rejects_a_bad_ensemble(kwargs, match):
    with pytest.raises(ValueError, match=match):
        RunConfig(**kwargs)


def test_fingerprint_holds_the_ensemble_only_when_set(synth):
    stack = stack_from_synthetic(synth)
    base = RunConfig().fingerprint(stack)
    assert RunConfig(ensemble_indices=()).fingerprint(stack) == base
    one = RunConfig(ensemble_indices=("tcb",)).fingerprint(stack)
    assert one != base
    assert RunConfig(ensemble_indices=("tcb", "tcg")).fingerprint(stack) not in (base, one)


def test_required_bands_of_the_new_indices():
    assert idx.required_bands("ndmi") == ("nir", "swir1")
    assert idx.required_bands("nbr", ("ndmi",)) == ("nir", "swir1", "swir2")
    assert idx.required_bands("tcb") == idx.required_bands("tcg") == idx.BANDS


def _rasters(out_dir: str) -> dict[str, np.ndarray]:
    """Every raster of ``out_dir`` as (H, W, depth)."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".tif"):
            a = read_geotiff(os.path.join(out_dir, name))[0]
            out[name[:-4]] = a[..., None] if a.ndim == 2 else np.moveaxis(a, 0, -1)
    return out


@pytest.fixture(scope="module")
def ensemble_run(synth, tmp_path_factory):
    root = tmp_path_factory.mktemp("ens")
    stack = stack_from_synthetic(synth)
    cfg = RunConfig(tile_size=8, chunk_px=96, params=PARAMS, ensemble_indices=ENSEMBLE,
                    workdir=str(root / "w"), out_dir=str(root / "o"))
    summary = Run(stack, cfg, device="cpu").execute()
    paths = assemble_outputs(stack, cfg, device="cpu")
    return stack, cfg, summary, paths


def test_run_writes_rasters_equal_to_the_reference(synth, ensemble_run):
    """Every raster of a ``Run.execute()`` with an ensemble, each index's
    own included, against the benchmark's reference module: each index
    segmented separately, in plain PyTorch of its own."""
    from lt_bench.reference import ensemble as ref
    from lt_bench.reference.params import LTParams as RefParams

    stack, cfg, summary, paths = ensemble_run
    assert summary["tiles_done"] == 6
    got = _rasters(cfg.out_dir)
    h, w, ny = 16, 20, len(synth.years)
    spec = ref.EnsembleSpec(ensemble=ENSEMBLE, params=RefParams(max_segments=4,
                                                                vertex_count_overshoot=2))
    dn = {b: torch.from_numpy(np.ascontiguousarray(synth.dn(b).reshape(ny, h * w).T))
          for b in ref.bands_of({})}
    qa = torch.from_numpy(np.ascontiguousarray(synth.qa.reshape(ny, h * w).T.astype(np.uint16)))
    want = ref.reference_products(torch.from_numpy(synth.years.astype(np.int32)), dn, qa,
                                  spec, chunk=100)
    assert set(got) == set(want) == set(paths)
    assert {f"ens_{i}_{p}" for i in ENSEMBLE for p in ("rmse", "seg_rate")} <= set(got)
    for name, a in want.items():
        a = a.reshape(h, w, -1)
        if a.dtype == np.bool_:
            a = a.astype(np.uint8)
        assert got[name].dtype == a.dtype, name
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    assert got["ens_tcb_model_valid"].any()


def test_mesh_run_carries_the_ensemble(synth, ensemble_run, tmp_path):
    stack, cfg, _, _ = ensemble_run
    mesh_cfg = RunConfig(tile_size=8, chunk_px=96, params=PARAMS, ensemble_indices=ENSEMBLE,
                         workdir=str(tmp_path / "w"), out_dir=str(tmp_path / "o"))
    run_stack(stack, mesh_cfg, device="cpu", mesh=["cpu", "cpu"])
    assemble_outputs(stack, mesh_cfg, device="cpu")
    one, two = _rasters(cfg.out_dir), _rasters(mesh_cfg.out_dir)
    assert set(one) == set(two)
    for name in one:
        np.testing.assert_array_equal(one[name], two[name], err_msg=name)


def test_cli_segment_ensemble_reaches_the_run(tmp_path, monkeypatch):
    from land_trendr_tpu_torch.cli import build_parser, main
    from land_trendr_tpu_torch.runtime import driver

    args = build_parser().parse_args(["segment", "S", "--ensemble", "ndmi, tcb"])
    assert args.ensemble == "ndmi, tcb"
    assert build_parser().parse_args(["segment", "S", "--ensemble-indices", "tcg"]).ensemble == "tcg"
    seen = []
    real = driver.Run.__init__

    def spy(self, stack, cfg, *a, **k):
        seen.append(cfg.ensemble_indices)
        real(self, stack, cfg, *a, **k)

    monkeypatch.setattr(driver.Run, "__init__", spy)
    assert main(["--device", "cpu", "synth", str(tmp_path / "D"), "--size", "16"]) == 0
    rc = main(["--device", "cpu", "segment", str(tmp_path / "D"), "--tile-size", "16",
               "--max-segments", "4", "--products", "rmse", "--ensemble", "ndmi,tcb",
               "--workdir", str(tmp_path / "W"), "--out-dir", str(tmp_path / "O")])
    assert rc == 0 and seen == [("ndmi", "tcb")]
    assert {"rmse.tif", "ens_ndmi_rmse.tif", "ens_tcb_rmse.tif"} <= set(os.listdir(tmp_path / "O"))
    assert main(["--device", "cpu", "segment", str(tmp_path / "D"), "--ensemble", "evi",
                 "--workdir", str(tmp_path / "W2"), "--out-dir", str(tmp_path / "O2")]) == 2


def test_serve_refuses_an_ensemble():
    from land_trendr_tpu_torch.serve.jobs import JobRequest

    with pytest.raises(ValueError, match="ensemble_indices"):
        JobRequest.from_payload({"stack_dir": "s", "run_overrides": {"ensemble_indices": ["tcb"]}})
    assert JobRequest.from_payload({"stack_dir": "s", "run_overrides": {"fetch_depth": 1}})
