"""The port's runtime: upload/fetch wire formats, the tile driver against
the JAX driver on one synthetic stack, resume, and the run config."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from land_trendr_tpu.io.geotiff import read_geotiff
from land_trendr_tpu.runtime import driver as jdriver
from land_trendr_tpu.runtime import faults as jfaults
from land_trendr_tpu.runtime.stack import stack_from_synthetic as jax_stack_from_synthetic
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
from land_trendr_tpu_torch.ops.tile import process_tile_dn
from land_trendr_tpu_torch.runtime import faults, feed, fetch
from land_trendr_tpu_torch.runtime.driver import (
    RunConfig,
    TileSpec,
    assemble_outputs,
    plan_tiles,
    resolve_device,
    run_stack,
)
from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

SPEC = SceneSpec(height=96, width=96, seed=5)


@pytest.fixture(scope="module")
def synth():
    return make_stack(SPEC)


@pytest.fixture(scope="module")
def stack(synth):
    return stack_from_synthetic(synth)


# ---------------------------------------------------------------------------
# upload wire format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("px", [64, 63])
@pytest.mark.parametrize("qa_dtype", [np.uint16, np.int16])
def test_pack_unpack_inputs_round_trip(rng, px, qa_dtype):
    ny = 7  # odd byte counts exercise the word padding
    dn = {
        "nir": rng.integers(-3000, 30000, size=(px, ny)).astype(np.int16),
        "swir2": rng.integers(0, 65535, size=(px, ny)).astype(np.uint16),
    }
    qa = rng.integers(0, 65535, size=(px, ny)).astype(qa_dtype)
    plan = feed.build_plan(dn, qa)
    words = feed.pack_inputs(dn, qa, plan)
    assert words.nbytes == feed.plan_wire_bytes(plan)
    out_dn, out_qa = feed.unpack_inputs(torch.from_numpy(words.view(np.int32)), plan)
    for k, a in dn.items():
        assert out_dn[k].numpy().tobytes() == a.tobytes(), k
        assert out_dn[k].shape == (px, ny)
    assert out_qa.numpy().tobytes() == qa.tobytes()
    # packing into a preallocated buffer gives the same words
    buf = np.full(words.shape, 0xFFFFFFFF, dtype=np.uint32)
    feed.pack_inputs(dn, qa, plan, out=buf)
    assert buf.tobytes() == words.tobytes()


def test_sync_upload_matches_fed_arrays(rng):
    dn = {"nir": rng.integers(0, 9999, size=(16, 5)).astype(np.int16)}
    qa = rng.integers(0, 65535, size=(16, 5)).astype(np.uint16)
    up = feed.TileUploader(torch.device("cpu"), packed=False)
    h = up.start(dn, qa)
    out_dn, out_qa = h.arrays()
    assert np.array_equal(out_dn["nir"].numpy(), dn["nir"])
    assert np.array_equal(out_qa.numpy(), qa)
    assert up.summary()["tiles"] == 1 and not up.summary()["packed"]


def test_resolve_packed_on_cpu():
    cpu = torch.device("cpu")
    assert feed.resolve_packed("auto", cpu) is False
    assert fetch.resolve_packed("auto", cpu) is False
    assert feed.resolve_packed(False, cpu) is False
    with pytest.raises(ValueError):
        feed.resolve_packed(True, cpu)
    with pytest.raises(ValueError):
        fetch.resolve_packed(True, cpu)


# ---------------------------------------------------------------------------
# fetch wire format
# ---------------------------------------------------------------------------


def _tile_out(stack, tile_px):
    t = TileSpec(0, 0, 0, 7, 9)
    from land_trendr_tpu_torch.runtime.driver import _feed_tile

    dn, qa = _feed_tile(stack, t, tile_px, ("nir", "swir2"))
    out = process_tile_dn(
        torch.from_numpy(stack.years.astype(np.int32)),
        {k: torch.from_numpy(v) for k, v in dn.items()},
        torch.from_numpy(qa),
        impl="torch",
    )
    return t, out


@pytest.mark.parametrize(
    "products,write_fitted",
    [(None, False), (None, True), (("rmse", "vertex_years"), False), (("seg_rate",), True)],
)
def test_packed_fetch_byte_identical_to_per_product(stack, products, write_fitted):
    cfg = RunConfig(products=products, write_fitted=write_fitted)
    t, out = _tile_out(stack, 64)
    fetcher = fetch.TileFetcher(cfg, torch.device("cpu"), packed=False)
    per_product, fit_a = fetcher.start(out).tile_arrays(t)
    plan = fetcher.plan
    words = fetch.pack_tile(out, plan).numpy()
    assert words.nbytes == fetch.plan_wire_bytes(plan)
    packed, mv = fetch.unpack_tile(plan, words, t.h * t.w)
    assert sorted(packed) == sorted(per_product)
    for k in packed:
        assert packed[k].dtype == per_product[k].dtype, k
        assert packed[k].tobytes() == per_product[k].tobytes(), k
    assert int(mv.sum()) == fit_a
    assert ("model_valid" in packed) == (products is None)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _read_outputs(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".tif"):
            a = read_geotiff(os.path.join(out_dir, name))[0]
            out[name[:-4]] = a[None] if a.ndim == 2 else a  # (depth, H, W)
    return out


@pytest.fixture(scope="module")
def port_run(stack, tmp_path_factory):
    root = tmp_path_factory.mktemp("port")
    cfg = RunConfig(tile_size=64, workdir=str(root / "w"), out_dir=str(root / "o"),
                    write_fitted=True)
    summary = run_stack(stack, cfg, device="cpu")
    assemble_outputs(stack, cfg)
    return cfg, summary


def test_run_summary(port_run):
    cfg, summary = port_run
    assert summary["tiles"] == 4 and summary["tiles_done"] == 4
    assert summary["pixels"] == 96 * 96
    assert 0.0 < summary["fit_rate"] <= 1.0
    assert summary["impl"] == "torch" and summary["device"] == "cpu"
    assert not summary["fetch"]["packed"] and not summary["upload"]["packed"]
    assert {"feed_s", "upload_s", "dispatch_s", "write_s"} <= set(summary["stage_s"])


def test_manifest_records_impl(port_run):
    cfg, _ = port_run
    with open(os.path.join(cfg.workdir, "manifest.jsonl")) as f:
        header = json.loads(f.readline())
    assert header["context"] == {"mesh_devices": 1, "impl": "torch"}


def test_port_rasters_match_jax_driver(synth, port_run, tmp_path):
    cfg, _ = port_run
    jcfg = jdriver.RunConfig(
        tile_size=64, workdir=str(tmp_path / "w"), out_dir=str(tmp_path / "o"),
        impl="xla", write_fitted=True,
    )
    jstack = jax_stack_from_synthetic(synth)
    jdriver.run_stack(jstack, jcfg)
    jdriver.assemble_outputs(jstack, jcfg)
    ours = _read_outputs(cfg.out_dir)
    theirs = _read_outputs(jcfg.out_dir)
    assert sorted(ours) == sorted(theirs)
    agree = (
        (ours["model_valid"] == theirs["model_valid"]).all(axis=0)
        & (ours["n_vertices"] == theirs["n_vertices"]).all(axis=0)
        & (ours["vertex_indices"] == theirs["vertex_indices"]).all(axis=0)
    )
    assert agree.mean() >= 0.999, agree.mean()
    for name, a in ours.items():
        b = theirs[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind == "f":
            d = np.abs(a[:, agree].astype(np.float64) - b[:, agree])
            d = d[np.isfinite(d)]
            # float32 tail contract (see tests/test_torch_tile.py)
            assert np.quantile(d, 0.999) <= 1e-5, name
            assert d.max() <= 5e-5, name
        else:
            assert np.array_equal(a[:, agree], b[:, agree]), name


def test_interrupted_run_resumes_byte_identical(stack, port_run, tmp_path):
    cfg, _ = port_run
    rcfg = RunConfig(tile_size=64, workdir=str(tmp_path / "w"), out_dir=str(tmp_path / "o"),
                     write_fitted=True)
    tiles = plan_tiles(*stack.shape, 64)
    first = run_stack(stack, rcfg, tiles=tiles[:3:2], device="cpu")  # "interrupted"
    assert first["tiles_done"] == 2
    with pytest.raises(RuntimeError, match="missing"):
        assemble_outputs(stack, rcfg)
    resumed = run_stack(stack, rcfg, device="cpu")
    assert resumed["tiles_skipped_resume"] == 2 and resumed["tiles_done"] == 2
    assemble_outputs(stack, rcfg)
    for t in tiles:
        name = f"tile_{t.tile_id:05d}.npz"
        with np.load(os.path.join(cfg.workdir, name)) as a, \
                np.load(os.path.join(rcfg.workdir, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (name, k)
    for name in os.listdir(cfg.out_dir):
        with open(os.path.join(cfg.out_dir, name), "rb") as fa, \
                open(os.path.join(rcfg.out_dir, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize("schedule", ["manifest.torn@1", "manifest.record@2", "fetch.wait@1"])
def test_fault_mid_run_resumes_byte_identical(stack, port_run, tmp_path, schedule):
    # a write torn after its manifest line landed, a failed persist, or a
    # failed fetch with no retry left stops the run; the resumed run
    # recomputes what is not readable and ends byte-identical to the clean
    # run
    cfg, _ = port_run
    rcfg = RunConfig(tile_size=64, workdir=str(tmp_path / "w"), out_dir=str(tmp_path / "o"),
                     write_fitted=True, max_retries=0)
    plan = faults.activate(faults.parse_schedule(schedule))
    try:
        with pytest.raises((OSError, RuntimeError), match="injected|failed after 1 attempts"):
            run_stack(stack, rcfg, device="cpu")
    finally:
        faults.deactivate()
    assert len(plan.injected()) == 1
    resumed = run_stack(stack, rcfg, device="cpu")
    assert resumed["tiles_skipped_resume"] + resumed["tiles_done"] == 4
    assert resumed["tiles_done"] >= 1
    for t in plan_tiles(*stack.shape, 64):
        name = f"tile_{t.tile_id:05d}.npz"
        with np.load(os.path.join(cfg.workdir, name)) as a, \
                np.load(os.path.join(rcfg.workdir, name)) as b:
            for k in a.files:
                assert a[k].tobytes() == b[k].tobytes(), (name, k)


def test_fault_schedule_matches_jax_grammar():
    text = "seed=9,fetch.wait@0*3=io,manifest.record%0.5,manifest.torn@1"
    ours, theirs = faults.parse_schedule(text), jfaults.parse_schedule(text)
    assert ours.seed == theirs.seed == 9
    assert [tuple(s) for s in ours.specs] == [tuple(s) for s in theirs.specs]
    for bad in ("dispatchh@1", "manifest.record", "fetch.wait%25", "fetch.wait@-1",
                "fetch.wait@0*0", "fetch.wait@0=boom"):
        with pytest.raises(ValueError):
            faults.parse_schedule(bad)


def test_no_resume_recomputes(stack, tmp_path):
    rcfg = RunConfig(tile_size=64, workdir=str(tmp_path / "w"), out_dir=str(tmp_path / "o"),
                     products=("n_vertices", "model_valid"))
    tiles = plan_tiles(*stack.shape, 64)[:1]
    run_stack(stack, rcfg, tiles=tiles, device="cpu")
    again = run_stack(stack, RunConfig(**{**rcfg.__dict__, "resume": False}), tiles=tiles,
                      device="cpu")
    assert again["tiles_skipped_resume"] == 0 and again["tiles_done"] == 1


def test_plan_tiles_edges():
    tiles = plan_tiles(100, 70, 64)
    assert [(t.y0, t.x0, t.h, t.w) for t in tiles] == [
        (0, 0, 64, 64), (0, 64, 64, 6), (64, 0, 36, 64), (64, 64, 36, 6)
    ]
    assert [t.tile_id for t in tiles] == [0, 1, 2, 3]
    jt = jdriver.plan_tiles(100, 70, 64)
    assert [(t.tile_id, t.y0, t.x0, t.h, t.w) for t in jt] == [
        (t.tile_id, t.y0, t.x0, t.h, t.w) for t in tiles
    ]


def test_feed_pads_with_fill_bit(stack):
    from land_trendr_tpu_torch.runtime.driver import _feed_tile

    t = TileSpec(3, 64, 64, 32, 32)
    dn, qa = _feed_tile(stack, t, 64 * 64, ("nir", "swir2"))
    jdn, jqa = jdriver._feed_tile(stack, t, 64 * 64, ("nir", "swir2"))
    assert qa.shape == (4096, stack.n_years)
    assert (qa[1024:] == 1).all() and (dn["nir"][1024:] == 0).all()
    assert qa.tobytes() == jqa.tobytes()
    for k in dn:
        assert dn[k].tobytes() == jdn[k].tobytes()


def test_fingerprint_matches_jax_and_ignores_impl(stack):
    ours = RunConfig(tile_size=64, impl="torch").fingerprint(stack)
    assert ours == RunConfig(tile_size=64, impl="auto").fingerprint(stack)
    assert ours == jdriver.RunConfig(tile_size=64, impl="xla").fingerprint(stack)
    assert ours != RunConfig(tile_size=32).fingerprint(stack)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"impl": "pallas"}, "impl"),
        ({"products": ("nope",)}, "unknown products"),
        ({"products": ()}, "must not be empty"),
        ({"chunk_px": 0}, "chunk_px"),
        ({"chunk_px": 1000, "impl": "cuda"}, "multiple of 128"),
        ({"tile_size": 0}, "tile_size"),
        ({"fetch_depth": 0}, "fetch_depth"),
        ({"write_workers": 0}, "write_workers"),
        ({"out_compress": "zstd"}, "out_compress"),
        ({"index": "evi"}, "unknown index"),
        ({"upload_packed": "yes"}, "upload_packed"),
        ({"ftv_indices": ("evi",)}, "unknown ftv_indices"),
        ({"ftv_indices": "ndvi"}, "must be a tuple"),
        ({"change_filt": {"max_dur": 4}}, "not a ChangeFilter"),
    ],
)

def test_run_config_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        RunConfig(**kwargs)


def test_cuda_device_required_without_fallback():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# FTV + change on the segment path
# ---------------------------------------------------------------------------

TAIL_FTV = ("ndvi", "tcw")


def _tail_out(stack, tile_px, change_filt):
    t = TileSpec(0, 0, 0, 7, 9)
    from land_trendr_tpu_torch.runtime.driver import _feed_tile

    dn, qa = _feed_tile(stack, t, tile_px, ("blue", "green", "red", "nir", "swir1", "swir2"))
    out = process_tile_dn(
        torch.from_numpy(stack.years.astype(np.int32)),
        {k: torch.from_numpy(v) for k, v in dn.items()},
        torch.from_numpy(qa),
        impl="torch", ftv_indices=TAIL_FTV, change_filt=change_filt,
    )
    return t, out


@pytest.mark.parametrize("fetch_f16", [False, True])
@pytest.mark.parametrize("products", [None, ("rmse",)])
def test_packed_fetch_with_ftv_change_byte_identical(stack, fetch_f16, products):
    from land_trendr_tpu_torch.ops.change import ChangeFilter

    cfg = RunConfig(ftv_indices=TAIL_FTV, change_filt=ChangeFilter(), fetch_f16=fetch_f16,
                    products=products)
    t, out = _tail_out(stack, 64, cfg.change_filt)
    fetcher = fetch.TileFetcher(cfg, torch.device("cpu"), packed=False)
    per_product, fit = fetcher.start(out).tile_arrays(t)
    plan = fetcher.plan
    words = fetch.pack_tile(out, plan).numpy()
    assert words.nbytes == fetch.plan_wire_bytes(plan)
    packed, mv = fetch.unpack_tile(plan, words, t.h * t.w)
    assert sorted(packed) == sorted(per_product)
    assert {"ftv_ndvi", "ftv_tcw", "change_yod", "change_mask"} <= set(packed)
    for k in packed:
        assert packed[k].dtype == per_product[k].dtype, k
        assert packed[k].tobytes() == per_product[k].tobytes(), k
    assert int(mv.sum()) == fit
    assert packed["change_yod"].dtype == np.int32 and packed["change_mask"].dtype == np.bool_
    assert packed["ftv_ndvi"].dtype == np.float32
    wires = {e.key: e.wire for e in plan.entries}
    assert (wires["ftv_ndvi"] == "float16") == fetch_f16
    assert wires["change_mask"] == "uint8"
    if fetch_f16:  # float16 on the wire, float32 on the host, within its rounding
        exact_cfg = dataclasses.replace(cfg, fetch_f16=False)
        exact = fetch.TileFetcher(exact_cfg, torch.device("cpu"), packed=False)
        full, _ = exact.start(out).tile_arrays(t)
        for k in ("ftv_ndvi", "ftv_tcw", "change_mag", "rmse"):
            np.testing.assert_allclose(packed[k], full[k], rtol=1e-3, atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def tail_runs(synth, stack, tmp_path_factory):
    """The port's and the JAX driver's run of one stack with FTV + change."""
    from land_trendr_tpu.ops.change import ChangeFilter as JChangeFilter
    from land_trendr_tpu_torch.ops.change import ChangeFilter

    root = tmp_path_factory.mktemp("tail")
    cfg = RunConfig(tile_size=64, workdir=str(root / "w"), out_dir=str(root / "o"),
                    ftv_indices=TAIL_FTV, change_filt=ChangeFilter(max_dur=4.0))
    summary = run_stack(stack, cfg, device="cpu")
    paths = assemble_outputs(stack, cfg)
    jcfg = jdriver.RunConfig(
        tile_size=64, workdir=str(root / "jw"), out_dir=str(root / "jo"), impl="xla",
        ftv_indices=TAIL_FTV, change_filt=JChangeFilter(max_dur=4.0),
    )
    jstack = jax_stack_from_synthetic(synth)
    jdriver.run_stack(jstack, jcfg)
    jdriver.assemble_outputs(jstack, jcfg)
    return cfg, summary, paths, jcfg


def test_tail_run_writes_ftv_and_change(tail_runs):
    cfg, summary, paths, _ = tail_runs
    assert summary["tiles_done"] == 4 and 0.0 < summary["fit_rate"] <= 1.0
    assert {"ftv_ndvi", "ftv_tcw"} <= set(paths)
    assert {f"change_{k}" for k in ("mask", "yod", "mag", "dur", "rate", "preval", "dsnr")} <= set(paths)


def test_tail_rasters_match_jax_driver(tail_runs):
    cfg, _, _, jcfg = tail_runs
    ours = _read_outputs(cfg.out_dir)
    theirs = _read_outputs(jcfg.out_dir)
    assert sorted(ours) == sorted(theirs)
    agree = (
        (ours["model_valid"] == theirs["model_valid"]).all(axis=0)
        & (ours["vertex_indices"] == theirs["vertex_indices"]).all(axis=0)
    )
    assert agree.mean() >= 0.999, agree.mean()
    for name in sorted(ours):
        a, b = ours[name], theirs[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind != "f":
            assert np.array_equal(a[:, agree], b[:, agree]), name
            continue
        d = np.abs(a[:, agree].astype(np.float64) - b[:, agree])
        if name == "change_dsnr":
            # |mag| / rmse: the float32 tail of rmse, relative (see
            # tests/test_torch_tile.py)
            d = d / np.maximum(np.abs(b[:, agree]), 1e-12)
            assert np.quantile(d, 0.999) <= 1e-3 and d.max() <= 5e-3, name
            continue
        d = d[np.isfinite(d)]
        assert np.quantile(d, 0.999) <= 1e-5, name
        assert d.max() <= 5e-5, name


@pytest.mark.parametrize(
    "kwargs",
    [
        {"ftv_indices": ("ndvi", "tcw")},
        {"fetch_f16": True},
        {"change": {"max_dur": 4.0, "sort": "newest"}},
        {"ftv_indices": ("tcw",), "fetch_f16": True, "change": {"kind": "recovery"}},
    ],
    ids=["ftv", "fetch_f16", "change", "all"],
)
def test_fingerprint_with_tail_matches_jax(stack, kwargs):
    from land_trendr_tpu.ops.change import ChangeFilter as JChangeFilter
    from land_trendr_tpu_torch.ops.change import ChangeFilter

    kw = dict(kwargs)
    filt = kw.pop("change", None)
    ours = RunConfig(tile_size=64, change_filt=ChangeFilter(**filt) if filt else None, **kw)
    theirs = jdriver.RunConfig(
        tile_size=64, change_filt=JChangeFilter(**filt) if filt else None, **kw
    )
    assert ours.fingerprint(stack) == theirs.fingerprint(stack)
    assert ours.fingerprint(stack) != RunConfig(tile_size=64).fingerprint(stack)
