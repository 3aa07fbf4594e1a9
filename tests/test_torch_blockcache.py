"""The port's feed cache, decode pool, readahead and ingest store.

A lazy Collection-2 stack run with ``feed_cache_mb``, ``decode_workers=2``
and readahead, and with the ingest store, writes tile artifacts
byte-equal to the plain eager load's; window reads through the port's
codec equal the JAX package's with the cache on and off, with the same
hit/miss counts; the ``cache.corrupt`` and ``store.corrupt`` seams are
detected and re-decoded, and ``feed.decode`` faults ride the retry
ladder.
"""

import glob
import os

import numpy as np
import pytest
import torch

from land_trendr_tpu.io import blockcache as jblockcache
from land_trendr_tpu.io.geotiff import read_geotiff_window as jread_window
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io import blockcache
from land_trendr_tpu_torch.io.blockstore import BlockStore
from land_trendr_tpu_torch.io.geotiff import read_geotiff_window, write_geotiff
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack_c2
from land_trendr_tpu_torch.runtime import RunConfig, faults, run_stack
from land_trendr_tpu_torch.runtime.stack import load_stack_dir, open_stack_dir_c2_lazy

torch.set_num_threads(1)

BANDS = ("nir", "swir2")


@pytest.fixture(autouse=True)
def _cache_off_after():
    yield
    faults.deactivate()
    blockcache.configure(budget_bytes=0, workers=None)
    jblockcache.configure(budget_bytes=0, workers=None)


@pytest.fixture(scope="module")
def c2(tmp_path_factory):
    root = tmp_path_factory.mktemp("c2")
    spec = SceneSpec(width=96, height=80, year_start=2000, year_end=2007, seed=7)
    # 32 px blocks: every 48 px tile window straddles block edges
    write_stack_c2(str(root), make_stack(spec), tile=32)
    return str(root)


def _cfg(root, **kw):
    return RunConfig(
        params=LTParams(max_segments=4, vertex_count_overshoot=2), tile_size=48,
        retry_backoff_s=0.0, workdir=os.path.join(root, "w"),
        out_dir=os.path.join(root, "o"), **kw,
    )


def _artifacts(workdir) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(workdir, "tile_*.npz"))):
        with np.load(p) as z:
            out[os.path.basename(p)] = {k: z[k].tobytes() for k in z.files}
    return out


@pytest.fixture(scope="module")
def plain(c2, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plain"))
    stack = load_stack_dir(c2, bands=BANDS)
    summary = run_stack(stack, _cfg(root, feed_cache_mb=0), device="cpu")
    assert summary["tiles_done"] == 4
    return _artifacts(os.path.join(root, "w"))


@pytest.mark.parametrize(
    "kw",
    [
        {"feed_cache_mb": 16, "decode_workers": 2},
        {"feed_cache_mb": 16, "decode_workers": 2, "feed_readahead": False},
        {"feed_cache_mb": 16, "decode_workers": 1, "feed_workers": 2},
        {"feed_cache_mb": 0, "decode_workers": 2},
    ],
    ids=["cache+pool+readahead", "no-readahead", "serial-decode", "uncached"],
)
def test_lazy_run_equals_plain_load(c2, plain, tmp_path, kw):
    stack = open_stack_dir_c2_lazy(c2, bands=BANDS)
    summary = run_stack(stack, _cfg(str(tmp_path), **kw), device="cpu")
    assert summary["tiles_done"] == 4
    assert _artifacts(str(tmp_path / "w")) == plain
    if kw["feed_cache_mb"]:
        fc = summary["feed_cache"]
        assert fc["misses"] > 0 and fc["hits"] > 0  # tile edges revisit blocks
        if kw.get("feed_readahead", True) and kw["decode_workers"] != 1:
            # readahead queues onto the decode pool; serial decode has none
            assert fc["readahead_blocks"] > 0
    else:
        assert "feed_cache" not in summary


def test_ingest_store_once_then_served(c2, plain, tmp_path):
    stack = open_stack_dir_c2_lazy(c2, bands=BANDS)
    store_dir = str(tmp_path / "store")
    kw = dict(feed_cache_mb=0, ingest_store_mb=64, ingest_store_dir=store_dir)
    s1 = run_stack(stack, _cfg(str(tmp_path / "a"), **kw), device="cpu")
    assert s1["ingest_store"]["put_blocks"] > 0
    blockcache.cache_clear()
    s2 = run_stack(stack, _cfg(str(tmp_path / "b"), **kw), device="cpu")
    assert s2["ingest_store"]["misses"] == 0 and s2["ingest_store"]["hits"] > 0
    assert s2["ingest_store"]["put_blocks"] == 0
    assert _artifacts(str(tmp_path / "a" / "w")) == plain
    assert _artifacts(str(tmp_path / "b" / "w")) == plain
    # the run closed and detached its store: nothing stays attached
    assert blockcache.config_snapshot()["store"] is None


@pytest.mark.parametrize("budget_mb", [0, 8])
@pytest.mark.parametrize("compress", ["deflate", "lzw", "none"])
def test_window_reads_match_jax_codec(tmp_path, rng, budget_mb, compress):
    p = str(tmp_path / "scene.tif")
    arr = rng.integers(0, 30000, (100, 90), dtype=np.uint16)
    write_geotiff(p, arr, compress=compress, tile=32)
    blockcache.configure(budget_bytes=budget_mb << 20, workers=2)
    jblockcache.configure(budget_bytes=budget_mb << 20, workers=2)
    base, jbase = blockcache.stats_snapshot(), jblockcache.stats_snapshot()
    for win in [(0, 0, 40, 40), (10, 20, 50, 60), (0, 0, 40, 40), (64, 64, 36, 26)]:
        ours = read_geotiff_window(p, *win)
        assert ours.tobytes() == jread_window(p, *win).tobytes(), win
        y0, x0, h, w = win
        assert np.array_equal(ours, arr[y0:y0 + h, x0:x0 + w])
    d, jd = blockcache.stats_delta(base), jblockcache.stats_delta(jbase)
    for k in ("hits", "misses", "evictions", "inserted_bytes"):
        assert d[k] == jd[k], k
    assert (d["hits"] > 0) == bool(budget_mb)


def test_cache_corrupt_seam_detected(tmp_path, rng):
    p = str(tmp_path / "scene.tif")
    arr = rng.integers(0, 30000, (96, 96), dtype=np.int16)
    write_geotiff(p, arr, compress="deflate")
    blockcache.configure(budget_bytes=32 << 20, workers=1)
    ref = read_geotiff_window(p, 8, 8, 40, 40)
    base = blockcache.stats_snapshot()
    plan = faults.activate(faults.parse_schedule("seed=1,cache.corrupt@0"))
    got = read_geotiff_window(p, 8, 8, 40, 40)  # the first cached hit is poisoned
    faults.deactivate()
    np.testing.assert_array_equal(got, ref)
    assert blockcache.stats_delta(base)["corrupt_dropped"] == 1
    assert plan.injected() == [("cache.corrupt", 0, "corrupt")]


def test_store_corrupt_seam_detected(tmp_path, rng):
    p = str(tmp_path / "scene.tif")
    arr = rng.integers(0, 30000, (200, 200), dtype=np.uint16)
    write_geotiff(p, arr, compress="deflate", tile=64)
    store = BlockStore(str(tmp_path / "store"), budget_bytes=64 << 20)
    blockcache.configure(0, 1, store=store)
    read_geotiff_window(p, 0, 0, 200, 200)
    store.flush()
    plan = faults.activate(faults.parse_schedule("seed=1,store.corrupt@1"))
    got = read_geotiff_window(p, 0, 0, 200, 200)
    faults.deactivate()
    assert np.array_equal(got, arr)
    assert [s for s, _i, _k in plan.injected()] == ["store.corrupt"]
    assert store.stats_snapshot()["corrupt_dropped"] >= 1
    blockcache.detach_store(store)
    store.close()


def test_decode_fault_rides_the_retry_ladder(c2, plain, tmp_path):
    stack = open_stack_dir_c2_lazy(c2, bands=BANDS)
    cfg = _cfg(str(tmp_path), feed_cache_mb=0, fault_schedule="seed=1,feed.decode@3")
    summary = run_stack(stack, cfg, device="cpu")
    assert summary["faults_injected"] == [{"seam": "feed.decode", "index": 3, "error": "value"}]
    assert summary["retries"] == 1
    assert _artifacts(str(tmp_path / "w")) == plain
