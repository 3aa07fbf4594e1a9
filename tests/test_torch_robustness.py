"""The port's ``Run`` under injected faults, held against a clean run and
against the JAX package's ``run_stack`` on the same stack and schedule.

Every schedule's run ends (after a resume where tiles were quarantined)
with rasters byte-equal to the clean run's; its retry count, quarantined
tile ids and injection log equal the JAX package's.  Exhausted retries,
a stall (an injected interruptible hang under a 0.5 s watchdog) and a
cancel behave as in the JAX package, and a resume completes the rest.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.runtime import driver as jdriver
from land_trendr_tpu.runtime.stack import stack_from_synthetic as jax_stack_from_synthetic
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
from land_trendr_tpu_torch.runtime import (
    Run,
    RunCancelled,
    RunConfig,
    StallError,
    TileRetriesExhausted,
    assemble_outputs,
    run_stack,
    stack_from_synthetic,
)

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

SPEC = SceneSpec(width=48, height=40, year_start=1990, year_end=2013, seed=11)
PARAMS = dict(max_segments=4, vertex_count_overshoot=2)
N_TILES = 6  # 48 x 40 at tile 20: 3 x 2 tiles, the right column 8 px wide


@pytest.fixture(scope="module")
def synth():
    return make_stack(SPEC)


@pytest.fixture(scope="module")
def stack(synth):
    return stack_from_synthetic(synth)


@pytest.fixture(scope="module")
def jstack(synth):
    return jax_stack_from_synthetic(synth)


def make_cfg(root, **kw):
    kw.setdefault("tile_size", 20)
    kw.setdefault("retry_backoff_s", 0.0)
    return RunConfig(
        params=LTParams(**PARAMS),
        workdir=os.path.join(root, "work"), out_dir=os.path.join(root, "out"), **kw
    )


def make_jcfg(root, **kw):
    kw.setdefault("tile_size", 20)
    kw.setdefault("retry_backoff_s", 0.0)
    return jdriver.RunConfig(
        params=JLTParams(**PARAMS), impl="xla",
        workdir=os.path.join(root, "jwork"), out_dir=os.path.join(root, "jout"), **kw
    )


def _raster_bytes(out_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def clean(stack, tmp_path_factory):
    root = tmp_path_factory.mktemp("clean")
    cfg = make_cfg(str(root))
    summary = run_stack(stack, cfg, device="cpu")
    assemble_outputs(stack, cfg)
    return summary, _raster_bytes(cfg.out_dir)


def test_clean_run_retries_nothing(clean):
    summary, rasters = clean
    assert summary["tiles_done"] == N_TILES and summary["retries"] == 0
    assert summary["tiles_quarantined"] == [] and "faults_injected" not in summary
    assert len(rasters) == 11


SCHEDULES = [
    "seed=1,feed@1=io",
    "seed=1,dispatch@1",
    "seed=1,compute.wait@2",
    "seed=1,fetch.wait@7=io",
    "seed=1,dispatch@0*2,compute.wait@4",
    "seed=1,feed@2,dispatch@3,compute.wait@1,fetch.wait@20",
    "seed=1,dispatch@2*3",
    "seed=1,compute.wait@0*3,feed@4*3",
    "seed=5,dispatch%0.3,compute.wait%0.2",
    "seed=2,fetch.wait%0.05=io",
]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_matches_jax_and_clean_bytes(stack, jstack, clean, tmp_path, schedule):
    cfg = make_cfg(str(tmp_path), fault_schedule=schedule, quarantine_tiles=True)
    run = Run(stack, cfg, device="cpu")
    summary = run.execute()
    jrun = jdriver.Run(jstack, make_jcfg(str(tmp_path), fault_schedule=schedule,
                                         quarantine_tiles=True))
    jsummary = jrun.execute()
    assert summary["faults_injected"] == jsummary["faults_injected"]
    assert summary["tiles_quarantined"] == jsummary["tiles_quarantined"]
    assert run.progress["retries"] == jrun.progress["retries"] == summary["retries"]
    assert summary["pixels"] == jsummary["pixels"]
    assert summary["faults_injected"], "the schedule fired nothing"
    if summary["tiles_quarantined"]:
        resumed = run_stack(stack, make_cfg(str(tmp_path)), device="cpu")
        assert resumed["tiles_done"] == len(summary["tiles_quarantined"])
    assemble_outputs(stack, cfg)
    assert _raster_bytes(cfg.out_dir) == clean[1]


@pytest.mark.parametrize("upload_depth", [1, 2])
@pytest.mark.parametrize("fetch_depth", [1, 2])
def test_faults_at_depths_give_clean_bytes(stack, clean, tmp_path, upload_depth, fetch_depth):
    cfg = make_cfg(
        str(tmp_path), upload_depth=upload_depth, fetch_depth=fetch_depth,
        fault_schedule="seed=1,dispatch@1,compute.wait@3,fetch.wait@30=io",
    )
    summary = run_stack(stack, cfg, device="cpu")
    assert summary["retries"] == 3 and summary["tiles_quarantined"] == []
    assemble_outputs(stack, cfg)
    assert _raster_bytes(cfg.out_dir) == clean[1]


def test_retries_exhausted_raises_like_jax(stack, jstack, tmp_path):
    sched = "seed=1,dispatch@0*99"
    with pytest.raises(TileRetriesExhausted) as ours:
        run_stack(stack, make_cfg(str(tmp_path), max_retries=1, fault_schedule=sched),
                  device="cpu")
    with pytest.raises(jdriver.TileRetriesExhausted) as theirs:
        jdriver.run_stack(jstack, make_jcfg(str(tmp_path), max_retries=1,
                                            fault_schedule=sched))
    assert str(ours.value) == str(theirs.value) == "tile 0 failed after 2 attempts"
    assert (ours.value.tile_id, ours.value.attempts) == (0, 2)
    assert "injected fault at dispatch#1" in str(ours.value.__cause__)


def test_feed_exhausted_chains_the_feed_error(stack, tmp_path):
    cfg = make_cfg(str(tmp_path), max_retries=1, fault_schedule="seed=1,feed%1.0=io")
    with pytest.raises(TileRetriesExhausted, match="failed after 2 attempts") as ei:
        run_stack(stack, cfg, device="cpu")
    assert "injected fault at feed#" in str(ei.value.__cause__)


def test_manifest_record_fault_aborts_then_resume_is_clean(stack, clean, tmp_path):
    cfg = make_cfg(str(tmp_path), fault_schedule="seed=1,feed@0,manifest.record@3")
    with pytest.raises(OSError, match="injected fault at manifest.record#3"):
        run_stack(stack, cfg, device="cpu")
    resumed = run_stack(stack, make_cfg(str(tmp_path)), device="cpu")
    assert resumed["tiles_skipped_resume"] + resumed["tiles_done"] == N_TILES
    assemble_outputs(stack, cfg)
    assert _raster_bytes(cfg.out_dir) == clean[1]


def test_stall_raises_stall_error_then_resume(stack, clean, tmp_path):
    cfg = make_cfg(str(tmp_path), stall_timeout_s=0.5, telemetry=True,
                   fault_schedule="seed=1,compute.wait@1=hang:20")
    t0 = time.monotonic()
    with pytest.raises(StallError, match="no tile progress"):
        run_stack(stack, cfg, device="cpu")
    assert time.monotonic() - t0 < 2.5  # aborted, not the 20 s hang
    from land_trendr_tpu.obs.events import iter_events, validate_events_file

    ev_file = os.path.join(cfg.workdir, "events.jsonl")
    assert validate_events_file(ev_file) == []
    evs = list(iter_events(ev_file))
    assert [r["timeout_s"] for r in evs if r["ev"] == "stall"] == [0.5]
    assert [r for r in evs if r["ev"] == "run_done"][-1]["status"] == "aborted"
    run_stack(stack, make_cfg(str(tmp_path)), device="cpu")
    assemble_outputs(stack, cfg)
    assert _raster_bytes(cfg.out_dir) == clean[1]


def test_stall_interrupt_lands_inside_a_polled_event_wait():
    """The driver's device waits poll their event from Python: a wait on
    an event that never completes (a wedged device) is interrupted by the
    watchdog within its timeout instead of hanging inside the runtime."""
    from land_trendr_tpu_torch.runtime import driver, fetch

    class NeverDone:
        def query(self):
            return False

    stalls = []
    dog = driver._StallWatchdog(0.3, stalls.append).start()
    t0 = time.monotonic()
    try:
        with pytest.raises(KeyboardInterrupt):
            fetch.wait_event(NeverDone())
    finally:
        dog.stop()
    assert dog.stalled and len(stalls) == 1 and stalls[0] >= 0.3
    assert time.monotonic() - t0 < 2.0


def test_cancel_then_resume_completes(stack, clean, tmp_path):
    cancel = threading.Event()
    durable = []

    def on_durable(t, arrays, meta):
        durable.append(t.tile_id)
        if len(durable) == 3:
            cancel.set()

    cfg = make_cfg(str(tmp_path))
    run = Run(stack, cfg, device="cpu", cancel=cancel, on_tile_durable=on_durable,
              job_id="j1")
    with pytest.raises(RunCancelled, match=r"run cancelled \(job j1\)"):
        run.execute()
    assert run.progress["phase"] == "aborted" and 3 <= len(durable) < N_TILES
    resumed = run_stack(stack, make_cfg(str(tmp_path)), device="cpu")
    assert resumed["tiles_skipped_resume"] == len(durable)
    assert resumed["tiles_done"] == N_TILES - len(durable)
    assemble_outputs(stack, cfg)
    assert _raster_bytes(cfg.out_dir) == clean[1]


def test_backoff_capped_after_jitter(stack, tmp_path, monkeypatch):
    from land_trendr_tpu_torch.runtime import driver

    slept = []
    monkeypatch.setattr(driver.time, "sleep", lambda s: slept.append(s))
    cfg = make_cfg(str(tmp_path), retry_backoff_s=25.0, max_retries=3,
                   fault_schedule="seed=1,dispatch@0*3")
    run_stack(stack, cfg, device="cpu")
    assert len(slept) == 3 and all(s <= driver._BACKOFF_CAP_S for s in slept)
    assert slept[0] >= 25.0 * 0.5


def test_serving_only_parameters_are_none_only(stack, tmp_path):
    with pytest.raises(ValueError, match="serving layer"):
        Run(stack, make_cfg(str(tmp_path)), device="cpu", programs=object())
    with pytest.raises(ValueError, match="serving layer"):
        Run(stack, make_cfg(str(tmp_path)), device="cpu", shared_store=object())


def test_quarantined_tile_recorded_failed_in_manifest(stack, tmp_path):
    from land_trendr_tpu_torch.runtime import TileManifest

    cfg = make_cfg(str(tmp_path), max_retries=1, quarantine_tiles=True,
                   fault_schedule="seed=1,dispatch@2*2")
    summary = run_stack(stack, cfg, device="cpu")
    assert summary["tiles_quarantined"] == [2]
    assert summary["pixels"] == 40 * 48 - 160  # all but the 8 x 20 edge tile
    recs = list(TileManifest(cfg.workdir, cfg.fingerprint(stack)).iter_records())
    failed = [r for r in recs if r["kind"] == "tile_failed"]
    assert [r["tile_id"] for r in failed] == [2] and failed[0]["attempts"] == 2
    assert np.isfinite(summary["fit_rate"])


@pytest.mark.parametrize(
    "kw",
    [
        {"max_retries": 5, "retry_backoff_s": 0.1, "quarantine_tiles": True},
        {"stall_timeout_s": 30.0, "straggler_k": 2.0, "straggler_min_tiles": 3},
        {"fault_schedule": "seed=1,dispatch@1", "ingest_store_mb": 8,
         "ingest_store_dir": "/tmp/store"},
        {"feed_cache_mb": 0, "decode_workers": 3, "feed_readahead": False,
         "out_overviews": 2},
        {"telemetry": True, "metrics_port": 0, "metrics_host": "127.0.0.1",
         "metrics_interval_s": 1.0, "flight": True, "flight_ring_events": 64,
         "sampler_interval_s": 0.5},
    ],
    ids=["retries", "watchdog", "faults+store", "feed", "telemetry"],
)
def test_fingerprint_with_new_fields_matches_jax(stack, kw):
    ours = RunConfig(tile_size=20, **kw)
    theirs = jdriver.RunConfig(tile_size=20, **kw)
    assert ours.fingerprint(stack) == theirs.fingerprint(stack)
    # execution facts: never fingerprinted
    assert ours.fingerprint(stack) == RunConfig(tile_size=20).fingerprint(stack)
