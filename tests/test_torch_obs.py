"""The port's telemetry, flight recorder, straggler detector and profiler.

A port run's ``events.jsonl`` and ``flight.jsonl`` pass the JAX package's
event-schema check and fold in its report tool; the event schema, the
metric names and the straggler verdicts on scripted durations equal the
JAX package's; on the CPU the device-memory gauge is absent (None); the
profiler writes a Chrome trace and allows one capture at a time.
"""

import json
import os
import threading

import pytest
import torch

from land_trendr_tpu.obs import events as jevents
from land_trendr_tpu.obs import flight as jflight
from land_trendr_tpu.obs.spans import StragglerDetector as JStragglerDetector
from land_trendr_tpu.obs.telemetry import Telemetry as JTelemetry
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
from land_trendr_tpu_torch.obs import (
    EVENT_FIELDS,
    SCHEMA_VERSION,
    FlightRecorder,
    ResourceSampler,
    StragglerDetector,
    Telemetry,
    iter_events,
)
from land_trendr_tpu_torch.runtime import RunConfig, run_stack, stack_from_synthetic
from land_trendr_tpu_torch.utils import profiling

torch.set_num_threads(1)

SPEC = SceneSpec(width=48, height=40, year_start=1990, year_end=2013, seed=11)


@pytest.fixture(scope="module")
def tel_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tel")
    stack = stack_from_synthetic(make_stack(SPEC))
    cfg = RunConfig(
        params=LTParams(max_segments=4, vertex_count_overshoot=2), tile_size=20,
        workdir=str(root / "w"), out_dir=str(root / "o"), telemetry=True, flight=True,
        sampler_interval_s=0.01, retry_backoff_s=0.0, metrics_interval_s=0.05,
        fault_schedule="seed=1,dispatch@1", straggler_min_tiles=1,
    )
    summary = run_stack(stack, cfg, device="cpu")
    return cfg, summary


def test_events_pass_the_jax_schema_check(tel_run):
    from tools import check_events_schema

    cfg, summary = tel_run
    assert jevents.validate_events_file(summary["telemetry"]["events"]) == []
    assert check_events_schema.main([cfg.workdir]) == 0


def test_one_tile_done_per_tile_and_robustness_events(tel_run):
    _, summary = tel_run
    evs = list(iter_events(summary["telemetry"]["events"]))
    names = [r["ev"] for r in evs]
    assert names[0] == "run_start" and names[-1] == "run_done"
    assert sorted(r["tile_id"] for r in evs if r["ev"] == "tile_done") == list(range(6))
    assert names.count("write_done") == 6
    assert {"fault_injected", "tile_retry", "span", "fetch", "upload", "feed_cache"} <= set(names)
    start = evs[0]
    assert start["impl"] == "torch" and start["mesh_devices"] == 1
    # the CPU has no device-memory gauge
    assert all("device_bytes_in_use" not in r for r in evs if r["ev"] == "tile_done")
    assert summary["device_bytes_peak"] is None


def test_flight_dump_lints_clean(tel_run):
    from tools import check_events_schema

    _, summary = tel_run
    path = summary["telemetry"]["flight"]
    assert os.path.basename(path) == "flight.jsonl"
    recs = [json.loads(line) for line in open(path)]
    assert recs and any(r.get("ev") == "run_done" for r in recs)
    samples = [r for r in recs if r.get("ev") == "flight_sample"]
    assert samples and all("device_bytes_in_use" not in r for r in samples)
    assert jevents.validate_events_file(path) == []
    assert check_events_schema.main([path]) == 0


def test_report_tool_folds_a_port_run(tel_run):
    from tools import obs_report

    _, summary = tel_run
    report, spans = obs_report.fold([summary["telemetry"]["events"]])
    assert report["faults_injected"] == 1 and spans
    prom = open(summary["telemetry"]["metrics"]).read()
    assert "lt_tiles_done_total" in prom and "lt_tile_retries_total" in prom


def test_event_schema_equals_jax():
    assert SCHEMA_VERSION == jevents.SCHEMA_VERSION
    assert EVENT_FIELDS == jevents.EVENT_FIELDS


def _metric_names(tel) -> list:
    return [line.split()[2] for line in tel.registry.render().splitlines()
            if line.startswith("# TYPE")]


def test_metric_names_equal_jax(tmp_path):
    ours = Telemetry(str(tmp_path / "a"), fingerprint="f")
    theirs = JTelemetry(str(tmp_path / "b"), fingerprint="f")
    try:
        assert _metric_names(ours) == _metric_names(theirs)
        assert len(_metric_names(ours)) > 30
    finally:
        ours.close()
        theirs.close()


SCRIPTS = [
    [1.0, 1.0, 1.0, 2.0, 2.5, 1.0, 9.0],
    [30.0, 1.0, 1.0, 1.2, 0.9, 5.0, 1.0, 1.1],
    [1.0] * 4 + [1.9] * 4 + [3.0, 4.0, 8.0],
    [0.5, 0.6, 0.4, 0.5, 2.0, 0.5, 1.6, 0.5],
]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _verdicts(cls, durations, k, min_tiles):
    clock = _Clock()
    out = []
    det = cls(k=k, min_tiles=min_tiles, window=4, clock=clock,
              on_straggler=lambda *a: out.append(tuple(round(x, 9) if isinstance(x, float)
                                                       else x for x in a)))
    for i, d in enumerate(durations):
        det.start(i)
        clock.t += d / 2
        det.scan()  # the in-flight sweep the sampler does
        clock.t += d / 2
        det.finish(i)
    return out, det.stats()


@pytest.mark.parametrize("script", SCRIPTS)
@pytest.mark.parametrize("k,min_tiles", [(2.0, 3), (1.5, 1)])
def test_straggler_verdicts_equal_jax(script, k, min_tiles):
    ours = _verdicts(StragglerDetector, script, k, min_tiles)
    theirs = _verdicts(JStragglerDetector, script, k, min_tiles)
    assert ours == theirs


def test_sampler_sample_validates(tmp_path):
    rec = FlightRecorder(16)
    emitted = []
    s = ResourceSampler(emitted.append, 5.0, probes=lambda: {"feed_backlog": 2})
    fields = s.sample_fields()
    assert fields["feed_backlog"] == 2 and fields["rss_bytes"] > 0
    rec.record({"ev": "x"})
    assert rec.stats()["events"] == 1
    assert sorted(fields) == sorted(jflight.ResourceSampler(
        emitted.append, 5.0, probes=lambda: {"feed_backlog": 2}).sample_fields())


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "t")
    with profiling.trace(logdir):
        with profiling.nvtx_range("lt_test"):
            torch.ones(64).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    doc = json.load(open(os.path.join(logdir, files[0])))
    assert doc["traceEvents"]
    r = profiling.profile_op(lambda: torch.ones(32) * 2, logdir=logdir, iters=2)
    assert r["logdir_bytes"] > 0 and r["wall_s_per_iter"] >= 0


def test_capture_profile_one_at_a_time(tmp_path):
    with pytest.raises(ValueError):
        profiling.capture_profile(str(tmp_path / "c"), 0)
    profiling._capture_begin()
    try:
        with pytest.raises(RuntimeError, match="already in flight"):
            profiling.capture_profile(str(tmp_path / "c"), 0.01)
    finally:
        profiling._capture_end()
    out = profiling.capture_profile(str(tmp_path / "c"), 0.01)
    assert out["bytes"] > 0


def test_stage_timer_is_thread_safe():
    timer = profiling.StageTimer()

    def work():
        for _ in range(50):
            with timer.stage("write"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert timer.counts()["write"] == 200 and "write_s" in timer.summary()


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"flight": True}, "flight requires telemetry"),
        ({"metrics_port": 9000}, "metrics_port requires telemetry"),
        ({"metrics_host": "127.0.0.1"}, "metrics_host requires metrics_port"),
        ({"telemetry": True, "metrics_interval_s": 0}, "metrics_interval_s"),
        ({"flight_ring_events": 1}, "flight_ring_events"),
        ({"sampler_interval_s": 0}, "sampler_interval_s"),
        ({"straggler_k": 0.5}, "straggler_k"),
        ({"straggler_min_tiles": 0}, "straggler_min_tiles"),
    ],
)
def test_telemetry_config_rejections_match_jax(kwargs, match):
    from land_trendr_tpu.runtime import RunConfig as JRunConfig

    with pytest.raises(ValueError, match=match):
        RunConfig(**kwargs)
    with pytest.raises(ValueError, match=match):
        JRunConfig(**kwargs)
