"""The port's fleet telemetry plane (``obs/publish``, ``obs/aggregate``,
``obs/history``, ``obs/alerts``) and fleet publish on ``segment``, held
against the JAX package's modules on the same inputs.

Each case of the JAX package's ``tests/test_fleet.py`` runs here through
both packages' modules (``impl`` = ``jax`` or ``torch``) with the same
checks, and the port's output is compared with the JAX package's: the
same snapshots, fold views and exposition bytes, history samples, rates,
alert transitions and rule-parse errors.  All on the CPU.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import land_trendr_tpu.obs.aggregate as j_aggregate
import land_trendr_tpu.obs.alerts as j_alerts
import land_trendr_tpu.obs.history as j_history
import land_trendr_tpu.obs.metrics as j_metrics
import land_trendr_tpu.obs.publish as j_publish
import land_trendr_tpu_torch.obs.aggregate as t_aggregate
import land_trendr_tpu_torch.obs.alerts as t_alerts
import land_trendr_tpu_torch.obs.history as t_history
import land_trendr_tpu_torch.obs.metrics as t_metrics
import land_trendr_tpu_torch.obs.publish as t_publish

torch.set_num_threads(1)

MODS = {
    "jax": SimpleNamespace(aggregate=j_aggregate, alerts=j_alerts, history=j_history,
                           metrics=j_metrics, publish=j_publish),
    "torch": SimpleNamespace(aggregate=t_aggregate, alerts=t_alerts, history=t_history,
                             metrics=t_metrics, publish=t_publish),
}
IMPLS = sorted(MODS)


def _registry(m, tiles: int = 5, backlog: int = 2, burn: float = 0.1):
    r = m.metrics.MetricsRegistry()
    r.counter("lt_tiles_done_total", "tiles").inc(tiles)
    r.gauge("lt_feed_backlog", "backlog").set(backlog)
    r.gauge("lt_slo_burn_rate", "burn").set(burn)
    return r


def _publish(m, d, host: str, registry, **kw):
    pub = m.publish.TelemetryPublisher(
        str(d), registry, interval_s=kw.pop("interval_s", 5.0), host=host, **kw
    )
    pub.publish_now()
    return pub


def _both_folds(d, **kw) -> dict:
    """The same snapshot directory folded by both packages: equal views
    and byte-equal exposition."""
    now = kw.pop("now", time.time())
    views = {k: m.aggregate.fold_dir(str(d), now=now, **kw) for k, m in MODS.items()}
    assert views["torch"] == views["jax"]
    proms = {k: MODS[k].aggregate.render_prom(v) for k, v in views.items()}
    assert proms["torch"] == proms["jax"]
    return views["torch"]


_VOLATILE = ("pid", "generation", "t_wall", "uptime_s")


def _stable(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k not in _VOLATILE}


# ---------------------------------------------------------------------------
# publish


@pytest.mark.parametrize("impl", IMPLS)
def test_publisher_snapshot_shape_and_seq(tmp_path, impl):
    m = MODS[impl]
    pub = _publish(
        m, tmp_path, "h1", _registry(m),
        probes=lambda: {"progress": {"phase": "pipeline", "tiles_done": 3}},
    )
    snap = json.loads(Path(pub.path).read_text())
    assert snap["schema"] == m.publish.SNAP_SCHEMA == j_publish.SNAP_SCHEMA
    assert snap["host"] == "h1" and snap["pid"] == os.getpid()
    assert snap["seq"] == 1 and snap["generation"] > 0
    assert snap["state"]["progress"]["phase"] == "pipeline"
    names = {x["name"] for x in snap["metrics"]}
    assert {"lt_tiles_done_total", "lt_feed_backlog"} <= names
    pub.publish_now()
    assert json.loads(Path(pub.path).read_text())["seq"] == 2
    assert list(Path(tmp_path).glob("*.tmp")) == []


def test_publisher_snapshots_equal_the_jax_package(tmp_path):
    snaps = {}
    for impl, m in MODS.items():
        d = tmp_path / impl
        pub = _publish(m, d, "h1", _registry(m, tiles=9),
                       probes=lambda: {"progress": {"phase": "drain"}}, kind="serve")
        snaps[impl] = _stable(json.loads(Path(pub.path).read_text()))
        assert os.path.basename(pub.path) == f"h1.{os.getpid()}.snap.json"
        assert pub.path.startswith(str(d))
        assert m.publish.telemetry_dir("W") == os.path.join("W", "telemetry")
    assert snaps["torch"] == snaps["jax"]


@pytest.mark.parametrize("impl", IMPLS)
def test_publisher_probe_failure_degrades_not_raises(tmp_path, impl):
    m = MODS[impl]

    def sick():
        raise RuntimeError("probe died")

    pub = _publish(m, tmp_path, "h1", _registry(m), probes=sick)
    assert json.loads(Path(pub.path).read_text())["state"] == {}


@pytest.mark.parametrize("impl", IMPLS)
def test_publish_fault_seam_skips_the_beat(tmp_path, impl):
    m = MODS[impl]
    pub = _publish(m, tmp_path, "h1", _registry(m))

    class Plan:
        def check(self, seam):
            if seam == "obs.publish":
                raise OSError("injected")

    m.publish.set_fault_plan(Plan())
    try:
        pub.publish_now()
    except OSError:
        pass
    finally:
        m.publish.set_fault_plan(None)
    assert json.loads(Path(pub.path).read_text())["seq"] == 1


# ---------------------------------------------------------------------------
# aggregate: every fold below runs through both packages (``_both_folds``)


@pytest.mark.parametrize("writer", IMPLS)
def test_fold_counters_sum_gauges_policy(tmp_path, writer):
    m = MODS[writer]
    _publish(m, tmp_path, "h1", _registry(m, tiles=5, backlog=2, burn=0.1))
    _publish(m, tmp_path, "h2", _registry(m, tiles=7, backlog=3, burn=0.4))
    view = _both_folds(tmp_path)
    got = {i["name"]: i for i in view["metrics"]}
    assert got["lt_tiles_done_total"]["value"] == 12
    assert got["lt_feed_backlog"]["value"] == 5
    assert got["lt_slo_burn_rate"]["value"] == pytest.approx(0.4)
    assert view["counts"] == {
        "snapshots": 2, "folded": 2, "stale": 0, "corrupt": 0, "excluded": 0,
    }


@pytest.mark.parametrize("writer", IMPLS)
def test_histogram_bucket_merge_parity(tmp_path, writer):
    m = MODS[writer]
    bounds = (0.1, 1.0, 10.0)
    obs_a, obs_b = [0.05, 0.5, 5.0, 50.0], [0.07, 0.07, 2.0]
    ra, rb, rall = (m.metrics.MetricsRegistry() for _ in range(3))
    for r, obs in ((ra, obs_a), (rb, obs_b), (rall, obs_a + obs_b)):
        h = r.histogram("lt_tile_compute_seconds", "h", buckets=bounds)
        for v in obs:
            h.observe(v)
    _publish(m, tmp_path, "a", ra)
    _publish(m, tmp_path, "b", rb)
    merged = {i["name"]: i for i in _both_folds(tmp_path)["metrics"]}["lt_tile_compute_seconds"]
    direct = rall.snapshot()[0]
    assert merged["buckets"] == direct["buckets"]
    assert merged["count"] == direct["count"]
    assert merged["sum"] == pytest.approx(direct["sum"])


def test_merge_instruments_equals_the_jax_package():
    rng = np.random.default_rng(20261017)
    snaps = []
    for _ in range(3):
        r = t_metrics.MetricsRegistry()
        r.counter("lt_tiles_done_total", "t").inc(int(rng.integers(0, 50)))
        r.gauge("lt_feed_backlog", "b").set(float(rng.integers(0, 9)))
        r.gauge("lt_slo_burn_rate", "s").set(float(rng.uniform()))
        h = r.histogram("lt_tile_compute_seconds", "h", buckets=(0.1, 1.0))
        for v in rng.uniform(0, 2, size=5):
            h.observe(float(v))
        snaps.append((float(rng.uniform(0, 100)), r.snapshot()))
    r = t_metrics.MetricsRegistry()
    r.counter("lt_feed_backlog", "clash").inc(1)  # a kind clash: a conflict
    snaps.append((50.0, r.snapshot()))
    merged, conflicts = t_aggregate.merge_instruments(snaps)
    assert (merged, conflicts) == j_aggregate.merge_instruments(snaps)
    assert len(conflicts) == 1


@pytest.mark.parametrize("writer", IMPLS)
def test_histogram_bounds_mismatch_is_flagged_conflict(tmp_path, writer):
    m = MODS[writer]
    ra, rb = m.metrics.MetricsRegistry(), m.metrics.MetricsRegistry()
    ra.histogram("lt_h", "h", buckets=(1.0, 2.0)).observe(1.5)
    rb.histogram("lt_h", "h", buckets=(5.0, 6.0)).observe(5.5)
    _publish(m, tmp_path, "a", ra)
    _publish(m, tmp_path, "b", rb)
    assert any("bounds differ" in c for c in _both_folds(tmp_path)["conflicts"])


@pytest.mark.parametrize("writer", IMPLS)
def test_torn_snapshot_flagged_corrupt_not_fatal(tmp_path, writer):
    m = MODS[writer]
    _publish(m, tmp_path, "ok-host", _registry(m, tiles=5))
    (tmp_path / "torn-host.99.snap.json").write_text('{"schema": 1, "ho')
    view = _both_folds(tmp_path)
    assert view["counts"]["corrupt"] == 1 and view["counts"]["folded"] == 1
    torn = [h for h in view["hosts"] if h.get("corrupt")]
    assert len(torn) == 1 and torn[0]["excluded"]
    got = {i["name"]: i for i in view["metrics"]}
    assert got["lt_tiles_done_total"]["value"] == 5


@pytest.mark.parametrize("writer", IMPLS)
def test_stale_host_flagged_and_newer_than_excludes(tmp_path, writer):
    m = MODS[writer]
    _publish(m, tmp_path, "fresh", _registry(m, tiles=5))
    old = json.loads(Path(_publish(m, tmp_path, "dead", _registry(m, tiles=100)).path).read_text())
    old["t_wall"] = time.time() - 3600
    dead = tmp_path / "dead.1.snap.json"
    dead.write_text(json.dumps(old))
    os.utime(dead, (old["t_wall"], old["t_wall"]))
    os.unlink(m.aggregate.discover_snapshots(str(tmp_path))[1])  # the live dup
    now = time.time()
    view = _both_folds(tmp_path, now=now)
    assert [h["host"] for h in view["hosts"] if h["stale"]] == ["dead"]
    assert {i["name"]: i for i in view["metrics"]}["lt_tiles_done_total"]["value"] == 105
    view = _both_folds(tmp_path, now=now, newer_than=now - 600)
    assert [h["host"] for h in view["hosts"] if h["excluded"]] == ["dead"]
    assert {i["name"]: i for i in view["metrics"]}["lt_tiles_done_total"]["value"] == 5


@pytest.mark.parametrize("writer", IMPLS)
def test_pid_reuse_superseded_by_generation(tmp_path, writer):
    m = MODS[writer]
    old = json.loads(Path(_publish(m, tmp_path, "h1", _registry(m, tiles=100)).path).read_text())
    old["generation"] -= 1
    (tmp_path / "h1.stale-dup.snap.json").write_text(json.dumps(old))
    view = _both_folds(tmp_path)
    assert {i["name"]: i for i in view["metrics"]}["lt_tiles_done_total"]["value"] == 100
    assert len([h for h in view["hosts"] if h.get("superseded")]) == 1


def test_fold_byte_stable_across_folds_and_packages(tmp_path):
    # one host from each package's publisher in one directory
    _publish(MODS["jax"], tmp_path, "h1", _registry(MODS["jax"], tiles=5))
    _publish(MODS["torch"], tmp_path, "h2", _registry(MODS["torch"], tiles=7))
    now = time.time()
    a = t_aggregate.render_prom(_both_folds(tmp_path, now=now))
    b = t_aggregate.render_prom(t_aggregate.fold_dir(str(tmp_path), now=now))
    assert a == b and "lt_fleet_hosts 2" in a
    view = t_aggregate.fold_dir(str(tmp_path), now=now)
    assert t_aggregate.pod_sample(view) == j_aggregate.pod_sample(view)


# ---------------------------------------------------------------------------
# history


@pytest.mark.parametrize("impl", IMPLS)
def test_history_ring_segment_eviction(tmp_path, impl):
    m = MODS[impl]
    d = str(tmp_path / "hist")
    sample = {"t": 0.0, "hosts": 1, "stale_hosts": 0, "metrics": {"x": 1.0}}
    seg_bytes = (len(json.dumps(sample, separators=(",", ":"))) + 30) * 4
    ring = m.history.HistoryRing(d, budget_bytes=seg_bytes * 2, samples_per_segment=4)
    for i in range(40):
        ring.append({**sample, "t": float(i)})
    ring.close()
    assert 1 <= len(m.history.HistoryRing(d).segments()) <= 3
    samples, malformed = m.history.HistoryRing(d).read()
    assert malformed == 0 and samples[-1]["t"] == 39.0 and len(samples) <= 12


def test_history_rings_keep_the_same_samples(tmp_path):
    sample = {"t": 0.0, "hosts": 1, "stale_hosts": 0, "metrics": {"x": 1.0}}
    seg_bytes = (len(json.dumps(sample, separators=(",", ":"))) + 30) * 4
    kept = {}
    for impl, m in MODS.items():
        d = str(tmp_path / impl)
        ring = m.history.HistoryRing(d, budget_bytes=seg_bytes * 2, samples_per_segment=4)
        for i in range(40):
            ring.append({**sample, "t": float(i), "metrics": {"x": float(i * i)}})
        ring.close()
        # the other package reads this ring too: one on-disk format
        kept[impl] = [MODS[k].history.HistoryRing(d).read() for k in IMPLS]
        assert kept[impl][0] == kept[impl][1]
    assert kept["torch"] == kept["jax"]


@pytest.mark.parametrize("impl", IMPLS)
def test_history_reopen_after_crash_adopts_torn_tail(tmp_path, impl):
    m = MODS[impl]
    d = str(tmp_path / "hist")
    os.makedirs(d)
    left = Path(d) / "hist-100-999.open.jsonl"
    left.write_text('{"t": 1.0, "hosts": 1}\n{"t": 2.0, "hosts": 1}\n{"t": 3.0, "ho')
    old = time.time() - 3600
    os.utime(left, (old, old))
    ring = m.history.HistoryRing(d)
    assert ring.adopted_segments == 1 and ring.dropped_torn_lines == 1
    samples, malformed = ring.read()
    assert [s["t"] for s in samples] == [1.0, 2.0] and malformed == 0
    assert not list(Path(d).glob("*.open.jsonl"))
    ring.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_history_fresh_open_of_live_sibling_left_alone(tmp_path, impl):
    m = MODS[impl]
    d = str(tmp_path / "hist")
    os.makedirs(d)
    sibling = Path(d) / "hist-200-888.open.jsonl"
    sibling.write_text('{"t": 5.0, "hosts": 1}\n')
    ring = m.history.HistoryRing(d)
    assert ring.adopted_segments == 0 and sibling.exists()
    assert [s["t"] for s in ring.read()[0]] == [5.0]
    ring.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_rate_and_latest_value_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.integers(0, 10, size=30)).astype(float)
    vals[rng.integers(5, 25)] = 1.0  # a counter reset
    samples = [
        {"t": float(i), "metrics": {"c": float(v), "g": float(rng.uniform())}}
        for i, v in enumerate(vals)
    ]
    for window in (5.0, 12.5, 100.0):
        for now in (10.0, 29.0, 40.0):
            got = t_history.counter_rate(samples, "c", window_s=window, now=now)
            assert got == j_history.counter_rate(samples, "c", window_s=window, now=now)
            assert got is None or got >= 0.0
    for name in ("c", "g", "absent"):
        assert t_history.latest_value(samples, name) == j_history.latest_value(samples, name)


def test_counter_rate_reset_never_negative():
    samples = [
        {"t": 0.0, "metrics": {"c": 90.0}},
        {"t": 10.0, "metrics": {"c": 100.0}},
        {"t": 20.0, "metrics": {"c": 3.0}},
        {"t": 30.0, "metrics": {"c": 9.0}},
    ]
    assert t_history.counter_rate(samples, "c", window_s=100.0, now=30.0) == pytest.approx(
        (10 + 3 + 6) / 30.0)
    assert t_history.counter_rate(samples[:1], "c", 100.0, now=0.0) is None
    down = [{"t": 0.0, "metrics": {"c": 5.0}}, {"t": 10.0, "metrics": {"c": 0.0}}]
    assert t_history.counter_rate(down, "c", 100.0, now=10.0) == 0.0


# ---------------------------------------------------------------------------
# alerts: the same scripted histories through both engines


def _script(m, rule_kw: dict, series) -> list:
    eng = m.alerts.AlertEngine((m.alerts.AlertRule(**rule_kw),))
    out = []
    for t, samples in series:
        out += eng.evaluate(samples, float(t))
    return out + [("active", eng.active())]


_THRESH = dict(name="q", kind="threshold", metric="q", op=">", value=10,
               for_s=2.0, hold_down_s=3.0)


@pytest.mark.parametrize(
    "case,rule_kw,series",
    [
        ("fire_holddown_resolve", _THRESH,
         [(t, [{"t": float(t), "metrics": {"q": 20.0 if 5 <= t < 10 else 0.0}}])
          for t in range(20)]),
        ("transient", dict(name="q", kind="threshold", metric="q", op=">", value=10, for_s=5.0),
         [(t, [{"t": float(t), "metrics": {"q": 20.0 if t in (2, 3) else 0.0}}])
          for t in range(10)]),
        ("absent_stale_host", dict(name="stale", kind="absent", window_s=30.0),
         [(100, [{"t": 100.0, "hosts": 2, "stale_hosts": 1}])]),
        ("absent_dark_plane", dict(name="stale", kind="absent", window_s=30.0), [(100, [])]),
        ("rate", dict(name="fail_rate", kind="rate", metric="lt_tiles_failed_total", op=">",
                      value=0.5, window_s=100.0),
         [(4, [{"t": float(t), "metrics": {"lt_tiles_failed_total": t * 2.0}}
               for t in range(5)])]),
    ],
)
def test_alert_transitions_equal_the_jax_package(case, rule_kw, series):
    got = _script(MODS["torch"], rule_kw, series)
    assert got == _script(MODS["jax"], rule_kw, series)
    states = [tr["state"] for tr in got[:-1]]
    want = {
        "fire_holddown_resolve": ["firing", "resolved"],
        "transient": [],
        "absent_stale_host": ["firing"],
        "absent_dark_plane": ["firing"],
        "rate": ["firing"],
    }[case]
    assert states == want
    if case == "fire_holddown_resolve":
        assert [(tr["state"], tr["duration_s"]) for tr in got[:-1]] == [
            ("firing", 2.0), ("resolved", 6.0)]


@pytest.mark.parametrize(
    "bad,match",
    [
        ([{"name": "x", "metrik": "q"}], "unknown key"),
        ([{"name": "x", "kind": "nope"}], "kind"),
        ([{"name": "x", "metric": "q"}, {"name": "x", "metric": "q"}], "duplicate"),
        ([{"name": "x", "kind": "threshold", "metric": "q", "op": "=~"}], "op"),
        ("{not json", "."),
    ],
)
def test_rules_parse_errors_equal_the_jax_package(bad, match):
    errs = {}
    for impl, m in MODS.items():
        with pytest.raises(ValueError, match=match) as e:
            m.alerts.parse_rules(bad)
        errs[impl] = str(e.value)
    assert errs["torch"] == errs["jax"]


def test_rules_parse_and_defaults_equal_the_jax_package(tmp_path):
    text = '{"rules": [{"name": "x", "metric": "q"}]}'
    assert t_alerts.parse_rules(text)[0].name == "x"
    assert [r.__dict__ for r in t_alerts.parse_rules(text)] == [
        r.__dict__ for r in j_alerts.parse_rules(text)]
    p = tmp_path / "rules.json"
    p.write_text(json.dumps([
        {"name": "deep_queue", "kind": "threshold", "metric": "lt_serve_queue_depth",
         "op": ">=", "value": 10, "for_s": 5, "hold_down_s": 10},
    ]))
    rules = t_alerts.load_rules(str(p))
    assert rules[0].name == "deep_queue" and rules[0].value == 10
    assert [r.__dict__ for r in rules] == [r.__dict__ for r in j_alerts.load_rules(str(p))]
    assert {r.kind for r in t_alerts.DEFAULT_RULES} == {"absent", "slo_burn"}
    assert [r.__dict__ for r in t_alerts.DEFAULT_RULES] == [
        r.__dict__ for r in j_alerts.DEFAULT_RULES]
    assert t_alerts.ALERT_STATES == j_alerts.ALERT_STATES


# ---------------------------------------------------------------------------
# wiring: fleet publish on segment


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"publish": True}, "publish requires telemetry"),
        ({"telemetry_dir": "/tmp/t"}, "telemetry_dir requires publish"),
        ({"telemetry": True, "publish": True, "publish_interval_s": 0}, "publish_interval_s"),
    ],
)
def test_publish_config_validation(kw, match):
    from land_trendr_tpu.runtime import RunConfig as JaxRunConfig
    from land_trendr_tpu_torch.runtime import RunConfig

    msgs = []
    for cls in (RunConfig, JaxRunConfig):
        with pytest.raises(ValueError, match=match) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_publish_fields_stay_out_of_the_fingerprint():
    from land_trendr_tpu.runtime import RunConfig as JaxRunConfig
    from land_trendr_tpu_torch.runtime import RunConfig
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic

    stack = stack_from_synthetic(make_stack(SceneSpec(width=16, height=16, seed=3)))
    kw = dict(telemetry=True, publish=True, publish_interval_s=2.0, telemetry_dir="T")
    assert RunConfig(**kw).fingerprint(stack) == RunConfig().fingerprint(stack)
    jfields = {f for f in JaxRunConfig.__dataclass_fields__}
    assert {"publish", "publish_interval_s", "telemetry_dir"} <= jfields
    # ensemble_indices is the port's own field (the JAX package segments
    # one index a run); every other field is the JAX package's
    assert set(RunConfig.__dataclass_fields__) - {"ensemble_indices"} == jfields


@pytest.fixture(scope="module")
def publish_runs(tmp_path_factory):
    """One tiny ``publish`` run per package on the same stack; returns
    ``{impl: (summary, workdir)}``."""
    from land_trendr_tpu.config import LTParams as JLTParams
    from land_trendr_tpu.io.synthetic import SceneSpec as JSceneSpec
    from land_trendr_tpu.io.synthetic import make_stack as j_make_stack
    from land_trendr_tpu.runtime import RunConfig as JRunConfig
    from land_trendr_tpu.runtime import run_stack as j_run_stack
    from land_trendr_tpu.runtime import stack_from_synthetic as j_from_synth
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.runtime import RunConfig, run_stack
    from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic

    out = {}
    spec = dict(width=40, height=20, year_start=2000, year_end=2006, seed=5)
    params = dict(max_segments=4, vertex_count_overshoot=2)
    for impl in IMPLS:
        wd = str(tmp_path_factory.mktemp(f"fleet_{impl}") / "work")
        kw = dict(workdir=wd, out_dir=wd + "_o", tile_size=20, telemetry=True,
                  publish=True, publish_interval_s=60.0)
        if impl == "torch":
            stack = stack_from_synthetic(make_stack(SceneSpec(**spec)))
            summary = run_stack(stack, RunConfig(params=LTParams(**params), **kw), device="cpu")
        else:
            stack = j_from_synth(j_make_stack(JSceneSpec(**spec)))
            summary = j_run_stack(stack, JRunConfig(params=JLTParams(**params), **kw))
        out[impl] = (summary, wd)
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_run_publishes_foldable_snapshot(publish_runs, impl):
    summary, wd = publish_runs[impl]
    snap_file = summary["telemetry"]["snapshot"]
    assert os.path.exists(snap_file)
    snap = json.loads(Path(snap_file).read_text())
    assert snap["kind"] == "run"
    assert snap["state"]["progress"]["phase"] == "done"
    assert snap["state"]["progress"]["tiles_done"] == 2
    view = _both_folds(os.path.join(wd, "telemetry"))
    assert {i["name"]: i for i in view["metrics"]}["lt_tiles_done_total"]["value"] == 2


def test_run_snapshots_match_the_jax_package(publish_runs):
    snaps = {
        impl: json.loads(Path(s["telemetry"]["snapshot"]).read_text())
        for impl, (s, _wd) in publish_runs.items()
    }
    t, j = snaps["torch"], snaps["jax"]
    assert {k for k in t if k not in _VOLATILE} == {k for k in j if k not in _VOLATILE}
    assert t["kind"] == j["kind"] and t["schema"] == j["schema"]
    assert set(t["state"]["progress"]) == set(j["state"]["progress"])
    for key in ("phase", "tiles_total", "tiles_done", "tiles_quarantined", "retries"):
        assert t["state"]["progress"][key] == j["state"]["progress"][key], key
    # the same instrument names and, for the tile counters, the same values
    tm = {x["name"]: x for x in t["metrics"]}
    jm = {x["name"]: x for x in j["metrics"]}
    for name in ("lt_tiles_done_total", "lt_pixels_total"):
        assert tm[name]["value"] == jm[name]["value"], name


def test_segment_publish_flags(tmp_path):
    import subprocess
    import sys

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))

    def cli(*a):
        return subprocess.run([sys.executable, "-m", "land_trendr_tpu_torch", "--device", "cpu",
                               *a], cwd=tmp_path, capture_output=True, text=True, env=env,
                              timeout=300)

    assert cli("synth", "D", "--size", "24", "--year-start", "2000",
               "--year-end", "2008").returncode == 0
    r = cli("segment", "D", "--tile-size", "24", "--publish")
    assert r.returncode == 2 and "publish requires telemetry" in r.stderr
    r = cli("segment", "D", "--tile-size", "24", "--telemetry", "--publish",
            "--publish-interval-s", "30", "--telemetry-dir", "TD")
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout)["summary"]
    assert summary["telemetry"]["snapshot"].startswith(os.path.join(str(tmp_path), "TD")) or \
        os.path.dirname(summary["telemetry"]["snapshot"]) == "TD"
    view = _both_folds(tmp_path / "TD")
    assert view["counts"]["folded"] == 1
