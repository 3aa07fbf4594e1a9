"""The port's autotuner (``tune/``): store lifecycle, ``"auto"``
resolution, the ``tune`` CLI, and the drift pins against the JAX
package's tuner — the same schema, shape classes and report keys, and
profile keys that never collide with the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from land_trendr_tpu.tune import KNOB_DEFAULTS as JAX_KNOB_DEFAULTS
from land_trendr_tpu.tune import TUNABLE_KNOBS as JAX_TUNABLE_KNOBS
from land_trendr_tpu.tune import device_identity as jax_device_identity
from land_trendr_tpu.tune import probes as jax_probemod
from land_trendr_tpu.tune import profile_key as jax_profile_key
from land_trendr_tpu.tune import shape_class as jax_shape_class
from land_trendr_tpu.tune.store import TUNE_SCHEMA as JAX_TUNE_SCHEMA
from land_trendr_tpu.tune.store import TuningStore as JaxTuningStore
from land_trendr_tpu_torch.runtime import faults
from land_trendr_tpu_torch.runtime.driver import RunConfig
from land_trendr_tpu_torch.tune import (
    CPU_BACKEND,
    KNOB_DEFAULTS,
    TUNABLE_KNOBS,
    TUNE_SCHEMA,
    TuningStore,
    autotune,
    device_identity,
    profile_key,
    resolve_config,
    shape_class,
)
from land_trendr_tpu_torch.tune import probes as probemod

torch.set_num_threads(1)

SHAPE = (512, 512, 40)


def _fake_report(**extra):
    return {"probes": 2, "timings": {}, "default_s": 1.0, "best_s": 0.5, "speedup": 2.0,
            **extra}


@pytest.fixture()
def fake_probes(monkeypatch):
    """One counting fake group: the lifecycle cases pin WHEN probes run."""
    calls: list[str] = []

    def fake_feed(reps, smoke, defaults, device):
        calls.append("feed")
        return {"feed_workers": 3}, _fake_report()

    monkeypatch.setattr(probemod, "PROBE_GROUPS", {"feed": (fake_feed, ("feed_workers",))})
    return calls


def _tune(store_dir, **kw):
    kw.setdefault("height", SHAPE[0])
    kw.setdefault("width", SHAPE[1])
    kw.setdefault("n_years", SHAPE[2])
    kw.setdefault("device", "cpu")
    kw.setdefault("device_kind", "test-device")
    kw.setdefault("backend", CPU_BACKEND)
    return autotune(str(store_dir), **kw)


def _path(store_dir):
    key = profile_key("test-device", CPU_BACKEND, shape_class(*SHAPE))
    return Path(TuningStore(str(store_dir)).path_for(key))


# -- store lifecycle -------------------------------------------------------

def test_persist_then_reload_runs_zero_probes(tmp_path, fake_probes):
    p1 = _tune(tmp_path)
    assert p1["source"] == "probed" and fake_probes == ["feed"]
    assert p1["knobs"]["feed_workers"] == 3
    for knob in TUNABLE_KNOBS:
        if knob != "feed_workers":
            assert p1["knobs"][knob] == KNOB_DEFAULTS[knob]
    p2 = _tune(tmp_path)
    assert p2["source"] == "store" and fake_probes == ["feed"]
    assert p2["knobs"] == p1["knobs"]


def test_key_miss_on_device_kind_change_reprobes(tmp_path, fake_probes):
    _tune(tmp_path)
    assert _tune(tmp_path, device_kind="other-device")["source"] == "probed"
    assert fake_probes == ["feed", "feed"]
    assert len(TuningStore(str(tmp_path)).profiles()) == 2


def test_retune_overrides_store_hit(tmp_path, fake_probes):
    _tune(tmp_path)
    assert _tune(tmp_path, retune=True)["source"] == "probed"
    assert fake_probes == ["feed", "feed"]


def test_stale_schema_version_invalidates(tmp_path, fake_probes):
    _tune(tmp_path)
    path = _path(tmp_path)
    stale = json.loads(path.read_text())
    stale["schema"] = TUNE_SCHEMA - 1
    path.write_text(json.dumps(stale))
    store = TuningStore(str(tmp_path))
    assert store.load("test-device", CPU_BACKEND, shape_class(*SHAPE)) is None
    assert store.stats()["stale_dropped"] == 1 and not path.exists()
    assert _tune(tmp_path)["source"] == "probed"
    assert fake_probes == ["feed", "feed"]


@pytest.mark.parametrize("damage", ["torn", "not-json", "wrong-key"])
def test_corrupt_profile_dropped_and_reprobed(tmp_path, fake_probes, damage):
    _tune(tmp_path)
    path = _path(tmp_path)
    raw = path.read_text()
    if damage == "torn":
        path.write_text(raw[: len(raw) // 2])
    elif damage == "not-json":
        path.write_bytes(b"\x00\xffnot json")
    else:  # a foreign profile copied under this key's filename
        foreign = json.loads(raw)
        foreign["device_kind"] = "somebody-else"
        path.write_text(json.dumps(foreign))
    store = TuningStore(str(tmp_path))
    assert store.load("test-device", CPU_BACKEND, shape_class(*SHAPE)) is None
    assert store.stats()["corrupt_dropped"] == 1 and not path.exists()
    assert _tune(tmp_path)["source"] == "probed"
    assert fake_probes == ["feed", "feed"]


@pytest.mark.parametrize("how", ["raises", "fault-seam"])
def test_probe_failure_skips_group_keeps_defaults(tmp_path, monkeypatch, how):
    def bad(reps, smoke, defaults, device):
        raise RuntimeError("probe exploded")

    def good(reps, smoke, defaults, device):
        return {"fetch_depth": 4}, _fake_report(probes=1)

    first = bad if how == "raises" else good
    monkeypatch.setattr(probemod, "PROBE_GROUPS", {
        "feed": (first, ("feed_workers",)), "fetch": (good, ("fetch_depth",)),
    })
    if how == "fault-seam":
        faults.activate(faults.parse_schedule("seed=1,tune.probe@0"))
    try:
        p = _tune(tmp_path)
    finally:
        faults.deactivate()
    assert p["groups"]["feed"]["ok"] is False
    assert p["knobs"]["feed_workers"] == KNOB_DEFAULTS["feed_workers"]
    assert p["groups"]["fetch"]["ok"] is True and p["knobs"]["fetch_depth"] == 4


# -- "auto" resolution -----------------------------------------------------

def test_explicit_wins_auto_pulls_profile(tmp_path, fake_probes):
    _tune(tmp_path, device_kind=None, backend=None)  # keyed on the real CPU identity
    cfg = RunConfig(feed_workers="auto", tile_size=64, tune_store_dir=str(tmp_path))
    resolved, info = resolve_config(cfg, scene_shape=SHAPE, device="cpu")
    assert resolved.feed_workers == 3 and resolved.tile_size == 64
    assert info["source"] == "store" and info["probes"] == 0
    assert info["knobs"] == {"feed_workers": 3} and "age_s" in info


def test_auto_without_store_is_the_default_config():
    cfg = RunConfig(**{k: "auto" for k in TUNABLE_KNOBS})
    resolved, info = resolve_config(cfg, scene_shape=(256, 256, 30), device="cpu")
    assert info["source"] == "defaults"
    assert resolved == RunConfig()


def test_no_auto_is_identity_passthrough():
    cfg = RunConfig()
    resolved, info = resolve_config(cfg, scene_shape=(256, 256, 30))
    assert resolved is cfg and info is None


def test_auto_key_miss_falls_back_to_defaults(tmp_path):
    cfg = RunConfig(feed_workers="auto", tune_store_dir=str(tmp_path))
    resolved, info = resolve_config(cfg, scene_shape=(64, 64, 10), device="cpu")
    assert resolved.feed_workers == KNOB_DEFAULTS["feed_workers"]
    assert info["source"] == "defaults"


def test_non_auto_string_rejected_at_config_time():
    with pytest.raises(ValueError, match="integer or 'auto'"):
        RunConfig(feed_workers="fast")


def test_run_resolves_auto_and_reports_the_profile(tmp_path, fake_probes):
    """A Run with "auto" knobs resolves them once, for its device: the
    summary carries the ``tune`` block, the stream a ``tune_profile`` event,
    and the rasters equal a run with the same values given explicitly."""
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.obs.events import iter_events
    from land_trendr_tpu_torch.runtime import Run, assemble_outputs, stack_from_synthetic

    stack = stack_from_synthetic(make_stack(SceneSpec(width=40, height=32, year_start=1995,
                                                      year_end=2014, seed=3)))
    store = tmp_path / "store"
    autotune(str(store), height=32, width=40, n_years=20, device="cpu")
    auto = RunConfig(tile_size=16, feed_workers="auto", out_overviews="auto",
                     tune_store_dir=str(store), telemetry=True,
                     workdir=str(tmp_path / "a"), out_dir=str(tmp_path / "ao"))
    run = Run(stack, auto, device="cpu")
    assert run.cfg.feed_workers == 3 and run.cfg.out_overviews == "auto"
    summary = run.execute()
    assert summary["tune"]["source"] == "store" and summary["tune"]["knobs"] == {"feed_workers": 3}
    evs = [e for e in iter_events(summary["telemetry"]["events"]) if e["ev"] == "tune_profile"]
    assert len(evs) == 1 and evs[0]["key"] == summary["tune"]["key"]
    explicit = dataclasses.replace(auto, feed_workers=3, tune_store_dir=None, telemetry=False,
                                   workdir=str(tmp_path / "e"), out_dir=str(tmp_path / "eo"))
    Run(stack, explicit, device="cpu").execute()
    a = assemble_outputs(stack, run.cfg, device="cpu")
    b = assemble_outputs(stack, explicit, device="cpu")
    for name in a:
        assert Path(a[name]).read_bytes() == Path(b[name]).read_bytes(), name


# -- drift pins against RunConfig and the JAX package ----------------------

def test_knob_defaults_match_runconfig():
    by_name = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    for knob in TUNABLE_KNOBS:
        assert KNOB_DEFAULTS[knob] == by_name[knob], knob
    assert TUNABLE_KNOBS == JAX_TUNABLE_KNOBS
    assert KNOB_DEFAULTS == JAX_KNOB_DEFAULTS


def test_probe_groups_cover_every_tunable_knob():
    covered = {k for _fn, knobs in probemod.PROBE_GROUPS.values() for k in knobs}
    assert covered == set(TUNABLE_KNOBS)
    assert {g: k for g, (_f, k) in probemod.PROBE_GROUPS.items()} == {
        g: k for g, (_f, k) in jax_probemod.PROBE_GROUPS.items()
    }
    assert probemod.CUTOFF == jax_probemod.CUTOFF


@pytest.mark.parametrize(
    "shape",
    [(1, 1, 1), (256, 256, 30), (512, 512, 8), (512, 512, 40), (1024, 1024, 30),
     (1400, 1400, 32), (5000, 5000, 40), (8192, 8192, 64), (3, 100000, 17)],
)
def test_shape_class_equals_jax(shape):
    assert shape_class(*shape) == jax_shape_class(*shape)


def test_shape_class_buckets():
    assert shape_class(1024, 1024, 30) == shape_class(1400, 1400, 32)
    assert shape_class(256, 256, 30) != shape_class(8192, 8192, 30)
    assert shape_class(512, 512, 8) != shape_class(512, 512, 40)


def test_port_and_jax_profile_keys_differ_on_one_host(tmp_path):
    """Same host, same scene class: the two packages key apart, so a store
    shared by both never hands one package's profile to the other — while
    the file format itself is the JAX package's."""
    import jax

    assert TUNE_SCHEMA == JAX_TUNE_SCHEMA
    sc = shape_class(*SHAPE)
    port_kind, port_backend = device_identity("cpu")
    jax_kind, jax_backend = jax_device_identity()
    assert jax.default_backend() == "cpu" and port_backend == CPU_BACKEND != jax_backend
    assert profile_key(port_kind, port_backend, sc) != jax_profile_key(jax_kind, jax_backend, sc)
    profile = {"schema": TUNE_SCHEMA, "device_kind": port_kind, "backend": port_backend,
               "shape_class": sc, "knobs": dict(KNOB_DEFAULTS), "created_t": 1.0}
    TuningStore(str(tmp_path)).save(profile)
    assert JaxTuningStore(str(tmp_path)).load(jax_kind, jax_backend, sc) is None
    assert JaxTuningStore(str(tmp_path)).load(port_kind, port_backend, sc) == profile


@pytest.mark.parametrize("group", list(probemod.PROBE_GROUPS))
def test_real_probe_group_runs_on_the_cpu(group):
    """Each real probe group, smoke-sized, one rep: it returns its knobs
    and a report whose best never loses to the default."""
    best, report = probemod.probe_group(group, reps=1, smoke=True, defaults=KNOB_DEFAULTS,
                                        device="cpu")
    assert set(best) == set(probemod.PROBE_GROUPS[group][1])
    assert report["best_s"] <= report["default_s"] and report["probes"] >= 1


# -- the tune CLI -----------------------------------------------------------

def _cli(tmp_path, *extra):
    from land_trendr_tpu_torch.cli import main

    return main(["--device", "cpu", "tune", "--store-dir", str(tmp_path / "store"),
                 "--smoke", "--reps", "1", *extra])


def test_cli_dry_run_reports_but_writes_nothing(tmp_path, capsys, fake_probes):
    assert _cli(tmp_path, "--dry-run") == 0
    report = json.loads(capsys.readouterr().out)
    assert report["source"] == "probed" and report["persisted"] is False
    assert "feed" in report["groups"]
    assert not list((tmp_path / "store").glob("profile-*.json"))


def test_cli_persists_then_reports_store_hit(tmp_path, capsys, fake_probes):
    assert _cli(tmp_path) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["persisted"] is True and Path(report["profile_path"]).exists()
    assert _cli(tmp_path) == 0
    warm = json.loads(capsys.readouterr().out)
    assert warm["source"] == "store" and warm["probes"] == 0
    assert warm["knobs"] == report["knobs"] and fake_probes == ["feed"]


def test_cli_report_keys_equal_jax(tmp_path, capsys, monkeypatch, fake_probes):
    from land_trendr_tpu import cli as jcli

    def jax_fake(reps, smoke, defaults):
        return {"feed_workers": 3}, _fake_report()

    monkeypatch.setattr(jax_probemod, "PROBE_GROUPS", {"feed": (jax_fake, ("feed_workers",))})
    for main_argv, out in ((None, "port"), (["tune", "--store-dir", str(tmp_path / "j"),
                                            "--smoke", "--reps", "1"], "jax")):
        if main_argv is None:
            assert _cli(tmp_path) == 0
            port = json.loads(capsys.readouterr().out)
        else:
            assert jcli.main(main_argv) == 0
            ref = json.loads(capsys.readouterr().out)
    assert port.keys() == ref.keys()
    assert port["groups"]["feed"].keys() == ref["groups"]["feed"].keys()
    assert port["knobs"] == ref["knobs"]
