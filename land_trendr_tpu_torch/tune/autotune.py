"""Autotuned execution profiles: probe, persist, resolve.

Counterpart of ``land_trendr_tpu/tune/autotune.py``.

* :func:`autotune` runs the staged calibration probes
  (:mod:`~land_trendr_tpu_torch.tune.probes`, one short probe per knob
  group, coordinate-wise with median-of-reps timing and early cutoff) on
  the run's device and persists the winning profile to the on-disk
  :class:`~land_trendr_tpu_torch.tune.store.TuningStore` keyed by
  ``(device_kind, backend, scene shape class, TUNE_SCHEMA)``.  A key
  already in the store is **reloaded on sight with ZERO probes**
  (``tune_profile`` event ``source="store"``, ``probes=0``); only a key
  miss or ``retune=True`` probes again.
* :func:`resolve_config` makes the knobs *resolve*: ``RunConfig`` fields
  set to the ``"auto"`` sentinel pull their value from the loaded
  profile at ``Run`` construction.  Explicit values ALWAYS win; with no
  store (or no profile for the key) every ``"auto"`` resolves to the
  hardcoded default.  Resolution never probes and never writes.

A probe failure — injected at the ``tune.probe`` fault seam or real —
skips THAT knob group (its knobs keep their defaults, the ``tune_probe``
event carries ``ok=false``) and never fails the tuner.

``telemetry`` (an :class:`~land_trendr_tpu_torch.obs.telemetry.Telemetry`)
receives one ``tune_probe`` event per probed group and one terminal
``tune_profile`` event, and advances the ``lt_tune_*`` instruments;
``None`` keeps the tuner silent.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from land_trendr_tpu_torch.tune.store import (
    TUNE_SCHEMA,
    TuningStore,
    profile_key,
    shape_class,
)

__all__ = [
    "AUTO",
    "CPU_BACKEND",
    "KNOB_DEFAULTS",
    "TUNABLE_KNOBS",
    "autotune",
    "device_identity",
    "resolve_config",
]

#: the RunConfig sentinel ``"auto"`` fields resolve through the profile
AUTO = "auto"

#: every RunConfig field the tuner may own (the packed on/off strategies
#: carry their own device-based "auto" in runtime/feed + runtime/fetch,
#: and ``out_overviews="auto"`` is a raster-size rule, not a profile knob)
TUNABLE_KNOBS = (
    "tile_size",
    "chunk_px",
    "fetch_depth",
    "upload_depth",
    "feed_workers",
    "decode_workers",
    "feed_cache_mb",
)

#: the hardcoded RunConfig defaults — what ``"auto"`` means with no
#: profile; ``tests/test_torch_tune.py`` pins them to the dataclass
#: (the driver imports this module, so it cannot import the driver)
KNOB_DEFAULTS: dict[str, Any] = {
    "tile_size": 256,
    "chunk_px": 262_144,
    "fetch_depth": 2,
    "upload_depth": 2,
    "feed_workers": 1,
    "decode_workers": 0,
    "feed_cache_mb": 256,
}

#: this package's backend string on the CPU; never the JAX package's
#: ``"cpu"``, so a store shared by both packages keys them apart
CPU_BACKEND = "torch-cpu"


def device_identity(device: "torch.device | str | None" = None) -> "tuple[str, str]":
    """``(device_kind, backend)`` of the run's ``device`` — the hardware
    half of the store key: ``(torch.cuda.get_device_name(device), "cuda")``
    on a CUDA device, ``("cpu", "torch-cpu")`` on the CPU.  ``None`` means
    the current CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return str(torch.cuda.get_device_name(dev)), "cuda"
    if dev.type == "cpu":
        return "cpu", CPU_BACKEND
    raise ValueError(f"device {device!r} is neither 'cuda' nor 'cpu'")


def autotune(
    store_dir: str,
    *,
    height: int,
    width: int,
    n_years: int,
    device: "torch.device | str" = "cuda",
    groups: "tuple[str, ...] | None" = None,
    reps: int = 3,
    smoke: bool = False,
    retune: bool = False,
    persist: bool = True,
    telemetry=None,
    device_kind: "str | None" = None,
    backend: "str | None" = None,
) -> dict:
    """Probe (or reload) the profile for ``device`` + this scene class.

    Returns the profile dict; ``profile["probes"] == 0`` means a store
    hit served it without running anything.  ``persist=False`` is the
    ``lt tune --dry-run`` contract: probe and report, write nothing.
    ``groups`` restricts probing to a subset (unnamed groups keep their
    default knobs); ``smoke`` shrinks every probe workload to seconds
    scale.  ``device_kind``/``backend`` override the device's identity
    (how the tests make a key miss).
    """
    from land_trendr_tpu_torch.runtime import faults
    from land_trendr_tpu_torch.tune import probes as probemod

    dev = torch.device(device)
    if device_kind is None or backend is None:
        dk, be = device_identity(dev)
        device_kind = device_kind or dk
        backend = backend or be
    shape_cls = shape_class(height, width, n_years)
    key = profile_key(device_kind, backend, shape_cls)
    store = TuningStore(store_dir)

    if not retune:
        profile = store.load(device_kind, backend, shape_cls)
        if profile is not None:
            if telemetry is not None:
                telemetry.tune_profile(
                    key=key,
                    source="store",
                    probes=0,
                    age_s=max(0.0, time.time() - float(profile["created_t"])),
                    knobs=dict(profile["knobs"]),
                    groups=len(profile.get("groups", {})),
                )
            # "source" is caller information (a store hit ran zero
            # probes), never persisted — the stored bytes stay canonical
            return {**profile, "source": "store", "key": key}

    group_names = tuple(groups) if groups is not None else tuple(probemod.PROBE_GROUPS)
    unknown = [g for g in group_names if g not in probemod.PROBE_GROUPS]
    if unknown:
        raise ValueError(
            f"unknown probe group(s) {unknown}; choose from {tuple(probemod.PROBE_GROUPS)}"
        )

    knobs = dict(KNOB_DEFAULTS)
    group_reports: dict[str, dict] = {}
    total_probes = 0
    for group in group_names:
        t0 = time.perf_counter()
        try:
            # the tune.probe fault seam: an injected (or real) probe
            # failure skips THIS group — defaults survive, the tuner lives
            faults.check("tune.probe")
            best, report = probemod.probe_group(
                group, reps=reps, smoke=smoke, defaults=KNOB_DEFAULTS, device=dev
            )
        except Exception as e:
            wall = time.perf_counter() - t0
            group_reports[group] = {
                "ok": False,
                "probes": 0,
                "error": str(e),
                "wall_s": round(wall, 6),
            }
            if telemetry is not None:
                telemetry.tune_probe(group=group, ok=False, probes=0, wall_s=wall, error=str(e))
            continue
        wall = time.perf_counter() - t0
        knobs.update(best)
        total_probes += int(report.get("probes", 0))
        group_reports[group] = {"ok": True, "knobs": best, "wall_s": round(wall, 6), **report}
        if telemetry is not None:
            telemetry.tune_probe(
                group=group,
                ok=True,
                probes=int(report.get("probes", 0)),
                wall_s=wall,
                speedup=report.get("speedup"),
                knobs=dict(best),
            )

    profile = {
        "schema": TUNE_SCHEMA,
        "device_kind": device_kind,
        "backend": backend,
        "shape_class": shape_cls,
        "created_t": time.time(),
        "probes": total_probes,
        "knobs": knobs,
        "groups": group_reports,
    }
    if persist:
        store.save(profile)
    if telemetry is not None:
        telemetry.tune_profile(
            key=key,
            source="probed",
            probes=total_probes,
            age_s=0.0,
            knobs=dict(knobs),
            groups=len(group_reports),
        )
    return {**profile, "source": "probed", "key": key}


def resolve_config(
    cfg,
    scene_shape: "tuple[int, int, int] | None" = None,
    device: "torch.device | str | None" = None,
):
    """Resolve a RunConfig's ``"auto"`` knobs for a run on ``device``;
    returns ``(cfg, info)``.

    ``scene_shape`` is ``(height, width, n_years)`` — the shape-class half
    of the store key.  With no ``"auto"`` field the config passes through
    untouched (``info=None``, no device or store access).  Otherwise each
    ``"auto"`` field takes the loaded profile's value (store hit) or the
    hardcoded default (no store configured, key miss, or no shape to key
    on) — explicit values always win, since only ``"auto"`` fields are
    replaced.  ``info`` is the ``tune_profile`` event payload (``probes``
    is always 0 here: resolution never probes).
    """
    auto_fields = [f for f in TUNABLE_KNOBS if getattr(cfg, f) == AUTO]
    if not auto_fields:
        return cfg, None
    profile = None
    key = ""
    if cfg.tune_store_dir and scene_shape is not None:
        device_kind, backend = device_identity(device)
        shape_cls = shape_class(*scene_shape)
        key = profile_key(device_kind, backend, shape_cls)
        profile = TuningStore(cfg.tune_store_dir).load(device_kind, backend, shape_cls)
    knobs = {
        f: (
            profile["knobs"].get(f, KNOB_DEFAULTS[f])
            if profile is not None
            else KNOB_DEFAULTS[f]
        )
        for f in auto_fields
    }
    info: dict[str, Any] = {
        "key": key,
        "source": "store" if profile is not None else "defaults",
        "probes": 0,
        "knobs": knobs,
    }
    if profile is not None:
        info["age_s"] = round(max(0.0, time.time() - float(profile["created_t"])), 3)
    return dataclasses.replace(cfg, **knobs), info
