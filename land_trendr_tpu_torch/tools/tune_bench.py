"""Autotuner bench: tuned against default, and the tuning-store lifecycle.

Counterpart of the JAX package's ``tools/tune_bench.py`` over the port's
:mod:`~land_trendr_tpu_torch.tune`.  On ``--device`` it probes a profile
for a synthetic scene, then proves the store lifecycle — a warm reload
runs ZERO probes and resolves identical knob values, the profile round
trip is byte-stable, ``"auto"`` resolution is deterministic — and runs
the end-to-end parity leg: a default-config segment run against an
``"auto"``-knob run resolving through the probed profile, whose artifacts
must be byte-identical (the tuned knobs are pure execution facts), with
the tuned run's ``tune_profile`` event reporting the zero-probe store hit.
Each probe group reports its default's and its winner's median seconds;
the full run also asks that one group reached ``SPEEDUP_FLOOR`` (a timing
verdict, left out of the smoke's ``ok`` as in the JAX tool).

Usage::

    python -m land_trendr_tpu_torch.tools.tune_bench [--smoke] [--out TUNE.json]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import digest_workdir, record_meta, write_json_atomic

__all__ = ["SPEEDUP_FLOOR", "main", "run_bench"]

#: the full-mode speedup floor at least one probed group must reach
SPEEDUP_FLOOR = 1.10


def run_bench(smoke: bool, out_path: "str | None", keep: "str | None" = None,
              device: str = "cuda", argv: "list[str] | None" = None) -> dict:
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.obs.events import iter_events
    from land_trendr_tpu_torch.runtime import RunConfig, run_stack, stack_from_synthetic
    from land_trendr_tpu_torch.tune import TuningStore, autotune, resolve_config

    root = Path(keep or tempfile.mkdtemp(prefix="lt_tune_bench_"))
    root.mkdir(parents=True, exist_ok=True)
    store_dir = str(root / "store")
    size = 96 if smoke else 192
    ny = 12 if smoke else 24
    tile = 32 if smoke else 64
    reps = 2 if smoke else 3
    report: dict = {
        **record_meta("land_trendr_tpu_torch.tools.tune_bench", argv, device),
        "smoke": smoke,
        "scene": {"size": size, "years": ny, "tile": tile},
        "legs": {},
        "invariants": {},
    }
    inv = report["invariants"]
    try:
        # -- leg 1: cold probe ---------------------------------------------
        t0 = time.perf_counter()
        p1 = autotune(store_dir, height=size, width=size, n_years=ny, device=device,
                      smoke=smoke, reps=reps)
        report["legs"]["probe"] = {
            "wall_s": round(time.perf_counter() - t0, 3),
            "source": p1["source"],
            "probes": p1["probes"],
            "knobs": p1["knobs"],
            "groups": {g: {k: r[k] for k in ("ok", "probes", "default_s", "best_s", "speedup")
                           if k in r} for g, r in p1["groups"].items()},
        }
        speedups = [r.get("speedup", 1.0) for r in p1["groups"].values() if r.get("ok")]
        report["max_group_speedup"] = max(speedups) if speedups else None
        inv["all_groups_probed"] = all(r.get("ok") for r in p1["groups"].values())
        # every candidate set holds the default: the winner matches or beats it
        inv["tuned_never_worse_than_default"] = all(
            r["best_s"] <= r["default_s"] + 1e-9 for r in p1["groups"].values() if r.get("ok"))
        inv["group_speedup_floor_met"] = bool(speedups and max(speedups) >= SPEEDUP_FLOOR)

        # -- leg 2: warm store (zero probes, identical knobs) ----------------
        t0 = time.perf_counter()
        p2 = autotune(store_dir, height=size, width=size, n_years=ny, device=device,
                      smoke=smoke, reps=reps)
        report["legs"]["warm"] = {"wall_s": round(time.perf_counter() - t0, 6),
                                  "source": p2["source"]}
        inv["warm_zero_probes"] = p2["source"] == "store"
        inv["warm_identical_knobs"] = p2["knobs"] == p1["knobs"]

        # -- leg 3: the profile round trip is byte-stable -------------------
        store = TuningStore(store_dir)
        path = store.path_for(p1["key"])
        before = Path(path).read_bytes()
        store.save(store.load(p1["device_kind"], p1["backend"], p1["shape_class"]))
        inv["profile_roundtrip_byte_stable"] = Path(path).read_bytes() == before

        # -- leg 4: deterministic "auto" resolution -------------------------
        auto_kw = dict(feed_workers="auto", decode_workers="auto", feed_cache_mb="auto",
                       fetch_depth="auto", upload_depth="auto", tune_store_dir=store_dir)
        base_kw = dict(params=LTParams(max_segments=4, vertex_count_overshoot=2),
                       tile_size=tile, retry_backoff_s=0.0)
        probe_cfg = RunConfig(workdir="x", out_dir="y", **base_kw, **auto_kw)
        r1, i1 = resolve_config(probe_cfg, scene_shape=(size, size, ny), device=device)
        r2, i2 = resolve_config(probe_cfg, scene_shape=(size, size, ny), device=device)
        # determinism is about the resolved VALUES (age_s is a live clock)
        inv["resolution_deterministic"] = (
            r1 == r2 and {k: v for k, v in i1.items() if k != "age_s"}
            == {k: v for k, v in i2.items() if k != "age_s"} and i1["source"] == "store")
        report["resolved_knobs"] = i1["knobs"]

        # -- leg 5: end-to-end parity (default against tuned) ---------------
        stack = stack_from_synthetic(make_stack(SceneSpec(
            width=size, height=size, year_start=2000, year_end=2000 + ny - 1, seed=11)))
        # a warm-up run first: both timed legs share one process's loaded
        # kernel library, so whichever ran first would carry its load
        wd_warm = str(root / "run_warmup")
        run_stack(stack, RunConfig(workdir=wd_warm, out_dir=wd_warm + "_o", **base_kw),
                  device=device)
        wd_def = str(root / "run_default")
        t0 = time.perf_counter()
        run_stack(stack, RunConfig(workdir=wd_def, out_dir=wd_def + "_o", **base_kw),
                  device=device)
        wall_def = time.perf_counter() - t0
        wd_tuned = str(root / "run_tuned")
        t0 = time.perf_counter()
        summary = run_stack(stack, RunConfig(workdir=wd_tuned, out_dir=wd_tuned + "_o",
                                             telemetry=True, **base_kw, **auto_kw),
                            device=device)
        wall_tuned = time.perf_counter() - t0
        report["legs"]["e2e"] = {"default_wall_s": round(wall_def, 3),
                                 "tuned_wall_s": round(wall_tuned, 3),
                                 "e2e_speedup": round(wall_def / wall_tuned, 3),
                                 "tune": summary.get("tune")}
        inv["artifacts_byte_identical"] = digest_workdir(wd_def) == digest_workdir(wd_tuned)
        profs = [r for r in iter_events(str(Path(wd_tuned) / "events.jsonl"))
                 if r["ev"] == "tune_profile"]
        inv["run_tune_profile_event"] = (len(profs) == 1 and profs[0]["source"] == "store"
                                         and profs[0]["probes"] == 0)
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)

    checked = dict(inv)
    if smoke:
        # the smoke's speedups are noise; its contract is the structure
        checked.pop("group_speedup_floor_met", None)
    report["ok"] = all(checked.values())
    if out_path:
        write_json_atomic(out_path, report, trailing_newline=False)
    return report


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale mode (structural invariants only)")
    ap.add_argument("--out", default=None, metavar="FILE", help="write the JSON report here")
    ap.add_argument("--keep", default=None, metavar="DIR", help="keep workdirs under DIR")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device).type
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    report = run_bench(smoke=args.smoke, out_path=args.out, keep=args.keep, device=device,
                       argv=argv)
    if args.out:
        print(f"wrote {args.out}")
    print(json.dumps({"ok": report["ok"], "max_group_speedup": report.get("max_group_speedup"),
                      "invariants": report["invariants"]}, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
