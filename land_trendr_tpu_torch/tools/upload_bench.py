"""Upload-path bench: the packed async host→device upload, and the ingest store.

Counterpart of the JAX package's ``tools/upload_bench.py``, in one report:

**Upload** — a synthetic fed-tile workload (uint16 DN bands + uint16 QA,
``(tile_px, NY)``, the arrays ``_feed_tile`` produces) crosses to
``--device`` three ways over the same tile sweep, through the port's
:class:`~land_trendr_tpu_torch.runtime.feed.TileUploader`:

* ``per_array_sync`` — one copy per fed array per tile (the driver's
  ``--no-packed-upload`` path);
* ``packed_sync``   — ONE host-side pack into pinned memory and ONE async
  copy per tile, awaited at once (the transfer-count win);
* ``packed_async``  — the driver's pipeline: at most ``--depth`` packed
  copies in flight.

On the card the copies are real and the link model is off by default; on
the CPU (``--device cpu``, the tests) there is no link, so the JAX tool's
model stands in (each transfer lands ``latency + bytes/bandwidth`` after
issue, 5 ms / 8 GB/s there) and the packed legs pack and unpack on the
host.  Packed arrays are checked byte for byte against the fed arrays
every run.

**Ingest store** — over :mod:`~land_trendr_tpu_torch.tools.feed_bench`'s
tiled-deflate scene and window sweep, the persistent decoded-block store
(:mod:`~land_trendr_tpu_torch.io.blockstore`): store off, cold ingest,
warm rerun (same process) and restart rerun (a fresh ``BlockStore`` over
the same directory).  The warm and restart passes must skip TIFF decode
entirely (zero misses, hit rate 1.0) with window reads byte-identical to
store-off.

Usage::

    python -m land_trendr_tpu_torch.tools.upload_bench [--out UPLOAD.json]
        [--smoke] [--no-store] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from land_trendr_tpu_torch.io import blockcache
from land_trendr_tpu_torch.io.blockstore import BlockStore
from land_trendr_tpu_torch.runtime import feed as feedmod
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools import feed_bench
from land_trendr_tpu_torch.tools.fetch_bench import LinkModel
from land_trendr_tpu_torch.tools.measure import record_meta, write_json_atomic

__all__ = ["bench_store", "main", "synth_inputs"]

#: the JAX tool's modeled link, used where no real one exists (the CPU)
CPU_LINK = (5.0, 8.0)


def synth_inputs(px: int, ny: int, bands: int, seed: int):
    """One fed tile's arrays: uint16 DN bands + uint16 QA, ``(px, ny)``
    (random content: the upload stage moves bytes, it never reads them)."""
    rng = np.random.default_rng(seed)
    dn = {f"b{i}": rng.integers(7273, 43636, (px, ny)).astype(np.uint16) for i in range(bands)}
    qa = rng.integers(0, 2, (px, ny)).astype(np.uint16) * 21824
    return dn, qa


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_per_array(payloads, n_tiles: int, link: LinkModel, device) -> dict:
    """One copy per fed array per tile, each paying the link (when
    modeled) before the next is issued."""
    up = feedmod.TileUploader(device, packed=False)
    t0 = time.perf_counter()
    for i in range(n_tiles):
        dn, qa = payloads[i % len(payloads)]
        if link.enabled:
            for a in (*dn.values(), qa):
                torch.from_numpy(a).to(device)
                link.wait(link.land_at(a.nbytes))
            up.stats.add(tiles=1, transfers=len(dn) + 1,
                         bytes=sum(a.nbytes for a in dn.values()) + qa.nbytes)
        else:
            up.start(dn, qa).arrays()
    _sync(device)
    return {"wall_s": time.perf_counter() - t0, "stats": up.summary()}


def run_packed(payloads, n_tiles: int, link: LinkModel, depth: int, device) -> dict:
    """The packed pipeline at ``depth`` in flight (1 = fully sync): on the
    card the driver's uploader; on the CPU the same plan packed and
    unpacked on the host."""
    cuda = device.type == "cuda"
    up = feedmod.TileUploader(device, packed=True) if cuda else None
    plan = feedmod.build_plan(*payloads[0])
    wire = feedmod.plan_wire_bytes(plan)
    queue: list = []

    def drain(limit: int) -> None:
        while len(queue) > limit:
            handle, land_at = queue.pop(0)
            link.wait(land_at)
            if cuda:
                handle.arrays()
            else:
                feedmod.unpack_inputs(torch.from_numpy(handle.view(np.int32)), plan)

    t0 = time.perf_counter()
    for i in range(n_tiles):
        dn, qa = payloads[i % len(payloads)]
        handle = up.start(dn, qa) if cuda else feedmod.pack_inputs(dn, qa, plan)
        queue.append((handle, link.land_at(wire)))
        drain(depth - 1)
    drain(0)
    _sync(device)
    stats = up.summary() if cuda else {"transfers": n_tiles, "bytes": wire * n_tiles}
    return {"wall_s": time.perf_counter() - t0, "stats": stats}


def check_parity(payloads, device) -> int:
    """Packed arrays on the device byte-identical to the fed host arrays."""
    checked = 0
    for dn, qa in payloads:
        if device.type == "cuda":
            u_dn, u_qa = feedmod.TileUploader(device, packed=True).start(dn, qa).arrays()
        else:
            plan = feedmod.build_plan(dn, qa)
            words = feedmod.pack_inputs(dn, qa, plan)
            u_dn, u_qa = feedmod.unpack_inputs(torch.from_numpy(words.view(np.int32)), plan)
        for name, host in (*dn.items(), ("qa", qa)):
            got = (u_qa if name == "qa" else u_dn[name]).cpu().numpy()
            if got.dtype != host.dtype or got.shape != host.shape or \
                    got.tobytes() != host.tobytes():
                raise AssertionError(f"upload parity mismatch on {name}")
            checked += 1
    return checked


def bench_store(args, tmp_root: str) -> dict:
    """Store off, cold, warm and restart over the feed bench's scene."""
    scene_dir = os.path.join(tmp_root, "scene")
    store_dir = os.path.join(tmp_root, "store")
    paths = feed_bench.build_scene(scene_dir, args.store_size, args.store_years, args.seed)
    wins = feed_bench.plan_windows(args.store_size, args.store_window)
    px = args.store_size * args.store_size * args.store_years

    def timed_sweep() -> "tuple[float, dict]":
        base = blockcache.stats_snapshot()
        t0 = time.perf_counter()
        feed_bench.sweep(paths, wins, readahead=False)
        return time.perf_counter() - t0, blockcache.stats_delta(base)

    # RAM tier OFF throughout: this phase isolates the persistent store
    blockcache.configure(0, 1)
    timed_sweep()  # untimed: the scene into the page cache
    off_wall, off_cache = timed_sweep()

    store = BlockStore(store_dir, budget_bytes=args.store_mb << 20)
    blockcache.configure(0, 1, store=store)
    base = store.stats_snapshot()
    cold_wall, cold_cache = timed_sweep()
    cold = store.stats_delta(base)
    store.flush()
    base = store.stats_snapshot()
    warm_wall, warm_cache = timed_sweep()
    warm = store.stats_delta(base)
    parity_warm = feed_bench.check_parity(paths, wins)
    store.close()

    # restart: a FRESH BlockStore over the same directory
    store2 = BlockStore(store_dir, budget_bytes=args.store_mb << 20)
    blockcache.configure(0, 1, store=store2)
    base = store2.stats_snapshot()
    restart_wall, restart_cache = timed_sweep()
    restart = store2.stats_delta(base)
    parity_restart = feed_bench.check_parity(paths, wins)
    store2.close()
    blockcache.configure(0, None)

    def rate(s: dict) -> "float | None":
        lookups = s["hits"] + s["misses"]
        return round(s["hits"] / lookups, 4) if lookups else None

    for name, s in (("warm", warm), ("restart", restart)):
        if s["misses"]:
            raise AssertionError(f"{name} store pass missed {s['misses']} blocks: decode "
                                 "was not fully skipped")

    def leg(wall, cache, stats=None) -> dict:
        out = {"wall_s": round(wall, 4), "decode_s": cache["decode_s"]}
        if stats is not None:
            out.update(stats=stats, hit_rate=rate(stats))
        return out

    return {
        "scene": {"size": args.store_size, "years": args.store_years,
                  "window": args.store_window, "windows": len(wins), "pixels": px,
                  "layout": "tiled-256 deflate+predictor uint16"},
        "store_mb": args.store_mb,
        "store_off": leg(off_wall, off_cache),
        "store_cold": leg(cold_wall, cold_cache, cold),
        "store_warm": leg(warm_wall, warm_cache, warm),
        "store_restart": leg(restart_wall, restart_cache, restart),
        "speedup_warm": round(off_wall / warm_wall, 3) if warm_wall else None,
        "speedup_restart": round(off_wall / restart_wall, 3) if restart_wall else None,
        "parity_windows_checked": parity_warm + parity_restart,
        "parity_ok": True,
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=128, help="tile edge in px")
    ap.add_argument("--years", type=int, default=24)
    ap.add_argument("--bands", type=int, default=2, help="DN bands a tile (QA always rides)")
    ap.add_argument("--tiles", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2, help="async in-flight bound")
    ap.add_argument("--link-ms", type=float, default=None,
                    help="modeled per-transfer latency (default: 0 on the card, 5 on the CPU)")
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="modeled bandwidth (default: 0 on the card, 8 on the CPU)")
    ap.add_argument("--reps", type=int, default=3, help="timed reps a mode; the median is kept")
    ap.add_argument("--seed", type=int, default=20260803)
    ap.add_argument("--store-size", type=int, default=2048)
    ap.add_argument("--store-years", type=int, default=6)
    ap.add_argument("--store-window", type=int, default=192)
    ap.add_argument("--store-mb", type=int, default=256)
    ap.add_argument("--no-store", action="store_true", help="skip the ingest-store phase")
    ap.add_argument("--out", default="UPLOAD_cuda.json")
    ap.add_argument("--smoke", action="store_true", help="tiny workload, seconds not minutes")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.smoke:
        args.tile = min(args.tile, 64)
        args.years = min(args.years, 12)
        args.tiles = min(args.tiles, 4)
        args.reps = 1
        args.store_size = min(args.store_size, 512)
        args.store_years = min(args.store_years, 3)
        args.store_window = min(args.store_window, 160)
    cuda = device.type == "cuda"
    link_ms = args.link_ms if args.link_ms is not None else (0.0 if cuda else CPU_LINK[0])
    link_gbps = args.link_gbps if args.link_gbps is not None else (0.0 if cuda else CPU_LINK[1])

    px = args.tile * args.tile
    payloads = [synth_inputs(px, args.years, args.bands, args.seed + k) for k in (0, 1)]
    link = LinkModel(link_ms, link_gbps)
    no_link = LinkModel(0.0, 0.0)
    parity_arrays = check_parity(payloads, device)
    n = args.tiles
    # untimed warm-up of both paths (first-touch allocations, pinned pool)
    run_per_array(payloads, n, no_link, device)
    run_packed(payloads, n, no_link, args.depth, device)

    def median(mode_fn) -> dict:
        runs = sorted((mode_fn() for _ in range(max(1, args.reps))), key=lambda r: r["wall_s"])
        # the median rep stands for the mode; every rep's wall is its spread
        return {**runs[len(runs) // 2], "wall_s_reps": [round(r["wall_s"], 6) for r in runs]}

    per_array = median(lambda: run_per_array(payloads, n, link, device))
    packed_sync = median(lambda: run_packed(payloads, n, link, 1, device))
    packed_async = median(lambda: run_packed(payloads, n, link, args.depth, device))
    raw_pa = median(lambda: run_per_array(payloads, n, no_link, device))
    raw_pk = median(lambda: run_packed(payloads, n, no_link, args.depth, device))

    def per_tile(r: dict) -> dict:
        return {"wall_s": round(r["wall_s"], 4), "ms_per_tile": round(r["wall_s"] / n * 1e3, 3),
                "wall_s_reps": r["wall_s_reps"]}

    pk = packed_sync["stats"]
    result = {
        **record_meta("land_trendr_tpu_torch.tools.upload_bench", argv, device.type),
        "workload": {
            "tile_px": px,
            "years": args.years,
            "bands": args.bands,
            "tiles": n,
            "bytes_per_tile_packed": pk["bytes"] // max(1, pk["transfers"]),
            "transfers_per_tile_per_array": per_array["stats"]["transfers"] // n,
            "transfers_per_tile_packed": pk["transfers"] // n,
        },
        "platform": device.type,
        "link_model": {
            "latency_ms": link_ms,
            "gbps": link_gbps,
            "note": ("modeled: transfers land latency + bytes/bandwidth after issue (the "
                     "CPU has no device link); all host work is real")
            if link.enabled else "disabled: the card's real link",
        },
        "per_array_sync": per_tile(per_array),
        "packed_sync": per_tile(packed_sync),
        "packed_async": {**per_tile(packed_async), "depth": args.depth},
        "speedup_packed_sync": round(per_array["wall_s"] / packed_sync["wall_s"], 3),
        "speedup_packed_async": round(per_array["wall_s"] / packed_async["wall_s"], 3),
        "raw_local": {
            "per_array_ms_per_tile": round(raw_pa["wall_s"] / n * 1e3, 3),
            "packed_ms_per_tile": round(raw_pk["wall_s"] / n * 1e3, 3),
            "note": "no link model",
        },
        "parity": {"tiles_checked": len(payloads), "arrays_checked": parity_arrays, "ok": True},
        "smoke": bool(args.smoke),
    }
    if not args.no_store:
        tmp = tempfile.mkdtemp(prefix="lt_upload_bench_")
        try:
            result["ingest_store"] = bench_store(args, tmp)
        finally:
            blockcache.configure(0, None)
            shutil.rmtree(tmp, ignore_errors=True)
    write_json_atomic(args.out, result)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
