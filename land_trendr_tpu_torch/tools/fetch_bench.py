"""Fetch-path bench: the packed async device→host fetch against per-product.

Counterpart of the JAX package's ``tools/fetch_bench.py`` over the port's
:class:`~land_trendr_tpu_torch.runtime.fetch.TileFetcher`.  A synthetic
tile-output workload on ``--device`` (the full segmentation product set
plus an FTV raster — 12 artifact products, the shape a multi-product run
fetches every tile) is fetched three ways over the same tile sweep:

* ``per_product_sync`` — one synchronous device→host copy per product per
  tile (the driver's ``--no-packed-fetch`` path, the real fetcher);
* ``packed_sync``   — one device-side pack and ONE copy per tile into
  pinned memory, awaited at once (the transfer-count win);
* ``packed_async``  — the driver's pipeline: tile *i*'s copy lands while
  tile *i+1* packs, at most ``--depth`` in flight (adds the overlap).

On the card the transfers are real (PCIe into pinned memory) and the
link model is off by default.  On the CPU (``--device cpu``, the tests)
there is no transfer at all, so the JAX tool's link model stands in at the
transfer points — each lands ``latency + bytes/bandwidth`` after issue
(``--link-ms`` / ``--link-gbps``, default 1 ms / 8 GB/s there) — and the
packed legs pack and unpack on the host.  Packed and per-product arrays
are checked byte for byte every run.  The report carries the fetcher's
transfer counts and the device copies a packed tile takes.

Usage::

    python -m land_trendr_tpu_torch.tools.fetch_bench [--out FETCH.json]
        [--smoke] [--device cuda|cpu] [--link-ms MS --link-gbps GBPS]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.segment import SegOutputs
from land_trendr_tpu_torch.ops.tile import TileOutputs
from land_trendr_tpu_torch.runtime import fetch as fetchmod
from land_trendr_tpu_torch.runtime.driver import RunConfig, TileSpec, resolve_device
from land_trendr_tpu_torch.tools.measure import record_meta, write_json_atomic

__all__ = ["LinkModel", "main", "synth_outputs"]

#: the JAX tool's modeled link, used where no real one exists (the CPU)
CPU_LINK = (1.0, 8.0)


def synth_outputs(px: int, ny: int, nv: int, nm: int, seed: int,
                  device: torch.device) -> TileOutputs:
    """A device-resident TileOutputs with the real shapes and dtypes
    (random content: the fetch stage moves bytes, it never reads them)."""
    rng = np.random.default_rng(seed)

    def f32(*s):
        return torch.as_tensor(rng.random(s, np.float32), device=device)

    def i32(lo, hi, *s):
        return torch.as_tensor(rng.integers(lo, hi, s).astype(np.int32), device=device)

    seg = SegOutputs(
        n_vertices=i32(0, nv, px),
        vertex_indices=i32(-1, ny, px, nv),
        vertex_years=f32(px, nv),
        vertex_src_vals=f32(px, nv),
        vertex_fit_vals=f32(px, nv),
        seg_magnitude=f32(px, nm),
        seg_duration=f32(px, nm),
        seg_rate=f32(px, nm),
        rmse=f32(px),
        p_of_f=f32(px),
        model_valid=torch.as_tensor(rng.integers(0, 2, px).astype(bool), device=device),
        fitted=f32(px, ny),
        despiked=f32(px, ny),
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return TileOutputs(seg=seg, ftv={"ndvi": f32(px, ny)}, change=None)


class LinkModel:
    """Per-transfer cost model: a transfer issued now lands at ``now +
    latency + bytes / bandwidth``; waiting sleeps out the remainder."""

    def __init__(self, latency_ms: float, gbps: float) -> None:
        self.latency_s = latency_ms / 1e3
        self.bps = gbps * 1e9

    @property
    def enabled(self) -> bool:
        return self.latency_s > 0 or self.bps > 0

    def land_at(self, nbytes: int) -> float:
        return time.perf_counter() + self.latency_s + (nbytes / self.bps if self.bps else 0.0)

    def wait(self, land_at: float) -> None:
        while (dt := land_at - time.perf_counter()) > 0:
            time.sleep(dt)


def run_per_product(cfg, outs, tiles, link: LinkModel, device) -> dict:
    """The per-product path (``TileFetcher(packed=False)``) with the link
    model, when on, at its one materialization seam."""
    fetcher = fetchmod.TileFetcher(cfg, device, packed=False)
    real_to_host = fetchmod._to_host

    def linked_to_host(arr):
        host = real_to_host(arr)
        link.wait(link.land_at(host.nbytes))
        return host

    fetchmod._to_host = linked_to_host if link.enabled else real_to_host
    try:
        t0 = time.perf_counter()
        for i, t in enumerate(tiles):
            fetcher.start(outs[i % len(outs)]).tile_arrays(t)
        wall = time.perf_counter() - t0
    finally:
        fetchmod._to_host = real_to_host
    return {"wall_s": wall, "stats": fetcher.summary()}


def run_packed(cfg, outs, tiles, link: LinkModel, depth: int, device) -> dict:
    """The packed pipeline at ``depth`` in flight (1 = fully sync): on the
    card the driver's fetcher (pack, one async copy into pinned memory, an
    event); on the CPU the same plan packed and unpacked on the host."""
    plan = fetchmod.build_plan(outs[0], cfg)
    wire = fetchmod.plan_wire_bytes(plan)
    fetcher = fetchmod.TileFetcher(cfg, device, packed=True) if device.type == "cuda" else None
    queue: list = []

    def drain(limit: int) -> None:
        while len(queue) > limit:
            t, handle, land_at = queue.pop(0)
            link.wait(land_at)
            if fetcher is not None:
                handle.tile_arrays(t)
            else:
                fetchmod.unpack_tile(plan, handle.numpy(), t.h * t.w)

    t0 = time.perf_counter()
    for i, t in enumerate(tiles):
        out = outs[i % len(outs)]
        handle = fetcher.start(out) if fetcher is not None else fetchmod.pack_tile(out, plan)
        queue.append((t, handle, link.land_at(wire)))
        drain(depth - 1)
    drain(0)
    wall = time.perf_counter() - t0
    stats = fetcher.summary() if fetcher is not None else {"transfers": len(tiles)}
    return {"wall_s": wall, "wire_bytes": wire, "stats": stats}


def check_parity(cfg, outs, tiles, device) -> int:
    """Packed and per-product tile arrays byte-identical (link model off)."""
    checked = 0
    for i, t in enumerate(tiles[: min(3, len(tiles))]):
        out = outs[i % len(outs)]
        if device.type == "cuda":
            packed, n_fit = fetchmod.TileFetcher(cfg, device, packed=True).start(out).tile_arrays(t)
        else:
            plan = fetchmod.build_plan(out, cfg)
            packed, mv = fetchmod.unpack_tile(plan, fetchmod.pack_tile(out, plan).numpy(),
                                              t.h * t.w)
            n_fit = int(mv.sum())
        ref, n_ref = fetchmod.TileFetcher(cfg, device, packed=False).start(out).tile_arrays(t)
        assert n_fit == n_ref, "model_valid rider mismatch"
        assert sorted(packed) == sorted(ref), (sorted(packed), sorted(ref))
        for k in ref:
            a, b = packed[k], ref[k]
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                raise AssertionError(f"parity mismatch on {k} (tile {i})")
            checked += 1
    return checked


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=128, help="tile edge in px")
    ap.add_argument("--years", type=int, default=24)
    ap.add_argument("--tiles", type=int, default=16,
                    help="tiles a timed sweep (the last one is an edge tile)")
    ap.add_argument("--depth", type=int, default=2, help="async in-flight bound")
    ap.add_argument("--f16", action="store_true", help="also fuse fetch_f16 casts into the pack")
    ap.add_argument("--link-ms", type=float, default=None,
                    help="modeled per-transfer latency (default: 0 on the card, 1 on the CPU)")
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="modeled bandwidth (default: 0 on the card, 8 on the CPU)")
    ap.add_argument("--reps", type=int, default=3, help="timed reps a mode; the median is kept")
    ap.add_argument("--seed", type=int, default=20260803)
    ap.add_argument("--out", default="FETCH_cuda.json")
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
    cuda = device.type == "cuda"
    link_ms = args.link_ms if args.link_ms is not None else (0.0 if cuda else CPU_LINK[0])
    link_gbps = args.link_gbps if args.link_gbps is not None else (0.0 if cuda else CPU_LINK[1])

    params = LTParams()
    nv, nm = params.max_vertices, params.max_segments
    px = args.tile * args.tile
    cfg = RunConfig(index="nbr", ftv_indices=("ndvi",), params=params, tile_size=args.tile,
                    fetch_f16=args.f16, fetch_depth=args.depth)
    # two payloads alternated (two keep any caching honest) and an edge
    # tile, so the crop path runs
    outs = [synth_outputs(px, args.years, nv, nm, args.seed + k, device) for k in (0, 1)]
    tiles = [TileSpec(i, 0, 0, args.tile, args.tile) for i in range(args.tiles - 1)]
    tiles.append(TileSpec(args.tiles - 1, 0, 0, args.tile - 5, args.tile - 3))
    link = LinkModel(link_ms, link_gbps)
    no_link = LinkModel(0.0, 0.0)

    parity_products = check_parity(cfg, outs, tiles, device)
    # untimed warm-up of both paths (first-touch allocations, pinned pool)
    run_per_product(cfg, outs, tiles, no_link, device)
    run_packed(cfg, outs, tiles, no_link, args.depth, device)

    def median(mode_fn) -> dict:
        runs = sorted((mode_fn() for _ in range(max(1, args.reps))), key=lambda r: r["wall_s"])
        # the median rep stands for the mode; every rep's wall is its spread
        return {**runs[len(runs) // 2], "wall_s_reps": [round(r["wall_s"], 6) for r in runs]}

    per_product = median(lambda: run_per_product(cfg, outs, tiles, link, device))
    packed_sync = median(lambda: run_packed(cfg, outs, tiles, link, 1, device))
    packed_async = median(lambda: run_packed(cfg, outs, tiles, link, args.depth, device))
    raw_pp = median(lambda: run_per_product(cfg, outs, tiles, no_link, device))
    raw_pk = median(lambda: run_packed(cfg, outs, tiles, no_link, args.depth, device))

    n = len(tiles)
    stats = per_product["stats"]
    plan = fetchmod.build_plan(outs[0], cfg)

    def per_tile(r: dict) -> dict:
        return {"wall_s": round(r["wall_s"], 4), "ms_per_tile": round(r["wall_s"] / n * 1e3, 3),
                "wall_s_reps": r["wall_s_reps"]}

    result = {
        **record_meta("land_trendr_tpu_torch.tools.fetch_bench", argv, device.type),
        "workload": {
            "tile_px": px,
            "years": args.years,
            "nv": nv,
            "nm": nm,
            "tiles": n,
            "artifact_products": parity_products // min(3, n),
            "fetch_f16": args.f16,
            "bytes_per_tile_packed": packed_sync["wire_bytes"],
            "transfers_per_tile_per_product": stats["transfers"] // (stats["tiles"] or 1),
            "transfers_per_tile_packed": packed_sync["stats"]["transfers"] // n,
            "device_copies_per_tile_packed": len(plan.entries),
        },
        "platform": device.type,
        "link_model": {
            "latency_ms": link_ms,
            "gbps": link_gbps,
            "note": ("modeled: transfers land latency + bytes/bandwidth after issue (the "
                     "CPU has no device link); all host work is real")
            if link.enabled else "disabled: the card's real link",
        },
        "per_product_sync": per_tile(per_product),
        "packed_sync": per_tile(packed_sync),
        "packed_async": {**per_tile(packed_async), "depth": args.depth},
        "speedup_packed_sync": round(per_product["wall_s"] / packed_sync["wall_s"], 3),
        "speedup_packed_async": round(per_product["wall_s"] / packed_async["wall_s"], 3),
        "raw_local": {
            "per_product_ms_per_tile": round(raw_pp["wall_s"] / n * 1e3, 3),
            "packed_ms_per_tile": round(raw_pk["wall_s"] / n * 1e3, 3),
            "note": "no link model",
        },
        "parity": {"tiles_checked": min(3, n), "products_checked": parity_products, "ok": True},
        "smoke": bool(args.smoke),
    }
    write_json_atomic(args.out, result)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
