"""Pod flow at scale: a true two-process ``torch.distributed`` driver run
over a shared workdir, held pixel for pixel against one process.

Counterpart of the JAX package's ``tools/multihost_bench.py``.  Two
``gloo`` processes on localhost (the port's ``init_distributed``) each run
the port's ``run_stack`` over a SHARED workdir with a local mesh: every
local card, or ``[cuda:0, cuda:0]`` where there is one (two shards on one
card, so this measures the flow, not scaling; ``["cpu", "cpu"]`` with
``--device cpu``).  ``host_share`` splits the tiles between the
processes and the shared manifest gathers all of them.  This process then
assembles the rasters from the shared workdir and compares them with a
single-process, single-device run of the same scene: byte-equal rasters,
and every pixel counted once.

Usage::

    python -m land_trendr_tpu_torch.tools.multihost_bench [--size 512] [--tile 128]
        [--year-start 1990] [--year-end 2013] [--workroot .multihost_bench]
        [--device cuda|cpu] [--out MULTIHOST.json]

Each scene's run is an entry of the record, keyed by its size, years and
tile.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

from land_trendr_tpu_torch.tools.measure import (
    child_env,
    digest_files,
    disk_free,
    merge_record,
    record_meta,
    write_json_atomic,
)
from land_trendr_tpu_torch.tools.pod_launch import launch_pod

__all__ = ["main", "run", "worker"]

#: the JAX tool's parameters and scene seed
PARAMS = {"max_segments": 4, "vertex_count_overshoot": 2}
SEED = 11


def _scene(size: int, year_start: int, year_end: int):
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.runtime import stack_from_synthetic

    return stack_from_synthetic(make_stack(SceneSpec(
        width=size, height=size, year_start=year_start, year_end=year_end, seed=SEED)))


def _cfg(tile: int, workdir: str, out_dir: str):
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.runtime import RunConfig

    return RunConfig(params=LTParams(**PARAMS), tile_size=tile, workdir=workdir,
                     out_dir=out_dir)


def local_mesh(device: str) -> list:
    """Every local card, or the one card twice; two CPU shards on the CPU."""
    import torch

    if device == "cpu":
        return [torch.device("cpu")] * 2
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [torch.device("cuda", 0)] * 2)


def worker(argv: "list[str]") -> int:
    """One pod process: join the group, run its ``host_share`` of the
    scene over the shared workdir on its local mesh, write its summary
    (with its fused-kernel launch count)."""
    coordinator, world, rank, shared, out_path, size, tile, y0, y1, device = argv
    import torch.distributed as dist

    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.parallel import init_distributed
    from land_trendr_tpu_torch.runtime import run_stack

    init_distributed(coordinator, int(world), int(rank), timeout_s=300.0)
    stack = _scene(int(size), int(y0), int(y1))
    segment_cuda.LAUNCHES = 0
    summary = run_stack(stack, _cfg(int(tile), shared, shared + "_o"), device=device,
                        mesh=local_mesh(device))
    summary["launches"] = segment_cuda.LAUNCHES
    write_json_atomic(out_path, summary)
    dist.destroy_process_group()
    return 0


def run(size: int, tile: int, year_start: int, year_end: int, workroot: str,
        device: str) -> dict:
    """The pod, its assembly, the one-process reference and the
    comparison; the record (without :func:`record_meta`)."""
    from land_trendr_tpu_torch.io.geotiff import read_geotiff
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.runtime import assemble_outputs, run_stack

    # a fresh workroot every run: resumed tiles would zero the pod's pixel
    # counts and a stale manifest would poison the comparison
    shutil.rmtree(workroot, ignore_errors=True)
    os.makedirs(workroot)
    disk = disk_free(workroot)
    shared = os.path.join(workroot, "shared_work")
    summaries = [os.path.join(workroot, f"summary{i}.json") for i in range(2)]
    t0 = time.perf_counter()
    launch_pod(
        lambda coord, i: [sys.executable, "-m", "land_trendr_tpu_torch.tools.multihost_bench",
                          "--worker", coord, "2", str(i), shared, summaries[i], str(size),
                          str(tile), str(year_start), str(year_end), device],
        env=child_env(), timeout=3600.0,
        before_attempt=lambda: shutil.rmtree(shared, ignore_errors=True))
    pod_wall = time.perf_counter() - t0
    per_proc = []
    for p in summaries:
        with open(p) as f:
            per_proc.append(json.load(f))

    stack = _scene(size, year_start, year_end)
    pod_cfg = _cfg(tile, shared, os.path.join(workroot, "pod_out"))
    pod_paths = assemble_outputs(stack, pod_cfg, device=device)
    ref_cfg = _cfg(tile, os.path.join(workroot, "ref_work"), os.path.join(workroot, "ref_out"))
    before = segment_cuda.LAUNCHES
    t0 = time.perf_counter()
    ref = run_stack(stack, ref_cfg, device=device)
    ref_wall = time.perf_counter() - t0
    ref_launches = segment_cuda.LAUNCHES - before
    ref_paths = assemble_outputs(stack, ref_cfg, device=device)

    agreement = {}
    for name in ("model_valid", "n_vertices", "vertex_years", "rmse"):
        a, _, _ = read_geotiff(pod_paths[name])
        b, _, _ = read_geotiff(ref_paths[name])
        agreement[name] = round(float(np.mean(a == b)), 6)
    equal = digest_files(pod_cfg.out_dir) == digest_files(ref_cfg.out_dir)
    total_px = sum(s["pixels"] for s in per_proc)
    # checked before the record is written: a failed run leaves none
    if total_px != size * size:
        raise RuntimeError(f"the pod segmented {total_px} px, expected {size * size}")
    if not equal:
        raise RuntimeError(f"the pod's rasters differ from one process's: {agreement}")
    return {
        "description": (
            "True 2-process torch.distributed (gloo) DRIVER run: each process runs "
            "run_stack on its local mesh over a SHARED workdir; host_share splits tiles; "
            "assembly mosaics the union; rasters compared byte for byte with a "
            "single-process single-device run."
        ),
        "device": device,
        "mesh": [str(d) for d in local_mesh(device)],
        "scene": {"size": size, "years": year_end - year_start + 1, "tile": tile},
        "pod": {
            "wall_s": round(pod_wall, 3),
            "per_process": [
                {k: s[k] for k in ("pixels", "tiles_done", "tiles_skipped_resume",
                                   "mesh_devices", "px_per_s", "launches")}
                for s in per_proc
            ],
        },
        "reference": {"wall_s": round(ref_wall, 3), "px_per_s": ref["px_per_s"],
                      "launches": ref_launches},
        "raster_agreement_fraction": agreement,
        "rasters_byte_equal": equal,
        "disk_before": disk,
    }


def main(argv: "list[str] | None" = None) -> int:
    args_in = list(sys.argv[1:] if argv is None else argv)
    if args_in[:1] == ["--worker"]:
        return worker(args_in[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--year-start", type=int, default=1990)
    ap.add_argument("--year-end", type=int, default=2013)
    ap.add_argument("--workroot", default=".multihost_bench")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--out", default="MULTIHOST.json")
    args = ap.parse_args(args_in)
    if args.size <= 0 or args.tile <= 0:
        ap.error("--size and --tile must be positive")
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    rec = run(args.size, args.tile, args.year_start, args.year_end, args.workroot, dev.type)
    rec.update(record_meta("land_trendr_tpu_torch.tools.multihost_bench", argv, dev.type))
    years = args.year_end - args.year_start + 1
    merge_record(args.out, f"pod_{args.size}x{args.size}x{years}_tile{args.tile}", rec)
    print(json.dumps(rec, indent=2))
    shutil.rmtree(args.workroot, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
