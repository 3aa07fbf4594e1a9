"""GIGA: one composed end-to-end run at mosaic scale on the card, with a
hard kill and a resume in the middle.

Counterpart of the JAX package's ``tools/giga_run.py`` (the same scene,
bytes for bytes, the same parameters and run configuration; the one
difference is the device, the card instead of the JAX package's XLA):

    synthetic C2-named scene on disk (deflate, tiled; NIR, SWIR2, QA)
      → lazy windowed ingest (``open_stack_dir_c2_lazy``: no input cube
        in host memory)
      → ``run_stack`` into the fingerprinted tile manifest, SIGKILLed
        once ``--kill-tiles`` tiles are durable, then resumed
      → streamed raster assembly (BigTIFF where a product needs it)
      → the on-device change products + the streamed mmu sieve

Each phase runs as a child process that reports its own peak RSS
(``tools/measure.py:peak_rss_mib``) beside its resident set once its
imports are done (``rss_at_start_mib``: torch's libraries), so every
peak RSS is that phase's alone.  The kill is on evidence, not on
a clock: the parent polls the manifest and kills the child once the
tiles are durable, asserts the child died of SIGKILL, and asserts that
the resume skipped at least those tiles and fewer than all of them.
Then an unkilled run of the same scene into a second workdir (``ref``:
segment, assemble and sieve in one child) must give byte-equal rasters.

Usage::

    python -m land_trendr_tpu_torch.tools.giga_run all [--size 4096]
        [--out-root .giga_run] [--kill-tiles 2] [--device cuda|cpu]
        [--out GIGA.json]   (each size's run is an entry of the record)
    python -m land_trendr_tpu_torch.tools.giga_run gen|segment|assemble|sieve|ref ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from land_trendr_tpu_torch.tools.measure import (
    child_env,
    digest_files,
    disk_free,
    peak_rss_mib,
    merge_record,
    record_meta,
    rss_mib,
    watch_rss,
)

__all__ = ["cmd_gen", "main", "run_all"]

NY = 12
YEAR0 = 1990
TILE = 1024
PRODUCTS = ("n_vertices", "vertex_years", "seg_magnitude", "rmse", "model_valid")
SIEVE_MMU = 11
#: how often the parent reads the manifest while it waits to kill (s)
POLL_S = 0.005


def _params():
    from land_trendr_tpu_torch.config import LTParams

    return LTParams(max_segments=2, vertex_count_overshoot=0, spike_threshold=1.0)


def _cfg(root: Path, tile: int, tag: str = ""):
    from land_trendr_tpu_torch.ops.change import ChangeFilter
    from land_trendr_tpu_torch.runtime.driver import RunConfig

    return RunConfig(
        index="nbr",
        params=_params(),
        tile_size=tile,
        workdir=str(root / f"work{tag}"),
        out_dir=str(root / f"out{tag}"),
        products=PRODUCTS,
        change_filt=ChangeFilter(min_mag=0.1),
        manifest_compress="deflate",
        out_compress="deflate",
        chunk_px=262_144,
    )


def _scene_dir(root: Path) -> Path:
    return root / "scene"


def _c2_name(year: int, prod: str) -> str:
    return f"LT05_L2SP_045030_{year}0715_{year}0912_02_T1_{prod}.TIF"


def cmd_gen(size: int, root: Path) -> dict:
    """Write the synthetic scene: NIR (SR_B4), SWIR2 (SR_B7) and QA_PIXEL a
    year, deflate tiled, written in row bands (bounded RSS); the JAX
    tool's draws, so its bytes."""
    from land_trendr_tpu_torch.io.geotiff import GeoMeta, GeoTiffStreamWriter

    scene = _scene_dir(root)
    scene.mkdir(parents=True, exist_ok=True)
    geo = GeoMeta(
        pixel_scale=(30.0, 30.0, 0.0),
        tiepoint=(0.0, 0.0, 0.0, 553785.0, 5189625.0, 0.0),
        nodata=0.0,
    )
    t0 = time.time()
    band_rows = 2048
    # disturbance patches: a 128-px cell grid, ~30% of cells disturbed,
    # each at its own year
    cell = 128
    ncell = size // cell
    rng = np.random.default_rng(20260731)
    cell_dist = rng.random((ncell, ncell)) < 0.3
    cell_year = rng.integers(2, NY - 2, (ncell, ncell))

    writers = {}
    for k in range(NY):
        for prod in ("SR_B4", "SR_B7", "QA_PIXEL"):
            writers[(k, prod)] = GeoTiffStreamWriter(
                str(scene / _c2_name(YEAR0 + k, prod)), size, size, 1, np.uint16,
                geo=geo, compress="deflate", tile=512, compress_level=1,
            )
    for r0 in range(0, size, band_rows):
        h = min(band_rows, size - r0)
        crows = slice(r0 // cell, (r0 + h + cell - 1) // cell)
        # both fields take the same intra-cell row offset
        dist = np.kron(cell_dist[crows], np.ones((cell, cell), bool))[r0 % cell:, :][:h, :size]
        dyear = np.kron(cell_year[crows], np.ones((cell, cell), np.int64))[r0 % cell:, :][:h, :size]
        brng = np.random.default_rng(r0)
        # noise in 32-DN steps: far below the disturbance signal, and
        # structure that deflate finds
        q = 32 * 2.75e-5
        noise = np.round(brng.normal(0.0, 0.004, (h, size)) / q) * q
        for k in range(NY):
            disturbed = dist & (dyear <= k)
            nir = np.where(disturbed, 0.18, 0.45) + noise
            swir2 = np.where(disturbed, 0.25, 0.08) - noise
            qa = np.full((h, size), 1 << 6, np.uint16)
            if k % 5 == 2:  # a cloud band sweeping rows a year
                lo = (r0 // 7) % max(1, h - 32)
                qa[lo:lo + 32] |= 1 << 3
            writers[(k, "SR_B4")].write(r0, 0, ((nir + 0.2) / 2.75e-5).astype(np.uint16)[..., None])
            writers[(k, "SR_B7")].write(r0, 0, ((swir2 + 0.2) / 2.75e-5).astype(np.uint16)[..., None])
            writers[(k, "QA_PIXEL")].write(r0, 0, qa[..., None])
        print(f"gen rows {r0 + h}/{size} at {time.time() - t0:.0f}s", file=sys.stderr, flush=True)
    for wtr in writers.values():
        wtr.close()
    return {
        "px": size * size, "ny": NY, "files": len(writers),
        "scene_bytes": sum(f.stat().st_size for f in scene.iterdir()),
        "wall_s": round(time.time() - t0, 3),
    }


def _open_scene(root: Path):
    from land_trendr_tpu_torch.runtime.stack import open_stack_dir_c2_lazy

    return open_stack_dir_c2_lazy(str(_scene_dir(root)), bands=("nir", "swir2"))


def cmd_segment(root: Path, tile: int, device: str, tag: str = "") -> dict:
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.runtime.driver import run_stack

    before = segment_cuda.LAUNCHES
    res = run_stack(_open_scene(root), _cfg(root, tile, tag), device=device)
    res["launches"] = segment_cuda.LAUNCHES - before
    return res


def cmd_assemble(root: Path, tile: int, device: str, tag: str = "") -> dict:
    from land_trendr_tpu_torch.runtime.driver import assemble_outputs

    t0 = time.time()
    paths = assemble_outputs(_open_scene(root), _cfg(root, tile, tag), device=device)
    return {
        "products": sorted(paths),
        "out_bytes": sum(Path(p).stat().st_size for p in paths.values()),
        "wall_s": round(time.time() - t0, 3),
    }


def cmd_sieve(root: Path, tag: str = "") -> dict:
    from land_trendr_tpu_torch.ops.change import sieve_change_rasters

    t0 = time.time()
    sieve_change_rasters(str(root / f"out{tag}"), mmu=SIEVE_MMU)
    return {"mmu": SIEVE_MMU, "wall_s": round(time.time() - t0, 3)}


def cmd_ref(root: Path, tile: int, device: str) -> dict:
    """The unkilled reference: segment, assemble and sieve into ``work_ref``
    and ``out_ref``, in one process."""
    t0 = time.time()
    seg = cmd_segment(root, tile, device, "_ref")
    asm = cmd_assemble(root, tile, device, "_ref")
    cmd_sieve(root, "_ref")
    return {"tiles_done": seg["tiles_done"], "launches": seg["launches"],
            "segment_wall_s": seg["wall_s"], "assemble_wall_s": asm["wall_s"],
            "wall_s": round(time.time() - t0, 3)}


def _child(phase: str, args) -> "list[str]":
    return [sys.executable, "-m", "land_trendr_tpu_torch.tools.giga_run", phase,
            "--size", str(args.size), "--tile", str(args.tile),
            "--out-root", str(args.out_root), "--device", args.device]


def _run_phase(phase: str, args, timeout: float = 7200.0) -> dict:
    """One phase as a child process; its JSON line (with its own peak RSS)
    plus the parent's wall seconds around it."""
    t0 = time.time()
    r = subprocess.run(_child(phase, args), capture_output=True, text=True, timeout=timeout,
                       env=child_env())
    if r.returncode != 0:
        raise RuntimeError(f"phase {phase} rc={r.returncode}\n{r.stderr[-3000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    rec["wall_s_total"] = round(time.time() - t0, 3)
    return rec


def durable_tiles(manifest: Path) -> int:
    """Distinct tiles with a done record in the manifest (a torn tail line
    is not counted)."""
    try:
        text = manifest.read_text()
    except FileNotFoundError:
        return 0
    done = set()
    for line in text.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("kind") == "tile":
            done.add(rec.get("tile_id"))
    return len(done)


def _run_killed(args, timeout: float = 7200.0) -> dict:
    """``segment`` as a child, SIGKILLed as soon as ``args.kill_tiles``
    tiles are durable in its manifest."""
    manifest = Path(args.out_root) / "work" / "manifest.jsonl"
    err_path = Path(args.out_root) / "segment_killed.stderr"
    t0 = time.time()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(_child("segment", args), stdout=subprocess.DEVNULL, stderr=err,
                                env=child_env())
        try:
            while proc.poll() is None:
                seen = durable_tiles(manifest)
                if seen >= args.kill_tiles:
                    proc.send_signal(signal.SIGKILL)  # a crash, not a polite stop
                    break
                if time.time() - t0 > timeout:
                    raise RuntimeError(f"segment did not make {args.kill_tiles} tiles durable "
                                       f"in {timeout:.0f}s")
                time.sleep(POLL_S)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    rec = {"kill_tiles": args.kill_tiles, "durable_seen": durable_tiles(manifest),
           "rc": proc.returncode, "wall_s": round(time.time() - t0, 3)}
    if proc.returncode != -signal.SIGKILL:
        raise RuntimeError(f"the killed segment child ended with rc {proc.returncode}, not "
                           f"-SIGKILL (it finished before {args.kill_tiles} tiles were seen "
                           f"durable?): {err_path.read_text()[-2000:]}")
    return rec


def run_all(args) -> dict:
    """Every phase in order (the module docstring); the record."""
    root = Path(args.out_root)
    root.mkdir(parents=True, exist_ok=True)
    n_tiles = math.ceil(args.size / args.tile) ** 2
    result = {
        "px": args.size * args.size,
        "ny": NY,
        "tile": args.tile,
        "tiles": n_tiles,
        "products": list(PRODUCTS),
        "params": {"max_segments": 2, "vertex_count_overshoot": 0, "spike_threshold": 1.0},
        "host_cores": os.cpu_count(),
        "disk_before": disk_free(str(root)),
    }
    result["gen"] = _run_phase("gen", args)
    # a crash mid-segmentation, then a resume: the manifest is the checkpoint
    result["segment_killed"] = _run_killed(args)
    resumed = result["segment_resumed"] = _run_phase("segment", args)
    skipped = resumed["tiles_skipped_resume"]
    if not args.kill_tiles <= skipped < n_tiles:
        raise RuntimeError(f"the resume skipped {skipped} tiles: expected at least "
                           f"{args.kill_tiles} (durable before the kill) and fewer than "
                           f"all {n_tiles}")
    result["assemble"] = _run_phase("assemble", args)
    result["sieve"] = _run_phase("sieve", args)
    result["reference"] = _run_phase("ref", args)
    killed, ref = digest_files(str(root / "out")), digest_files(str(root / "out_ref"))
    result["rasters"] = len(killed)
    result["rasters_equal_unkilled"] = killed == ref
    if killed != ref:
        raise RuntimeError("the killed-and-resumed rasters differ from the unkilled run's: "
                           f"{sorted(k for k in killed if killed[k] != ref.get(k))}")
    phases = ("gen", "segment_resumed", "assemble", "sieve")
    result["wall_s_total"] = round(
        sum(result[p]["wall_s_total"] for p in phases) + result["segment_killed"]["wall_s"], 3)
    result["peak_rss_mib_max"] = max(result[p]["peak_rss_mib"] for p in phases)
    result["disk_after"] = disk_free(str(root))
    result.update(record_meta("land_trendr_tpu_torch.tools.giga_run", args.argv,
                              "cuda" if args.device.startswith("cuda") else args.device))
    return result


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=["all", "gen", "segment", "assemble", "sieve", "ref"])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--tile", type=int, default=TILE, help=argparse.SUPPRESS)
    ap.add_argument("--out-root", default=".giga_run")
    ap.add_argument("--kill-tiles", type=int, default=2,
                    help="durable tiles in the manifest before the SIGKILL")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--out", default="GIGA.json", help="the record (phase all)")
    args = ap.parse_args(argv)
    args.argv = argv
    watch_rss()
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    rss_at_start = rss_mib()  # the imports' share, torch's libraries among them

    try:
        dev = str(resolve_device(args.device))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    root = Path(args.out_root)
    if args.phase == "all":
        rec = run_all(args)
        merge_record(args.out, f"giga_{args.size}x{args.size}", rec)
        print(json.dumps(rec, indent=1))
        return 0
    rec = {
        "gen": lambda: cmd_gen(args.size, root),
        "segment": lambda: cmd_segment(root, args.tile, dev),
        "assemble": lambda: cmd_assemble(root, args.tile, dev),
        "sieve": lambda: cmd_sieve(root),
        "ref": lambda: cmd_ref(root, args.tile, dev),
    }[args.phase]()
    rec["peak_rss_mib"] = peak_rss_mib()
    rec["rss_at_start_mib"] = rss_at_start
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
