"""Chip smoke for the PyTorch/CUDA port: the `segment` path, the stage
probe, the `serve` path, the serving fleet (`route`, `load`) and the
port's tools on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result,
without them (or when run outside a checkout of the repository).  Phases,
each of which fails the script on its own:

1. **Build** the host raster codec (``native/lt_native.cc``, g++, used
   by the loaders, the feed and the writers when present; the smoke goes
   on without it if it cannot be built) and the kernels
   (``csrc/segment_fused.cu``: the fused segmentation kernel and the
   family kernel, narrow, wide and global) from the checkout's source
   with nvcc;
   print the build seconds, the ptxas register/stack/spill report, each
   kernel's occupancy (blocks and warps per SM) and shared bytes per
   block, and the card's name and power limit.
2. **Kernel against plain version** on 262,144 px x 40 years of a seeded
   mixed-regime population, default parameters: float32 decisions agree
   on >= 99.9% of pixels and floats within 1e-5 on the agreeing pixels;
   float64 decisions are identical on every pixel and floats within 1e-8.
   On the agreeing pixels a NaN or infinity in either output must stand
   at the same place in the other.  Prints each fused-kernel stage's
   share of the per-thread cycles and the block-size sweep, then times
   the kernel and the plain PyTorch version with CUDA events after a
   warm-up, and computes the kernel's roofline bound from this run's
   inputs.
2c. **The wide kernels** (the instantiation for more than 64 years or 16
   candidates) against their plain versions at 262,144 px: 72 years at
   default params, and 40 years at 18 candidates (``max_segments=14,
   vertex_count_overshoot=3``); float32 decisions >= 99.9% with floats
   within 1e-5, float64 decisions exact; the wide family kernel at 72
   years likewise.  CUDA-event times, op counts and bounds, with phase 2's
   narrow time beside them.
2d. **The global forms** (any NY and candidate count; the series in
   shared memory at a block picked from NY, or in a device-memory scratch
   where no block holds it) against their plain versions at 65,536 px:
   160 years at default params, and 40 years at 40 candidates
   (``max_segments=36, vertex_count_overshoot=3``); float32 bit-identical
   on every pixel, float64 decisions exact; the scratch tier at 1,000
   years (1,024 px) likewise; then the global form forced at 40 years
   with default params equals the narrow kernel bit for bit.  CUDA-event
   times (the plain version's after its checked call), op counts, scratch
   bytes and bounds by the function's own inputs and outputs, with the
   bound that also counts the scratch (written once, read once) beside
   it; each case's plan, stage
   shares (the narrow kernel's of phase 2 beside them) and block-size
   sweep, and every instantiation's registers, local bytes and spills.
   ``python3 chip_smoke.py --phase-2d`` runs the build and this phase
   alone.  Phase 2 also holds the narrow kernel within 5% of its 1.3179 ms
   on a card at 700 W.
3. **Chunked against unchunked**: chunk 65,536 gives identical decisions.
3b. **Family kernel against its plain version** on phase 2's population:
   vertex sets equal on every pixel in float64 and on >= 99.9% in
   float32, the despiked series and SSEs within 1e-8 / 1e-5 on the
   agreeing pixels (same NaN/infinity rule); the family kernel followed
   by the plain tail on the card makes the fused kernel's decisions on
   every pixel in float64 and >= 99.9% in float32.  Times the kernel and
   its plain version and computes its bound.
4. **Scene**: a 2048 x 2048 x 40-year synthetic stack through the port's
   ``run_stack`` + ``assemble_outputs`` at tile_size 512 (16 tiles of
   262,144 px); the kernel's launch count must be one per tile, the
   manifest must record impl "cuda", and fit_rate must lie in (0, 1].
   Two more runs into fresh workdirs give the spread of px/s; the host's
   core count and whether the native gather library loaded are printed.
4b. **FTV + change scene**: phase 4's stack again, with
   ``ftv_indices=("ndvi", "tcw")`` and ``ChangeFilter(max_dur=4)``: one
   fused launch per tile, impl "cuda", the FTV and the seven change
   rasters assembled, fit_rate in (0, 1]; px/s and stage_s printed.
5. **CLI**: ``synth``, ``segment`` on the default device (through
   ``tools/run_segment_measured``, which prints its peak RSS), then a second
   ``segment`` that resumes every tile; beside them ``segment --ftv ndvi
   --change --change-mmu 4`` and then ``change OUT --mmu 4`` (checks, none
   timed, in their own workdirs).
6. **Stage probe** (``tools/probe.py stages``) at 262,144 px: the fused
   kernel, the family kernel, family + plain tail and the plain version,
   timed with CUDA events; its JSON line is printed; then the same probe
   at 72 years and 65,536 px, and at 160 years and 65,536 px.  These are
   the family kernel's paths (narrow, wide, then global): their launch
   counts are read around each.
7. **Robustness on the card**, a 512 x 512 x 40 stack at tile 128 (16
   tiles), each run with its own launch count: (a) a fault schedule that
   hits ``feed``, ``dispatch``, ``compute.wait``, ``fetch.wait`` and
   ``manifest.record`` once each (``max_retries=2``, no backoff): the
   record fault is the last tile's, so the run aborts with every other
   tile durable and a clean resume completes it; the assembled rasters are
   byte-equal to a clean run's, and the fused launches equal 16 plus the
   re-dispatches (one per injected ``compute.wait``/``fetch.wait``) plus
   the resumed tile; (b) ``dispatch`` failing three times on one tile with
   ``quarantine_tiles``: exactly that tile is quarantined and the run
   completes; (c) ``stall_timeout_s=2`` with ~6 s of ``torch.cuda._sleep``
   enqueued before one tile's event: ``StallError`` within 4 s and the
   process lives on; (d) a cancel after the third durable tile:
   ``RunCancelled``, and a rerun resumes the rest.
8. **Composite, telemetry and trace**: (a) a 512 x 512 Collection-2
   archive with 2–3 acquisitions a year loaded with ``composite="medoid"``
   on the card is byte-equal to the same load on the CPU (the card's
   composite seconds printed), then segmented; (b) phase 4's scene with
   ``telemetry=True, flight=True``: one ``tile_done`` per tile,
   ``flight.jsonl`` written, the HBM peak gauge read from ``metrics.prom``;
   the compute-wait poll against a blocking ``synchronize()`` wait,
   alternating, px/s of each; one run under ``utils/profiling.trace``,
   whose kernel intervals give the device's busy share of the wall;
   (c) the CLI over phase 5's stack: ``segment --trace --out-overviews 2``
   (the trace names ``segment_fused_kernel``) and ``info`` on an output
   raster (two overview pages), with ``pixel --from-stack --engine both``
   at two pixels beside them (oracle and kernel agree on vertex years).
9. **Elastic, pod, mesh and tuning**: (a) phase 4's scene with
   ``lease_batch=2`` (16 tiles leased, 16 launches), then again with a
   dead peer holding four leases that the ``lease.expire`` seam makes
   stealable (4 stolen, 16 launches); (c) ``segment_pixels_sharded`` over
   ``make_mesh()`` and ``[cuda:0, cuda:0]`` bit-identical to the unsharded
   kernel on phase 2's population, then phase 4's scene over the two-shard
   mesh (32 launches); the three scene runs' rasters byte-equal to phase
   4's; (b) phase 7's stack written to disk: a two-process pod under
   ``init_distributed`` on localhost (this script re-run with
   ``--pod-worker``; 8 + 8 tiles, the primary's ``hosts`` fold both
   ``ok``) and two ``segment --lease-batch 2`` processes with no process
   group (their won tiles sum to 16), both byte-equal to one process;
   (d) ``tune --smoke`` probes and stores a profile, a second call reloads
   it with zero probes, and ``segment`` with ``auto`` tile size, chunk and
   fetch depth names the profile and equals a run with those values given.
   Seconds and px/s of each leg are printed with the card's name and power
   limit.
10. **Serve**: a 1024 x 1024 x 40 stack written to disk, tile 512 (4 tiles
   of 262,144 px per job). An in-process ``SegmentationServer`` (so the
   launch counts are readable): (a) with ``batch=False`` two identical
   jobs, the second submitted once the first runs: rasters byte-equal to
   ``segment`` of the same stack, the first cold (5 launches: its warm-up
   tile + 4), the second warm (4); (c) then a job at 18 candidates that
   runs the wide instantiation (5 wide launches, cold), byte-equal to
   ``segment`` with those params, and behind it (b) with batching on a
   flood of 4 same-affinity jobs: one batch of 4 with one leader launch set
   (4 launches), the members demuxed with 0 tiles of their own, all byte-
   equal, the wide job in no batch. A ``serve --serve-port 0 --publish``
   subprocess (with a slow ``dispatch`` fault so a job takes seconds),
   driven over HTTP: (e) after one idle capture (the first capture in a
   process pays the profiler's start-up), ``POST /debug/profile`` while a
   job runs writes a trace naming ``segment_fused_kernel``, ``/healthz`` shows
   ``warm_program_count`` and ``/metrics`` ``lt_serve_warm_hit_ratio``;
   (d) a job cancelled mid-run leaves a resumable manifest and its
   resubmission finishes byte-equal; (f) the server's snapshot and a
   ``segment --publish`` of the same stack into the same telemetry
   directory fold into 2 hosts, both ok; (g) in process, a job at 40
   candidates runs the global form (5 global launches, cold), byte-equal
   to ``segment`` with those params. Job latencies, the flood's jobs/s and
   launches per job are printed.
11. **Route and load** over phase 10's stack: ``route`` spawns two
   ``serve`` replicas on the card; ``load`` drives a seeded closed-loop
   trace of 8 jobs from 2 tenants (the two request shapes of
   ``loadgen``): every job ends done, byte-equal to ``segment`` of the same
   request, and the replicas' launch counts (``GET /debug/kernels``) are 4
   tiles per job plus 1 cold launch per replica and request shape; (b) one
   request is assembled by ``obs/reqtrace`` across the router and its
   replica; (c) the replica running a job of 64 tiles is SIGKILLed after
   its first durable tile: the job is re-routed and ends byte-equal; (d)
   the router is SIGKILLed with two jobs routed and restarted on its
   workdir: the journal replays, both jobs end done and byte-equal, and
   their resubmissions are deduped.  Jobs/s, the p50 job latency and the
   slowest of the 8 jobs (8 samples hold no p99) are printed with the
   card's name and power limit.

12. **The port's tools on the card** (``land_trendr_tpu_torch/tools/``),
   after phase 11: (a) ``parity_f32`` at 1,048,576 px x 40 years, the
   float32 kernel against its float64 instantiation: exact vertex
   agreement >= 99.9%, the taxonomy printed beside the JAX package's CPU
   record on the same pixels (``PARITY_f32.json``); (b) ``impl_identity``,
   kernel against plain version, at 1,048,576 px (narrow), 262,144 px at
   NY = 72 (wide) and 65,536 px at NY = 160 (global): every decision field
   equal on every pixel; (c) ``fault_soak --smoke`` (eager track on a
   512² x 40 stack at tile 128): ok, all 27 registered seams armed and
   fired, every case byte-equal; (d) ``elastic_soak --smoke``; (e)
   ``capacity_bench --smoke`` and ``fleet_bench --smoke`` with their
   invariants; (f) ``lt_request --slowest`` over
   phase 11's router: the blame sums to the latency.  (a) and (b) run in
   this process, beside (c), which checks bytes and seams only; the rest
   run one after another as the tools' own processes; each leg's seconds
   are printed.

13. **The oracle, the FTV rasters and the perf gate**, after phase
   12: (a) ``parity_paramspace``: 32 trials x 64 px of the JAX tool's
   joint parameter draw (seed base 2000) — the float64 kernel exact
   against the port's oracle on every pixel, each trial's batch through
   every admitting form (narrow, wide, global) bit-identical to narrow in
   f32 and f64, and the f32 kernel bit-identical to the plain version;
   (b) ``validate_ftv`` over phase 4b's NDVI and TCW FTV rasters, 64
   sampled pixels re-derived from the DNs through the float64 oracle,
   within the JAX tool's 1e-3; (c) ``perf_gate --device cuda`` with every
   leg: its scheduler, router and capacity legs check phase 12 (d)/(e)'s
   reports (no bench runs twice) and its bands derive from the card's
   records under ``land_trendr_tpu_torch/tools/records/``.  Every check's
   name, verdict and detail are printed.

14. **The scale tools at smoke size**, each in its own process (so each
   peak RSS is that process's): (a) ``giga_run all`` at
   2048² x 12 years (4 tiles of 1024): the ``segment`` child SIGKILLed once
   its first tile is durable (rc -9), the resume skips 1-3 tiles, and the
   assembled rasters and sieved change maps are byte-equal to an unkilled
   run's; each phase's seconds and peak RSS printed; (b)
   ``change_stream_bench`` at 2048², mmu 9; (c) ``stream_assembly_bench
   scene`` over phase 4b's workdir, its rasters byte-equal to phase 4b's;
   (d) ``arch_speedup``: the oracle on 256 px, the plain version on 4,096
   px on the host, the kernel on 262,144 px.  (b) and (c) ((c) works on
   the host only) run side by side, beside phase 12 (a)-(c), which check
   bytes and seams only, and end before phase 12 (d); (a) and then (d)
   run after phase 13: no two timed runs share the card.  A tool killed
   at its time limit is killed with its whole process group.  Their
   launches join the ``kernels`` line's ``launches_by_path.tools``.

Phases 4 and 4b also assert that nothing was retried or quarantined and
print the run's HBM peak (the value the telemetry gauge holds).  Each
kernel's launch count is set to 0 just before its path (phases 4 and 10
for the narrow fused kernel, phase 10 (c) for the wide one and (g) for
the global one, phase 6 for the three family kernels; phases 7 and 8
count their own runs; phase 11's are the fresh replicas' own counts;
phase 12's are this process's for (a) and (b) and the tools' reports for
the rest; phase 13's are this process's for (a) and the gate's own; phase
14's the tools' reports) and read just after.  Every log line starts with
the seconds since the smoke started.
The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON object describing each kernel, and the result line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
NY = 40
POP_PX = 262_144
CHUNK = 65_536
SCENE = 2048
TILE = 512
F32_FLOOR = 0.999
F32_ATOL = 1e-5
#: float64 outputs on agreeing pixels: the parity tests' float tolerance
F64_ATOL = 1e-8
#: extra timed scene runs after the counted one, for the spread of px/s
SCENE_REPEATS = 2
#: secondary indices of the FTV + change scene (TCW needs all six bands)
FTV = ("ndvi", "tcw")
#: calls per variant the stage probe times
PROBE_REPS = 5
#: robustness scene (phase 7): 512 x 512 x 40 at tile 128
ROBUST = 512
ROBUST_TILE = 128
#: cycles of the device spin behind the stall (phase 7c): ~6 s at H100 clocks
STALL_CYCLES = int(1.2e10)
#: serve scene (phase 10): 1024 x 1024 x 40 at tile 512, four tiles a job
SERVE = 1024
SERVE_TILE = 512
#: the flood of same-affinity jobs (phase 10b)
FLOOD = 4
#: candidates beyond the narrow kernel (phases 2c and 10c): 18
WIDE_PARAMS = {"max_segments": 14, "vertex_count_overshoot": 3}
#: candidates beyond the wide kernel (phases 2d and 10g): 40, the global form
GLOBAL_PARAMS = {"max_segments": 36, "vertex_count_overshoot": 3}
#: pixels of phase 2d's populations
GLOBAL_PX = 65_536
#: the narrow fused kernel's time before the fit frame was centred
#: (262,144 px x 40 years f32; NVIDIA H100 80GB HBM3 at 700 W): phase 2
#: holds the kernel within 5% of it on a card at that power limit
NARROW_REF_MS = 1.3179
#: phase 11: jobs of the seeded closed-loop trace, and the tile of the
#: job whose replica is killed (small tiles: many of them, so the kill
#: lands mid-job)
ROUTE_JOBS = 8
KILL_TILE = 128
#: phase 13 (a): trials of the joint parameter draw (64 px each)
PARAMSPACE_TRIALS = 32
#: phase 8 (b): alternating pairs of scene runs, compute-wait poll against a
#: blocking synchronize
WAIT_REPS = 1
#: phase 12 (e): the capacity smoke's cells (replica counts x offered QPS)
CAPACITY_SMOKE = ("--replica-counts", "2", "--qps-steps", "0.5,2")
#: phase 14: the composed scale run's edge (4 tiles of 1024 at 12 years) and
#: the change bench's; arch_speedup's oracle and host plain-version pixels
GIGA_SIZE = 2048
ARCH_ORACLE_PX = 256
ARCH_PLAIN_PX = 4_096
#: NVIDIA H100 SXM published peaks (dense): HBM3 bytes/s, FP32 (non-tensor) op/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12


#: the smoke's start: every log line carries the seconds since it
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def population(rng: np.random.Generator, px: int, ny: int = NY):
    """Seeded mixed-regime series: disturbance + recovery, steps, trends,
    random walks and flat noise, ~8% of observations masked."""
    years = np.arange(1984, 1984 + ny, dtype=np.int32)
    t = np.arange(ny, dtype=np.float64)[None, :]
    kind = rng.integers(0, 5, size=(px, 1))
    base = rng.uniform(0.45, 0.75, size=(px, 1))
    d_year = rng.integers(4, ny - 4, size=(px, 1))
    mag = rng.uniform(0.1, 0.5, size=(px, 1))
    rec = rng.uniform(0.02, 0.15, size=(px, 1))
    dt = np.maximum(t - d_year, 0.0)
    disturbance = np.where(t >= d_year, mag * np.exp(-rec * dt), 0.0)
    step = np.where(t >= d_year, mag, 0.0)
    trend = rng.uniform(-0.01, 0.01, size=(px, 1)) * t
    walk = np.cumsum(rng.normal(0, 0.03, size=(px, ny)), axis=1)
    traj = base - np.where(
        kind == 0, disturbance,
        np.where(kind == 1, step, np.where(kind == 2, trend, np.where(kind == 3, walk * 0.2, 0.0))),
    )
    traj += rng.normal(0.0, 0.012, size=(px, ny))
    mask = rng.uniform(size=(px, ny)) > 0.08
    return years, -traj, mask


def decisions(a, b) -> torch.Tensor:
    return (
        (a.model_valid == b.model_valid)
        & (a.n_vertices == b.n_vertices)
        & (a.vertex_indices == b.vertex_indices).all(dim=1)
    )


def max_float_err(a, b, agree: torch.Tensor) -> float:
    """Largest |a - b| over every float field on the agreeing pixels.

    A NaN or an infinity in one output must stand at the same place (and,
    for an infinity, with the same sign) in the other; the difference is
    then taken over the finite pairs."""
    return max_pair_err(((n, getattr(a, n), getattr(b, n)) for n in a._fields), agree)


def max_pair_err(pairs, agree: torch.Tensor) -> float:
    """:func:`max_float_err` over ``(name, a, b)`` tensor pairs."""
    err = 0.0
    for name, x, y in pairs:
        x, y = x[agree], y[agree]
        if not x.dtype.is_floating_point:
            continue
        assert torch.equal(x.isnan(), y.isnan()), f"{name}: NaN pattern differs"
        inf = x.isinf()
        assert torch.equal(inf, y.isinf()), f"{name}: infinity pattern differs"
        assert torch.equal(x[inf], y[inf]), f"{name}: infinity signs differ"
        fin = x.isfinite()
        if bool(fin.any()):
            err = max(err, float((x[fin].double() - y[fin].double()).abs().max()))
    return err


def bit_identical(a, b, agree: torch.Tensor) -> bool:
    """Every field equal bit for bit on the agreeing pixels (NaN == NaN)."""
    return all(
        torch.equal(x[agree].view(torch.uint8), y[agree].view(torch.uint8))
        for x, y in zip(a, b)
    )


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events, after
    one warm-up call (``warm=False``: the caller has just made it)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def checked_and_timed(fn) -> tuple:
    """``(fn(), ms)``: the first call's result, which is checked and serves
    as the warm-up, and the milliseconds of one more call, CUDA events
    around it."""
    out = fn()
    return out, cuda_ms(fn, reps=1, warm=False)


def write_multidate_c2(out_dir: str, synth, rng: np.random.Generator) -> int:
    """A Collection-2 per-band archive (NIR, SWIR2, QA_PIXEL) with two or
    three acquisitions a year: each is the synthetic year plus its own DN
    noise and clouds.  Returns the number of acquisitions."""
    from land_trendr_tpu_torch.io.geotiff import GeoMeta, write_geotiff

    os.makedirs(out_dir)
    geo = GeoMeta(pixel_scale=(30.0, 30.0, 0.0),
                  tiepoint=(0.0, 0.0, 0.0, 500000.0, 5000000.0, 0.0))
    h, w = synth.qa.shape[1:]
    n = 0
    for i, year in enumerate(synth.years.tolist()):
        for mmdd in ("0610", "0712", "0830")[: 2 + i % 2]:
            stem = f"LT05_L2SP_045030_{year}{mmdd}_{year}{mmdd}_02_T1"
            for band, num in (("nir", 4), ("swir2", 7)):
                dn = synth.dn_year(band, i).astype(np.int32) + rng.integers(-150, 150, (h, w))
                write_geotiff(os.path.join(out_dir, f"{stem}_SR_B{num}.TIF"),
                              np.clip(dn, -32768, 32767).astype(np.int16), geo=geo)
            clouds = np.where(rng.uniform(size=(h, w)) < 0.15, 1 << 3, 0).astype(np.uint16)
            write_geotiff(os.path.join(out_dir, f"{stem}_QA_PIXEL.TIF"),
                          synth.qa[i] | clouds, geo=geo)
            n += 1
    return n


def raster_bytes(out_dir: str) -> dict:
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def raster_digests(out_dir: str) -> dict:
    """SHA-256 of every raster in ``out_dir`` (byte equality of large scenes
    without holding their bytes)."""
    return {name: hashlib.sha256(data).hexdigest() for name, data in raster_bytes(out_dir).items()}


def pod_worker(argv: list) -> int:
    """One process of phase 9's pod: join the process group, run its
    ``host_share`` of the 512² stack on the card over the shared workdir,
    write its summary (with its fused-kernel launch count) as JSON."""
    coordinator, world, rank, stack_dir, workdir, out_path = argv
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.ops.indices import required_bands
    from land_trendr_tpu_torch.parallel import init_distributed
    from land_trendr_tpu_torch.runtime.driver import RunConfig, run_stack
    from land_trendr_tpu_torch.runtime.stack import load_stack_dir

    init_distributed(coordinator, int(world), int(rank), timeout_s=120.0)
    stack = load_stack_dir(stack_dir, bands=required_bands("nbr"))
    cfg = RunConfig(tile_size=ROBUST_TILE, workdir=workdir, out_dir=workdir + "_o",
                    telemetry=True)
    segment_cuda.LAUNCHES = 0
    summary = run_stack(stack, cfg, device="cuda")
    summary["launches"] = segment_cuda.LAUNCHES
    with open(out_path + ".tmp", "w") as f:
        json.dump(summary, f)
    os.replace(out_path + ".tmp", out_path)
    dist.destroy_process_group()
    return 0


def prom_gauge(path: str, name: str) -> "float | None":
    with open(path) as f:
        for line in f:
            if line.startswith(name + " "):
                return float(line.split()[1])
    return None


#: phase 2c's wide-kernel populations: (name, years, params overrides)
WIDE_CASES = (("ny72", 72, {}), ("nc18", NY, WIDE_PARAMS))


def bytes_bound(px: int, ny: int, nv: int, nm: int) -> "tuple[int, int]":
    """Bytes the fused and the family kernel must move for ``px`` float32
    series of ``ny`` years: each input read once (values, mask bytes, the
    year axis), each output written once."""
    bytes_in = px * ny * (4 + 1) + ny * 4
    fused = bytes_in + px * (4 * (2 * ny + 4 * nv + 3 * nm + 3) + 1)
    family = bytes_in + px * (4 * ny + nm * ny + 4 * nm)
    return fused, family


def bound_of(n_bytes: int, n_ops: int) -> "tuple[float, str]":
    """The least time the card could take: the larger of bytes over the
    HBM rate and FP32 operations over the FP32 peak, and which bounds it."""
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = n_ops / FP32_OPS_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


#: phase 2d's global-form populations: (name, years, params overrides)
GLOBAL_CASES = (("ny160", 160, {}), ("nc40", NY, GLOBAL_PARAMS))
#: phase 2d's scratch-tier case: a series no block of the global form's
#: shared tier holds (years, pixels)
SCRATCH_NY, SCRATCH_PX = 1000, 1024


def global_kernels(dev: torch.device, narrow_share: dict) -> dict:
    """Phase 2d: the global form of both kernels against their plain
    versions at NY = 160 and at 40 candidates (NY = 40), 65,536 px: f32
    bit-identical on every pixel, f64 decisions exact with floats within
    F64_ATOL; then the global form forced at NY = 40 with default params
    against the narrow kernel, bit for bit.  CUDA-event times, op counts,
    scratch bytes, the bound by the function's inputs and outputs, and
    beside it the bound that also counts the scratch's traffic (written
    once, read once); the global form's stage shares beside the narrow
    kernel's at NY = 40 (``narrow_share``, phase 2), its block-size sweep,
    and every instantiation's registers, local bytes and spills.  Returns
    the fused and family measurements."""
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.ops.segment import torch_family_stats, torch_segment_pixels
    from land_trendr_tpu_torch.tools import probe

    out = {}
    for name, ny, over in GLOBAL_CASES:
        params = LTParams(**over)
        assert segment_cuda.instantiation(ny, params) == "global", (name, ny, params)
        years_np, vals_np, mask_np = population(np.random.default_rng(20261018), GLOBAL_PX, ny)
        years = torch.from_numpy(years_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        v32 = torch.from_numpy(vals_np.astype(np.float32)).to(dev)
        v64 = torch.from_numpy(vals_np).to(dev)
        before = (segment_cuda.GLOBAL_LAUNCHES, segment_cuda.GLOBAL_FAMILY_LAUNCHES)
        k32 = segment_cuda.cuda_segment_pixels(years, v32, mask, params)
        k64 = segment_cuda.cuda_segment_pixels(years, v64, mask, params)
        f32 = segment_cuda.cuda_family_stats(years, v32, mask, params)
        f64 = segment_cuda.cuda_family_stats(years, v64, mask, params)
        torch.cuda.synchronize()
        assert (segment_cuda.GLOBAL_LAUNCHES, segment_cuda.GLOBAL_FAMILY_LAUNCHES) == (
            before[0] + 2, before[1] + 2), "the global calls did not launch the global forms"
        p32, plain_ms = checked_and_timed(lambda: torch_segment_pixels(years, v32, mask, params))
        every = torch.ones(GLOBAL_PX, dtype=torch.bool, device=dev)
        same32 = bit_identical(k32, p32, every)
        pf32, fplain = checked_and_timed(lambda: torch_family_stats(years, v32, mask, params))
        fsame32 = all(torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
                      for a, b in zip(f32, pf32))
        p64 = torch_segment_pixels(years, v64, mask, params)
        n_bad64 = int((~decisions(k64, p64)).sum())
        err64 = max_float_err(k64, p64, every)
        pf64 = torch_family_stats(years, v64, mask, params)
        fbad64 = int((~(f64[1] == pf64[1]).all(dim=(1, 2))).sum())
        ferr64 = max_pair_err((("despiked", f64[0], pf64[0]), ("sses", f64[2], pf64[2])), every)
        log(f"[global] {name} (NY={ny}, {params.max_candidates} candidates, {GLOBAL_PX} px): "
            f"f32 fused bit-identical on every pixel: {same32}, family: {fsame32}; f64 "
            f"decisions differ on {n_bad64} px (max |float diff| {err64:.3e}), family vertex "
            f"sets on {fbad64} (max |diff| {ferr64:.3e}; limit {F64_ATOL})")
        assert same32 and fsame32, f"{name}: the global form differs from its plain version"
        assert n_bad64 == 0 and fbad64 == 0, f"{name}: f64 decisions differ"
        assert err64 <= F64_ATOL and ferr64 <= F64_ATOL, (err64, ferr64)
        job = segment_cuda._Launch(years, v32, mask, params)
        ms = cuda_ms(lambda: job.run(0, GLOBAL_PX), reps=5)
        occ = segment_cuda.occupancy("fused", torch.float32, ny, cap="global",
                                     nc=params.max_candidates)
        plan64 = segment_cuda.global_plan(ny, params, torch.float64)
        log(f"[global] {name} plan: f32 {job.plan.tier} tier, block {job.plan.block}, "
            f"{job.plan.smem} B shared, {occ['warps_per_sm']} warps/SM; f64 {plan64.tier} "
            f"tier, block {plan64.block}, {plan64.smem} B shared")
        share, per_px = probe.stage_shares(
            segment_cuda.cuda_segment_stage_cycles(years, v32, mask, params))
        log(f"[global] {name} stage shares of the f32 kernel's per-thread cycles (the narrow "
            f"kernel's at NY={NY}, phase 2, beside): " + ", ".join(
                f"{k} {100 * v:.1f}% ({100 * narrow_share[k]:.1f}%)" for k, v in share.items())
            + f"; {sum(per_px.values()):.0f} cycles per pixel's thread")
        sweep = {b: cuda_ms(lambda b=b: job.run(0, GLOBAL_PX, block=b), reps=3)
                 for b in segment_cuda.GLOBAL_SWEEP}
        warps = {b: segment_cuda.occupancy("fused", torch.float32, ny, b, "global",
                                           params.max_candidates)["warps_per_sm"]
                 for b in sweep}
        log(f"[global] {name} block-size sweep (f32 fused, ms; warps/SM): " + ", ".join(
            f"block {b} {t:.4f} ({warps[b]})" for b, t in sweep.items()))
        job64 = segment_cuda._Launch(years, v64, mask, params)
        ms64 = cuda_ms(lambda: job64.run(0, GLOBAL_PX), reps=3)
        n_ops = int(segment_cuda.cuda_segment_op_counts(years, v32, mask, params).sum())
        fjob = segment_cuda._FamilyLaunch(years, v32, mask, params)
        fms = cuda_ms(fjob.run, reps=5)
        f_ops = int(segment_cuda.cuda_family_op_counts(years, v32, mask, params).sum())
        # the shared tier allocates no scratch
        scratch = 0 if job.scratch is None else job.scratch.tensor.numel()
        fused_b, family_b = bytes_bound(GLOBAL_PX, ny, params.max_vertices, params.max_segments)
        # the bound is the function's own traffic; the scratch is the
        # kernel's choice, so its traffic only stands beside it
        bound_ms, bound_by = bound_of(fused_b, n_ops)
        fbound, fby = bound_of(family_b, f_ops)
        with_scratch = bound_of(fused_b + 2 * scratch, n_ops)[0]
        fwith_scratch = bound_of(family_b + 2 * scratch, f_ops)[0]
        log(f"[global] {name} fused: kernel {ms:.4f} ms f32, {ms64:.4f} ms f64; plain "
            f"{plain_ms:.2f} ms; bound {fused_b} B, {n_ops} FP32 ops "
            f"({n_ops / GLOBAL_PX:.0f}/px) -> {bound_ms:.4f} ms by {bound_by}, kernel at "
            f"{100 * bound_ms / ms:.2f}%; scratch {scratch} B ({scratch / GLOBAL_PX:.0f} B/px), "
            f"bound with 2 x scratch {with_scratch:.4f} ms")
        log(f"[global] {name} family: kernel {fms:.4f} ms, plain {fplain:.2f} ms; bound "
            f"{family_b} B, {f_ops} FP32 ops -> {fbound:.4f} ms by {fby}, kernel at "
            f"{100 * fbound / fms:.2f}%; bound with 2 x scratch {fwith_scratch:.4f} ms")
        out[f"fused_{name}"] = {"ms": ms, "ms_f64": ms64, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0,
                                "scratch_bytes": scratch, "bound_ms_with_scratch": with_scratch,
                                "stage_share": share, "cycles_per_px": per_px,
                                "block_sweep_ms": sweep}
        out[f"family_{name}"] = {"ms": fms, "plain_ms": fplain, "bound_ms": fbound,
                                 "bound_by": fby, "max_abs_err": 0.0, "scratch_bytes": scratch,
                                 "bound_ms_with_scratch": fwith_scratch}
    # forced at a shape the narrow kernel holds: the narrow kernel's bits
    params = LTParams()
    years_np, vals_np, mask_np = population(np.random.default_rng(20261019), GLOBAL_PX)
    years = torch.from_numpy(years_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    for dt in (np.float32, np.float64):
        vals = torch.from_numpy(vals_np.astype(dt)).to(dev)
        narrow = segment_cuda.cuda_segment_pixels(years, vals, mask, params)
        fn = segment_cuda.cuda_family_stats(years, vals, mask, params)
        job = segment_cuda._Launch(years, vals, mask, params, cap="global")
        job.run(0, GLOBAL_PX)
        forced = job.result()
        fjob = segment_cuda._FamilyLaunch(years, vals, mask, params, cap="global")
        fjob.run()
        ff = fjob.result()
        every = torch.ones(GLOBAL_PX, dtype=torch.bool, device=dev)
        same = bit_identical(narrow, forced, every) and all(
            torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
            for a, b in zip(fn, ff))
        log(f"[global] forced at NY={NY}, default params, {dt.__name__}: both kernels equal "
            f"the narrow ones bit for bit: {same}")
        assert same, f"the global form forced at NY={NY} differs from the narrow kernel ({dt})"
    out["scratch_tier"] = scratch_tier(dev)
    vals = torch.from_numpy(vals_np.astype(np.float32)).to(dev)
    job = segment_cuda._Launch(years, vals, mask, params, cap="global")
    out["forced_ms"] = cuda_ms(lambda: job.run(0, GLOBAL_PX), reps=10)
    njob = segment_cuda._Launch(years, vals, mask, params)
    out["forced_narrow_ms"] = cuda_ms(lambda: njob.run(0, GLOBAL_PX), reps=10)
    out["forced_sweep_ms"] = {b: cuda_ms(lambda b=b: job.run(0, GLOBAL_PX, block=b), reps=5)
                              for b in segment_cuda.GLOBAL_SWEEP}
    log(f"[global] forced at NY={NY}: global {out['forced_ms']:.4f} ms (block {job.block}), "
        f"narrow {out['forced_narrow_ms']:.4f} ms ({GLOBAL_PX} px f32, "
        f"{out['forced_ms'] / out['forced_narrow_ms']:.2f}x); block-size sweep: " + ", ".join(
            f"block {b} {t:.4f}" for b, t in out["forced_sweep_ms"].items()))
    # registers and local bytes of each production instantiation, and the
    # spills ptxas reported for every entry
    out["attributes"] = segment_cuda.kernel_attributes()
    log("[global] registers / local bytes (cudaFuncGetAttributes): " + ", ".join(
        f"{a['kernel']} {a['cap']} {a['dtype']} {a['registers']} / {a['local_bytes']}"
        for a in out["attributes"]))
    out["ptxas"] = probe.ptxas_rows(segment_cuda.build_info()["ptxas"])
    log("[global] ptxas (registers, stack, spill stores / loads): " + ", ".join(
        f"{r['kernel']} {r['form']} {r['dtype']} {r['policy']} b{r['block']} "
        f"{r['registers']}, {r.get('stack_bytes')}, {r.get('spill_stores')}/{r.get('spill_loads')}"
        for r in out["ptxas"]))
    return out


def scratch_tier(dev: torch.device) -> dict:
    """Phase 2d's scratch tier: NY = SCRATCH_NY, whose series no block of
    the global form's shared tier holds, SCRATCH_PX px against the plain
    version: f32 bit-identical on every pixel, f64 decisions exact with
    floats within F64_ATOL; both kernels, with their times."""
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.ops.segment import torch_family_stats, torch_segment_pixels

    params = LTParams()
    years_np, vals_np, mask_np = population(np.random.default_rng(20261020), SCRATCH_PX,
                                            SCRATCH_NY)
    years = torch.from_numpy(years_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    every = torch.ones(SCRATCH_PX, dtype=torch.bool, device=dev)
    out = {}
    for dt in (np.float32, np.float64):
        vals = torch.from_numpy(vals_np.astype(dt)).to(dev)
        job = segment_cuda._Launch(years, vals, mask, params)
        fjob = segment_cuda._FamilyLaunch(years, vals, mask, params)
        assert job.plan.tier == fjob.plan.tier == "scratch", job.plan
        before = (segment_cuda.GLOBAL_LAUNCHES, segment_cuda.GLOBAL_FAMILY_LAUNCHES)
        job.run(0, SCRATCH_PX)
        fjob.run()
        torch.cuda.synchronize()
        assert (segment_cuda.GLOBAL_LAUNCHES, segment_cuda.GLOBAL_FAMILY_LAUNCHES) == (
            before[0] + 1, before[1] + 1), "the scratch tier did not launch once a kernel"
        got, ref = job.result(), torch_segment_pixels(years, vals, mask, params)
        fam, pfam = fjob.result(), torch_family_stats(years, vals, mask, params)
        if dt == np.float32:
            same = bit_identical(got, ref, every) and all(
                torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
                for a, b in zip(fam, pfam))
            assert same, "the scratch tier (f32) differs from its plain version"
            err = 0.0
        else:
            n_bad = int((~decisions(got, ref)).sum()) + int(
                (~(fam[1] == pfam[1]).all(dim=(1, 2))).sum())
            err = max(max_float_err(got, ref, every), max_pair_err(
                (("despiked", fam[0], pfam[0]), ("sses", fam[2], pfam[2])), every))
            assert n_bad == 0 and err <= F64_ATOL, (n_bad, err)
        key = dt.__name__
        out[key] = {"ms": cuda_ms(lambda: job.run(0, SCRATCH_PX), reps=3),
                    "family_ms": cuda_ms(fjob.run, reps=3), "max_abs_err": err,
                    "scratch_bytes": job.scratch.tensor.numel(),
                    "fit_rate": float(got.model_valid.float().mean())}
        agreed = ("bit-identical on every pixel" if err == 0.0
                  else f"decisions exact, max |diff| {err:.3e}")
        log(f"[global] scratch tier NY={SCRATCH_NY}, {SCRATCH_PX} px {key}: {agreed} (fused "
            f"and family); fused {out[key]['ms']:.4f} ms, family "
            f"{out[key]['family_ms']:.4f} ms, scratch {out[key]['scratch_bytes']} B, fit rate "
            f"{out[key]['fit_rate']:.4f}")
    return out


def phase_2d_alone() -> int:
    """``chip_smoke.py --phase-2d``: the build and phase 2d alone, with the
    narrow kernel's stage shares at NY = 40 on phase 2's population beside
    them; prints the card's line and the phase's JSON last."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.tools import probe

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    info = segment_cuda.build_info(force=True)
    log(f"[build] segment_fused.cu built in {info['build_s']:.2f}s")
    years_np, vals_np, mask_np = population(np.random.default_rng(20261016), POP_PX)
    cyc = segment_cuda.cuda_segment_stage_cycles(
        torch.from_numpy(years_np).to(dev),
        torch.from_numpy(vals_np.astype(np.float32)).to(dev), torch.from_numpy(mask_np).to(dev))
    share, _ = probe.stage_shares(cyc)
    glob = global_kernels(dev, share)
    print(smi)
    print(json.dumps({"narrow_stage_share": share, **glob}))
    return 0


def wide_kernels(dev: torch.device, narrow_ms: float) -> dict:
    """Phase 2c: the wide instantiation of both kernels against their plain
    versions on the card, at NY = 72 (default params) and at 18 candidates
    (NY = 40): f32 decisions >= F32_FLOOR with floats within F32_ATOL on
    agreeing pixels, f64 decisions exact; CUDA-event times, op counts and
    bounds.  Returns the fused and family measurements for the kernels
    line (the fused one at NY = 72)."""
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.ops.segment import torch_family_stats, torch_segment_pixels

    out = {}
    for name, ny, over in WIDE_CASES:
        params = LTParams(**over)
        assert segment_cuda.instantiation(ny, params) == "wide", (name, ny, params)
        years_np, vals_np, mask_np = population(np.random.default_rng(20261017), POP_PX, ny)
        years = torch.from_numpy(years_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        v32 = torch.from_numpy(vals_np.astype(np.float32)).to(dev)
        v64 = torch.from_numpy(vals_np).to(dev)
        before = (segment_cuda.LAUNCHES, segment_cuda.WIDE_LAUNCHES)
        k32 = segment_cuda.cuda_segment_pixels(years, v32, mask, params)
        k64 = segment_cuda.cuda_segment_pixels(years, v64, mask, params)
        torch.cuda.synchronize()
        assert (segment_cuda.LAUNCHES, segment_cuda.WIDE_LAUNCHES) == (
            before[0], before[1] + 2), "the wide call did not launch the wide kernel"
        p32 = torch_segment_pixels(years, v32, mask, params)
        agree32 = decisions(k32, p32)
        rate32 = float(agree32.float().mean())
        err32 = max_float_err(k32, p32, agree32)
        p64 = torch_segment_pixels(years, v64, mask, params)
        agree64 = decisions(k64, p64)
        n_bad64 = int((~agree64).sum())
        err64 = max_float_err(k64, p64, agree64)
        log(f"[wide] {name} (NY={ny}, {params.max_candidates} candidates): f32 decision "
            f"agreement {rate32:.6f} (floor {F32_FLOOR}), max |float diff| {err32:.3e} "
            f"(limit {F32_ATOL}), bit-identical there: {bit_identical(k32, p32, agree32)}; "
            f"f64 decisions differ on {n_bad64} px (max |float diff| {err64:.3e}, limit "
            f"{F64_ATOL})")
        assert rate32 >= F32_FLOOR, f"{name}: f32 decision agreement {rate32}"
        assert err32 <= F32_ATOL, f"{name}: f32 float disagreement {err32}"
        assert n_bad64 == 0, f"{name}: f64 decisions differ on {n_bad64} pixels"
        assert err64 <= F64_ATOL, f"{name}: f64 float disagreement {err64}"
        job = segment_cuda._Launch(years, v32, mask, params)
        ms = cuda_ms(lambda: job.run(0, POP_PX), reps=10)
        job64 = segment_cuda._Launch(years, v64, mask, params)
        ms64 = cuda_ms(lambda: job64.run(0, POP_PX), reps=5)
        plain_ms = cuda_ms(lambda: torch_segment_pixels(years, v32, mask, params), reps=1)
        n_ops = int(segment_cuda.cuda_segment_op_counts(years, v32, mask, params).sum())
        fused_b, family_b = bytes_bound(POP_PX, ny, params.max_vertices, params.max_segments)
        bound_ms, bound_by = bound_of(fused_b, n_ops)
        occ = segment_cuda.occupancy("fused", torch.float32, ny, cap="wide")
        log(f"[wide] {name} fused: kernel {ms:.4f} ms f32, {ms64:.4f} ms f64 (narrow phase 2: "
            f"{narrow_ms:.4f} ms at NY={NY}); plain {plain_ms:.2f} ms; block {occ['block']}, "
            f"{occ['smem_bytes']} B shared, {occ['warps_per_sm']} warps/SM; bound {fused_b} B, "
            f"{n_ops} FP32 ops ({n_ops / POP_PX:.0f}/px) -> {bound_ms:.4f} ms by {bound_by}, "
            f"kernel at {100 * bound_ms / ms:.1f}%")
        rec = {"ms": ms, "ms_f64": ms64, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": err32}
        out[f"fused_{name}"] = rec
        if name != "ny72":
            continue
        # the wide family kernel on the same population
        f32 = segment_cuda.cuda_family_stats(years, v32, mask, params)
        pf32 = torch_family_stats(years, v32, mask, params)
        fagree = (f32[1] == pf32[1]).all(dim=(1, 2))
        frate = float(fagree.float().mean())
        ferr = max_pair_err((("despiked", f32[0], pf32[0]), ("sses", f32[2], pf32[2])), fagree)
        f64 = segment_cuda.cuda_family_stats(years, v64, mask, params)
        pf64 = torch_family_stats(years, v64, mask, params)
        fbad = int((~(f64[1] == pf64[1]).all(dim=(1, 2))).sum())
        ferr64 = max_pair_err((("despiked", f64[0], pf64[0]), ("sses", f64[2], pf64[2])),
                              torch.ones_like(fagree))
        log(f"[wide] {name} family: f32 vertex sets agree on {frate:.6f}, max |diff| "
            f"{ferr:.3e}; f64 vertex sets differ on {fbad} px, max |diff| {ferr64:.3e}")
        assert frate >= F32_FLOOR and ferr <= F32_ATOL, (frate, ferr)
        assert fbad == 0 and ferr64 <= F64_ATOL, (fbad, ferr64)
        fjob = segment_cuda._FamilyLaunch(years, v32, mask, params)
        fms = cuda_ms(fjob.run, reps=10)
        fplain = cuda_ms(lambda: torch_family_stats(years, v32, mask, params), reps=1)
        f_ops = int(segment_cuda.cuda_family_op_counts(years, v32, mask, params).sum())
        fbound, fby = bound_of(family_b, f_ops)
        log(f"[wide] {name} family: kernel {fms:.4f} ms, plain {fplain:.2f} ms; bound "
            f"{family_b} B, {f_ops} FP32 ops -> {fbound:.4f} ms by {fby}, kernel at "
            f"{100 * fbound / fms:.1f}%")
        out["family_ny72"] = {"ms": fms, "plain_ms": fplain, "bound_ms": fbound,
                              "bound_by": fby, "max_abs_err": ferr}
    return out


def http(port: int, path: str, payload=None, timeout: float = 120.0) -> "tuple[int, dict]":
    """One request to a server's loopback JSON API: ``(status, body)``."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return r.status, (json.loads(body) if body.startswith(b"{") else {"text": body.decode()})
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_state(get, states=("done", "cancelled", "error", "config_error", "stalled",
                            "retries_exhausted"), timeout: float = 600.0, poll: float = 0.005):
    """Poll ``get()`` (a job status dict) until its state is one of ``states``."""
    t0 = time.monotonic()
    while True:
        st = get()
        if st["state"] in states:
            return st
        assert time.monotonic() - t0 < timeout, f"job stuck in {st['state']}"
        time.sleep(poll)


def serve_phase(dev: torch.device, smi: str, env: dict, tmp: str, stack_dir: str) -> dict:
    """Phase 10: ``serve`` on the card (see the module docstring), in the
    directory ``tmp``, over the 1024² stack written to ``stack_dir`` (made
    on the host beside the earlier phases); returns the launch counts of
    the serve path, the measurements printed and the stack's directory
    (phase 11's)."""
    from land_trendr_tpu_torch.obs import aggregate
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig

    t10 = time.perf_counter()
    out: dict = {}
    n_tiles = (SERVE // SERVE_TILE) ** 2
    job = {"stack_dir": stack_dir, "tile_size": SERVE_TILE}
    wide_job = {**job, "params": dict(WIDE_PARAMS)}

    # the references: `segment` of the same stack and params
    def cli_ref(name, extra):
        o = os.path.join(tmp, name)
        r = subprocess.run(
            [sys.executable, "-m", "land_trendr_tpu_torch", "segment", stack_dir,
             "--tile-size", str(SERVE_TILE), "--workdir", o + "_w", "--out-dir", o, *extra],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        return raster_digests(o)

    with ThreadPoolExecutor(3) as pool:  # host-bound runs, side by side
        refs = [pool.submit(cli_ref, name, extra) for name, extra in (
            ("cli_default", []),
            ("cli_wide", ["--max-segments", "14", "--vertex-count-overshoot", "3"]),
            ("cli_global", ["--max-segments", "36", "--vertex-count-overshoot", "3"]))]
        ref, ref_wide, ref_global = (f.result() for f in refs)
    out["stack_dir"] = stack_dir
    log(f"[serve] segment references: default, 18- and 40-candidate params "
        f"({time.perf_counter() - t10:.1f} s)")

    # ---- in-process server: (a), then (c) with the flood (b) behind it
    dispatcher = None
    server = SegmentationServer(ServeConfig(workdir=os.path.join(tmp, "srv"), batch=False,
                                            batch_window_ms=500.0), device=dev)
    try:
        dispatcher = threading.Thread(target=server.serve_forever, name="smoke-dispatcher")
        dispatcher.start()
        status = server.job_status
        # (a) cold, then warm: the second submitted once the first runs
        segment_cuda.LAUNCHES = 0
        j1 = server.submit(dict(job))
        wait_state(lambda: status(j1["job_id"]), ("running",))
        j2 = server.submit(dict(job))
        s1 = wait_state(lambda: status(j1["job_id"]))
        cold_launches = segment_cuda.LAUNCHES  # job 2 is still loading its stack
        s2 = wait_state(lambda: status(j2["job_id"]))
        warm_launches = segment_cuda.LAUNCHES - cold_launches
        for s in (s1, s2):
            assert s["state"] == "done", s.get("error")
            assert s["summary"]["impl"] == "cuda" and s["summary"]["tiles_done"] == n_tiles
            assert raster_digests(os.path.dirname(next(iter(s["outputs"].values())))) == ref, (
                f"{s['job_id']} rasters differ from segment's")
        assert s1["summary"]["program_cache"]["misses"] == 1, s1["summary"]["program_cache"]
        assert s2["summary"]["program_cache"]["hits"] == 1, s2["summary"]["program_cache"]
        assert (cold_launches, warm_launches) == (n_tiles + 1, n_tiles), (
            cold_launches, warm_launches)
        lat = {k: (s["finished_t"] - s["submitted_t"], s["finished_t"] - s["started_t"])
               for k, s in (("cold", s1), ("warm", s2))}
        log(f"[serve] (a) cold job: {cold_launches} launches, latency {lat['cold'][0]:.3f} s "
            f"(exec {lat['cold'][1]:.3f} s, of it the run {s1['summary']['wall_s']} s, "
            f"program warm-up {s1['summary']['program_cache']['compile_s']} s); warm job: "
            f"{warm_launches} launches, exec {lat['warm'][1]:.3f} s (the run "
            f"{s2['summary']['wall_s']} s; latency {lat['warm'][0]:.3f} s incl. its queue "
            f"wait); the rest of exec is the stack load and assembly; both byte-equal to "
            f"segment ({smi})")

        # (c) the wide job, and the flood queued behind it
        server.cfg = dataclasses.replace(server.cfg, batch=True)
        segment_cuda.LAUNCHES = 0
        segment_cuda.WIDE_LAUNCHES = 0
        jw = server.submit(dict(wide_job))
        wait_state(lambda: status(jw["job_id"]), ("running",))
        # one tenant each: the per-tenant in-flight cap stays out of the way
        flood = [server.submit({**job, "tenant": f"flood{i}"}) for i in range(FLOOD)]
        sw = wait_state(lambda: status(jw["job_id"]))
        wide_launches = segment_cuda.WIDE_LAUNCHES
        t_flood0 = sw["finished_t"]
        sf = [wait_state(lambda j=j: status(j["job_id"])) for j in flood]
        flood_launches = segment_cuda.LAUNCHES
        assert sw["state"] == "done", sw.get("error")
        assert raster_digests(os.path.dirname(next(iter(sw["outputs"].values())))) == ref_wide, (
            "the wide job's rasters differ from segment's")
        assert wide_launches == n_tiles + 1, wide_launches
        for s in sf:
            assert s["state"] == "done", s.get("error")
            assert raster_digests(os.path.dirname(next(iter(s["outputs"].values())))) == ref
        assert [s["summary"]["tiles_done"] for s in sf] == [n_tiles] + [0] * (FLOOD - 1), (
            [s["summary"]["tiles_done"] for s in sf])
        assert flood_launches == n_tiles, flood_launches
        launches_ev = []
        with open(os.path.join(tmp, "srv", "events.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("ev") == "batch_launch":
                    launches_ev.append(rec)
        assert len(launches_ev) == 1 and launches_ev[0]["jobs"] == FLOOD, launches_ev
        assert launches_ev[0]["job_id"] == flood[0]["job_id"], "the wide job was batched"
        flood_s = max(s["finished_t"] for s in sf) - t_flood0
        log(f"[serve] (c) 18-candidate job: {wide_launches} wide launches (cold), "
            f"latency {sw['finished_t'] - sw['submitted_t']:.3f} s, byte-equal to segment; "
            f"(b) flood of {FLOOD}: one batch of {launches_ev[0]['jobs']}, {flood_launches} "
            f"launches ({flood_launches / FLOOD:.2f} per job), members 0 tiles of their own, "
            f"{FLOOD / flood_s:.3f} jobs/s ({flood_s:.3f} s), all byte-equal ({smi})")
        # (g) a job at 40 candidates: the global form of the kernel
        segment_cuda.GLOBAL_LAUNCHES = 0
        jg = server.submit({**job, "params": dict(GLOBAL_PARAMS)})
        sg = wait_state(lambda: status(jg["job_id"]))
        global_launches = segment_cuda.GLOBAL_LAUNCHES
        assert sg["state"] == "done", sg.get("error")
        assert raster_digests(os.path.dirname(next(iter(sg["outputs"].values())))) == ref_global, (
            "the 40-candidate job's rasters differ from segment's")
        assert global_launches == n_tiles + 1, global_launches
        log(f"[serve] (g) 40-candidate job: {global_launches} global launches (cold), latency "
            f"{sg['finished_t'] - sg['submitted_t']:.3f} s, byte-equal to segment ({smi})")
        out.update(cold_launches=cold_launches, warm_launches=warm_launches,
                   wide_launches=wide_launches, flood_launches=flood_launches,
                   global_launches=global_launches,
                   cold_latency_s=lat["cold"][0], warm_exec_s=lat["warm"][1],
                   flood_jobs_per_s=FLOOD / flood_s)
    finally:
        server.stop()
        if dispatcher is not None:
            dispatcher.join(timeout=300)
        else:
            server.serve_forever()  # never dispatched: runs the shared shutdown
    assert not dispatcher.is_alive(), "the in-process server did not stop"

    # ---- a `serve` subprocess over HTTP: (e), (d), (f)
    srv_dir = os.path.join(tmp, "srvp")
    proc = subprocess.Popen(
        [sys.executable, "-m", "land_trendr_tpu_torch", "serve", "--workdir", srv_dir,
         "--serve-port", "0", "--publish", "--publish-interval-s", "1",
         "--fault-schedule", "seed=1,dispatch%1.0=slow:0.75"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        start = json.loads(proc.stdout.readline())
        assert start["serving"] is True, start
        port = start["port"]

        def jstat(job_id):
            return http(port, f"/jobs/{job_id}")[1]

        # (e) a profile over a job's warm-up tile and its first tiles.  The
        # first capture in a process pays the profiler's start-up (seconds,
        # recording nothing meanwhile), so an idle capture comes first
        t0 = time.perf_counter()
        st, prof0 = http(port, "/debug/profile", {"duration_s": 0.5})
        assert st == 200 and prof0.get("ok"), prof0
        first_capture_s = time.perf_counter() - t0
        st, d1 = http(port, "/jobs", job)
        assert st == 200, d1
        t0 = time.monotonic()
        while True:
            running = http(port, "/debug/jobs")[1].get("jobs", [])
            prog = [j.get("progress", {}) for j in running if j.get("job_id") == d1["job_id"]]
            if prog and prog[0].get("phase") in ("warmup", "pipeline"):
                break
            assert time.monotonic() - t0 < 300, "the job never reached its warm-up"
            time.sleep(0.01)
        st, prof = http(port, "/debug/profile", {"duration_s": 4.0})
        assert st == 200 and prof.get("ok"), prof
        fused = []
        for root, _dirs, files in os.walk(prof["path"]):
            for fn in files:
                if fn.endswith(".json"):
                    with open(os.path.join(root, fn)) as f:
                        fused += [e for e in json.load(f).get("traceEvents", [])
                                  if e.get("cat") == "kernel"
                                  and "segment_fused_kernel" in e.get("name", "")]
        assert fused, f"the profile under {prof['path']} names no segment_fused_kernel"
        s = wait_state(lambda: jstat(d1["job_id"]))
        assert s["state"] == "done", s
        st, h = http(port, "/healthz")
        assert st == 200 and h["warm_program_count"] >= 1, h
        st, prom = http(port, "/metrics")
        assert st == 200 and "lt_serve_warm_hit_ratio" in prom["text"], prom
        log(f"[serve] (e) first /debug/profile of 0.5 s took {first_capture_s:.2f} s "
            f"(profiler start-up); during a job: {prof['bytes']} B trace, "
            f"{len(fused)} segment_fused_kernel launches in it; /healthz "
            f"warm_program_count {h['warm_program_count']}; /metrics has "
            "lt_serve_warm_hit_ratio")

        # (d) cancel mid-run, then resubmit into the same workdir
        st, d2 = http(port, "/jobs", job)
        assert st == 200, d2
        t0 = time.monotonic()
        while not [p for p in os.listdir(d2["workdir"]) if p.startswith("tile_")] \
                if os.path.isdir(d2["workdir"]) else True:
            assert time.monotonic() - t0 < 300, "no tile became durable"
            time.sleep(0.005)
        http(port, f"/jobs/{d2['job_id']}/cancel", {})
        s = wait_state(lambda: jstat(d2["job_id"]))
        done_tiles = len([p for p in os.listdir(d2["workdir"]) if p.startswith("tile_")])
        assert s["state"] == "cancelled" and 1 <= done_tiles < n_tiles, (s["state"], done_tiles)
        st, d3 = http(port, "/jobs", {**job, "workdir": d2["workdir"]})
        assert st == 200, d3
        s = wait_state(lambda: jstat(d3["job_id"]))
        assert s["state"] == "done", s
        assert s["summary"]["tiles_skipped_resume"] == done_tiles, s["summary"]
        assert raster_digests(os.path.dirname(next(iter(s["outputs"].values())))) == ref
        log(f"[serve] (d) cancelled after {done_tiles} durable tiles; the resubmission "
            f"resumed {n_tiles - done_tiles} and is byte-equal to segment")

        # (f) the server's snapshot and a segment --publish into one directory
        tel = os.path.join(srv_dir, "telemetry")
        r = subprocess.run(
            [sys.executable, "-m", "land_trendr_tpu_torch", "segment", stack_dir,
             "--tile-size", str(SERVE_TILE), "--workdir", os.path.join(tmp, "pub_w"),
             "--out-dir", os.path.join(tmp, "pub_o"), "--telemetry", "--publish",
             "--telemetry-dir", tel],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        view = aggregate.fold_dir(tel)
        hosts = view["hosts"]
        kinds = sorted(h.get("kind", "?") for h in hosts)
        ok = [h for h in hosts if not (h.get("stale") or h.get("corrupt") or h.get("excluded"))]
        assert view["counts"]["folded"] == 2 and len(ok) == 2, view["counts"]
        log(f"[serve] (f) fold_dir: {view['counts']['folded']} hosts ({', '.join(kinds)}), "
            f"both ok; lt_tiles_done_total "
            f"{ {i['name']: i for i in view['metrics']}['lt_tiles_done_total']['value'] }")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t10
    log(f"[phase 10] took {out['seconds']:.1f}s")
    return out


def route_phase(smi: str, env: dict, tmp: str, stack_dir: str) -> dict:
    """Phase 11: ``route`` and ``load`` on the card over phase 10's stack
    (see the module docstring), in the directory ``tmp``; returns the
    launch counts and the measurements printed."""
    from land_trendr_tpu_torch.loadgen.trace import SHAPE_PARAMS
    from land_trendr_tpu_torch.obs import reqtrace

    t11 = time.perf_counter()
    out: dict = {}
    n_tiles = (SERVE // SERVE_TILE) ** 2
    rt = os.path.join(tmp, "rt")
    os.makedirs(rt, exist_ok=True)
    procs: list = []

    def pflags(params: dict) -> list:
        return [f for k, v in params.items() for f in (f"--{k.replace('_', '-')}", str(v))]

    def cli_ref(name: str, tile: int, params: dict) -> dict:
        o = os.path.join(tmp, name)
        r = subprocess.run(
            [sys.executable, "-m", "land_trendr_tpu_torch", "segment", stack_dir,
             "--tile-size", str(tile), "--workdir", o + "_w", "--out-dir", o, *pflags(params)],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        return raster_digests(o)

    def start_router(spawn: int) -> "tuple[subprocess.Popen, dict]":
        """``route`` on the card's default device; its startup line."""
        with open(os.path.join(tmp, "route.log"), "ab") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "land_trendr_tpu_torch", "route", "--workdir", rt,
                 "--spawn-replicas", str(spawn), "--health-interval-s", "0.5"],
                cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        procs.append(proc)
        line = proc.stdout.readline()
        assert line, f"route exited {proc.poll()} before its startup line"
        start = json.loads(line)
        assert start["routing"] is True, start
        return proc, start

    def replicas() -> dict:
        """rid -> (base port, pid) of every spawned replica on record."""
        got = {}
        for rid in sorted(os.listdir(os.path.join(rt, "replicas"))):
            with open(os.path.join(rt, "replicas", rid, "replica.json")) as f:
                meta = json.load(f)
            got[rid] = (int(meta["base"].rsplit(":", 1)[1]), int(meta["pid"]))
        return got

    def alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except OSError:
            return False
        return True

    def job_digests(snap: dict) -> dict:
        return raster_digests(snap["out_dir"])

    try:
        # the references (`segment` of each request) while the router and
        # its two replicas start
        with ThreadPoolExecutor(4) as pool:
            fut_refs = {shape: pool.submit(cli_ref, f"route_ref_{shape}", SERVE_TILE, p)
                        for shape, p in SHAPE_PARAMS.items()}
            fut_kill = pool.submit(cli_ref, "route_ref_kill", KILL_TILE, SHAPE_PARAMS["a"])
            t0 = time.perf_counter()
            router, start = start_router(2)
            start_s = time.perf_counter() - t0
            refs = {shape: f.result() for shape, f in fut_refs.items()}
            ref_kill = fut_kill.result()
        port = start["port"]
        reps0 = replicas()
        assert start["replicas"] == 2 and len(reps0) == 2, (start, reps0)
        counts0 = {rid: http(rport, "/debug/kernels")[1]["launches"]
                   for rid, (rport, _pid) in reps0.items()}
        assert all(v == 0 for c in counts0.values() for v in c.values()), counts0
        log(f"[route] route up in {start_s:.1f} s with 2 replicas on the card; references "
            f"ready ({time.perf_counter() - t11:.1f} s)")

        # (a) `load`: a seeded closed-loop trace of ROUTE_JOBS jobs, 2 tenants
        report = os.path.join(tmp, "load.json")
        r = subprocess.run(
            [sys.executable, "-m", "land_trendr_tpu_torch", "load", "--router-url",
             f"http://127.0.0.1:{port}", "--stack-dir", stack_dir, "--tile-size", str(SERVE_TILE),
             "--mode", "closed", "--requests", str(ROUTE_JOBS), "--workers", "2",
             "--tenants", "2", "--seed", "11", "--duration-s", "900", "--timeout-s", "600",
             "--out", report],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=960)
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
        with open(report) as f:
            rep = json.load(f)
        assert (rep["offered"], rep["done"], rep["failed"], rep["rejected"]) == (
            ROUTE_JOBS, ROUTE_JOBS, 0, 0), rep
        assert {o["tenant"] for o in rep["outcomes"]} == {"t0", "t1"}, rep["outcomes"]
        shape_of = {o["trace_id"]: o["shape"] for o in rep["outcomes"]}
        snaps = [s for s in http(port, "/jobs")[1]["jobs"] if s["trace_id"] in shape_of]
        assert len(snaps) == ROUTE_JOBS and all(s["state"] == "done" for s in snaps), snaps
        for s in snaps:
            assert job_digests(s) == refs[shape_of[s["trace_id"]]], (
                f"{s['job_id']} rasters differ from segment's")
        counts = {rid: http(rport, "/debug/kernels")[1]["launches"]
                  for rid, (rport, _pid) in reps0.items()}
        launches = sum(c["LAUNCHES"] for c in counts.values())
        cold = len({(s["replica"], shape_of[s["trace_id"]]) for s in snaps})
        assert launches == ROUTE_JOBS * n_tiles + cold, (launches, cold, counts)
        assert all(c[k] == 0 for c in counts.values() for k in c if k != "LAUNCHES"), counts
        lat = np.array([o["latency_s"] for o in rep["outcomes"]])
        # 8 samples hold no p99: the slowest job is printed as what it is
        out.update(route_launches=launches, jobs_per_s=ROUTE_JOBS / rep["wall_s"],
                   p50_s=float(np.percentile(lat, 50)), max_s=float(lat.max()))
        log(f"[route] (a) load: {ROUTE_JOBS} jobs from 2 tenants, closed loop over 2 "
            f"replicas: all done and byte-equal to segment; {launches} launches = "
            f"{ROUTE_JOBS} x {n_tiles} tiles + {cold} cold (replica x shape); "
            f"{out['jobs_per_s']:.3f} jobs/s over {rep['wall_s']:.3f} s, job latency p50 "
            f"{out['p50_s']:.3f} s, max of {ROUTE_JOBS} {out['max_s']:.3f} s ({smi})")

        # (b) reqtrace: one request assembled across the router and a replica
        tid = rep["outcomes"][0]["trace_id"]
        rec = reqtrace.assemble_request(reqtrace.discover_request_files(rt), tid)
        assert rec["found"] and rec["complete"], rec
        assert len(rec["hops"]) == 1 and rec["hops"][0]["ok"] is True, rec["hops"]
        assert abs(rec["blame_sum_s"] - rec["latency_s"]) < 1e-3, rec
        log(f"[route] (b) reqtrace {tid}: complete, {len(rec['hops'])} hop on "
            f"{rec['hops'][0]['replica']}, latency {rec['latency_s']:.3f} s = "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(rec["blame"].items())))

        # (c) SIGKILL the replica running a job after its first durable tile
        kill_job = {"stack_dir": stack_dir, "tile_size": KILL_TILE,
                    "params": dict(SHAPE_PARAMS["a"]), "idempotency_key": "smoke-kill"}
        st, snap = http(port, "/jobs", kill_job)
        assert st == 200, snap
        t0 = time.monotonic()
        while True:
            s = http(port, f"/jobs/{snap['job_id']}")[1]
            durable = os.path.isdir(s["workdir"]) and any(
                p.startswith("tile_") for p in os.listdir(s["workdir"]))
            if s.get("replica") and durable:
                break
            assert s["state"] in ("queued", "routed"), s
            assert time.monotonic() - t0 < 300, "the job never made a tile durable"
            time.sleep(0.02)
        victim = s["replica"]
        os.kill(reps0[victim][1], signal.SIGKILL)
        t_kill = time.perf_counter()
        s = wait_state(lambda: http(port, f"/jobs/{snap['job_id']}")[1], poll=0.05)
        reroute_s = time.perf_counter() - t_kill
        assert s["state"] == "done", s
        assert s["attempts"] >= 2 and s["replica"] != victim, s
        assert job_digests(s) == ref_kill, "the re-routed job's rasters differ from segment's"
        out["reroute_s"] = reroute_s
        log(f"[route] (c) SIGKILL of {victim} mid-job (tile {KILL_TILE}: "
            f"{(SERVE // KILL_TILE) ** 2} tiles): re-routed to {s['replica']} after "
            f"{s['attempts'] - 1} failed attempt(s), done {reroute_s:.3f} s after the kill, "
            f"byte-equal to segment ({smi})")

        # (d) crash the router with two jobs admitted, restart it on the
        # same workdir: the journal replays and no admitted job is lost
        crash = {}
        for shape in SHAPE_PARAMS:
            st, sn = http(port, "/jobs", {"stack_dir": stack_dir, "tile_size": SERVE_TILE,
                                          "params": dict(SHAPE_PARAMS[shape]),
                                          "idempotency_key": f"smoke-crash-{shape}"})
            assert st == 200, sn
            crash[shape] = sn["job_id"]
        t0 = time.monotonic()
        while not all(http(port, f"/jobs/{j}")[1]["state"] == "routed" for j in crash.values()):
            assert time.monotonic() - t0 < 300, "the crash jobs were never routed"
            time.sleep(0.02)
        router.kill()
        router.wait(timeout=60)
        t0 = time.perf_counter()
        router, start = start_router(1)
        port = start["port"]
        restart_s = time.perf_counter() - t0
        recovery = http(port, "/healthz")[1]["recovery"]
        assert recovery["clean"] is False and recovery["replayed"] >= len(crash), recovery
        for shape, jid in crash.items():
            s = wait_state(lambda jid=jid: http(port, f"/jobs/{jid}")[1], poll=0.05)
            assert s["state"] == "done", s
            assert job_digests(s) == refs[shape], f"{jid} rasters differ after the restart"
            st, again = http(port, "/jobs", {"stack_dir": stack_dir, "tile_size": SERVE_TILE,
                                             "params": dict(SHAPE_PARAMS[shape]),
                                             "idempotency_key": f"smoke-crash-{shape}"})
            assert st == 200 and again["deduped"] is True and again["job_id"] == jid, again
        out["restart_s"] = restart_s
        log(f"[route] (d) router SIGKILLed with {len(crash)} jobs routed; restarted in "
            f"{restart_s:.1f} s: journal replayed {recovery['replayed']} "
            f"(relayed {recovery['relayed']}, re-attached {recovery['reattached']}, requeued "
            f"{recovery['requeued']}), every admitted job done and byte-equal, resubmissions "
            f"deduped ({smi})")
    finally:
        # SIGTERM drains like Ctrl-C and stops the replicas; then make
        # sure no process of this phase outlives it
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=180)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        if os.path.isdir(os.path.join(rt, "replicas")):
            for _rid, (_port, pid) in replicas().items():
                if alive(pid):
                    os.kill(pid, signal.SIGKILL)
    out["seconds"] = time.perf_counter() - t11
    out["rt"] = rt
    log(f"[phase 11] took {out['seconds']:.1f}s")
    return out


def start_tool(env: dict, tmp: str, name: str, *args: str) -> "tuple[subprocess.Popen, str]":
    """Start ``python -m land_trendr_tpu_torch.tools.<name> ARGS --out OUT``
    on the card's default device, its output into files beside OUT."""
    out = os.path.join(tmp, f"{name}.json")
    with open(out + ".stdout", "w") as so, open(out + ".stderr", "w") as se:
        # a session of its own: a kill reaches the tool's children too
        proc = subprocess.Popen([sys.executable, "-m", f"land_trendr_tpu_torch.tools.{name}",
                                 *args, "--out", out], cwd=tmp, env=env, stdout=so, stderr=se,
                                start_new_session=True)
    return proc, out


def kill_tool(proc: subprocess.Popen) -> None:
    """SIGKILL a :func:`start_tool` run's whole process group and reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def finish_tool(started: "tuple[subprocess.Popen, str]", timeout: float = 600.0) -> dict:
    """Wait for a :func:`start_tool` run (its process group killed at
    ``timeout``); its JSON report (the tools print progress)."""
    proc, out = started
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            kill_tool(proc)
    with open(out + ".stdout") as so, open(out + ".stderr") as se:
        assert rc == 0, (out, rc, so.read()[-3000:], se.read()[-3000:])
    with open(out) as f:
        return json.load(f)


def tool(env: dict, tmp: str, name: str, *args: str, timeout: float = 600.0) -> dict:
    """:func:`start_tool`, then :func:`finish_tool`."""
    return finish_tool(start_tool(env, tmp, name, *args), timeout)


def sum_launches(*counts: dict) -> dict:
    """Kernel launch counts summed key by key."""
    total: dict = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def _tools_in_process(dev: torch.device, smi: str, legs: dict) -> dict:
    """Phase 12 (a) and (b), in this process: the float32 kernel against its
    float64 instantiation, then the kernel against the plain version in each
    form; their seconds into ``legs``; returns this process's launch counts."""
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.runtime import faults
    from land_trendr_tpu_torch.tools import impl_identity, parity_f32

    # (a) float32 parity against float64, both on the card, 1,048,576 px
    t0 = time.perf_counter()
    par = parity_f32.measure(1_048_576, dev, verbose=False)
    legs["a"] = time.perf_counter() - t0
    assert par["exact_vertex_agreement"] >= F32_FLOOR, par
    assert par["launches"]["LAUNCHES"] == 2 * 1_048_576 // parity_f32.CHUNK, par["launches"]
    tax = {k: v["count"] for k, v in par["taxonomy"].items()}
    ref_path = os.path.join(ROOT, "PARITY_f32.json")
    ref = None
    if os.path.isfile(ref_path):
        with open(ref_path) as f:
            ref = json.load(f)
    ref_txt = ("; the JAX package's CPU record on the same pixels (PARITY_f32.json): "
               + ", ".join(f"{k} {v['count']}" for k, v in ref["taxonomy"].items())
               + f", exact {ref['exact_vertex_agreement']:.7f}") if ref else ""
    log(f"[tools] (a) parity_f32 1,048,576 px x 40 yr, f32 kernel vs f64 kernel on the card: "
        f"exact {par['exact_vertex_agreement']:.7f} ({', '.join(f'{k} {v}' for k, v in tax.items())}), "
        f"rmse delta max {par['rmse_abs_delta_max']:.3e}, fitted delta p99 max "
        f"{par['fitted_abs_delta_p99_max']:.3e}{ref_txt}; {legs['a']:.1f} s ({smi})")

    # (b) the kernel against the plain version at scale: narrow, wide, global
    t0 = time.perf_counter()
    for form, px, ny, inst in (("narrow", 1_048_576, 40, "narrow"), ("wide", 262_144, 72, "wide"),
                               ("global", 65_536, 160, "global")):
        rec = impl_identity.identity(px, dev, ny=ny, params=LTParams(), verbose=False)
        assert rec["instantiation"] == inst and rec["decisions_identical"], rec
        for k in ("pixel_exact_vertex_indices", "model_valid_equal", "n_vertices_equal"):
            assert rec[k] == px, (form, k, rec[k])
        log(f"[tools] (b) impl_identity {form}: {px:,} px x {ny} yr, decisions identical on "
            f"every pixel; floats bitwise on {rec['float_fields_bitwise_equal']:,}, p_of_f bitwise "
            f"on {rec['p_of_f_bitwise_equal']:,} (fitted delta max {rec['fitted_abs_delta_max']}, "
            f"p_of_f rel delta max {rec['p_of_f_rel_delta_max']})")
    legs["b"] = time.perf_counter() - t0
    own = segment_cuda.launch_counts()
    assert own["LAUNCHES"] > 0 and own["WIDE_LAUNCHES"] > 0 and own["GLOBAL_LAUNCHES"] > 0, own
    assert faults.active() is None
    return own


def tools_phase(smi: str, env: dict, tmp: str, rt: str, scale_run: dict, ftv_tmp: str) -> dict:
    """Phase 12: the port's tools on the card (see the module docstring), in
    the directory ``tmp``, after phase 11 (whose router workdir is ``rt``),
    with phase 14 (b) and (c) (``scale_run``, over phase 4b's ``ftv_tmp``)
    beside (a)-(c); returns the launch counts of this process and of the
    tools' runs, and the seconds of phase 14 (b) and (c)."""
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.runtime import faults

    t12 = time.perf_counter()
    dev = torch.device("cuda", 0)
    legs: dict = {}
    for k in segment_cuda.launch_counts():
        setattr(segment_cuda, k, 0)

    # (c) the fault soak, started first: it checks bytes and seams only, so
    # (a) and (b), checks in this process, run beside it
    t_c = time.perf_counter()
    started_c = start_tool(env, tmp, "fault_soak", "--smoke")
    try:
        own = _tools_in_process(dev, smi, legs)
        soak = finish_tool(started_c, 900)
    finally:
        if started_c[0].poll() is None:  # no process outlives the smoke
            kill_tool(started_c[0])
    legs["c"] = time.perf_counter() - t_c
    assert soak["ok"] and soak["device"] == "cuda", soak.get("cases")
    assert len(soak["seams_fired"]) == len(faults.SEAMS) == 27, soak["seams_fired"]
    assert set(soak["seams_fired"]) == set(faults.SEAMS) == set(soak["seams_armed"])
    assert all(c["artifacts_identical"] for c in soak["cases"]), soak["cases"]
    assert soak["launches"]["LAUNCHES"] > 0, soak["launches"]
    log(f"[tools] (c) fault_soak --smoke: {len(soak['cases'])} cases byte-equal, "
        f"{len(soak['seams_fired'])}/27 seams fired on the card (eager {soak['eager_scene']['width']}"
        f"^2 x 40 at tile {soak['eager_scene']['tile']}); tracks "
        f"{json.dumps(soak['track_seconds'])} s; {legs['c']:.1f} s (beside a and b)")
    # phase 14 (b) and (c) end before the timed legs (d) and (e) start
    scale_host = finish_scale_host_legs(scale_run, ftv_tmp)

    # (d) the elastic soak: churn (SIGKILL + late join) and the slow host
    t0 = time.perf_counter()
    el = tool(env, tmp, "elastic_soak", "--smoke", timeout=900)
    legs["d"] = time.perf_counter() - t0
    assert el["ok"] and sum(el["churn"]["survivor_launches"]) > 0, el
    slow = el["slow_host"]
    log(f"[tools] (d) elastic_soak --smoke: churn {el['churn']['tiles']} tiles byte-equal, "
        f"{el['churn']['steals']} steals, late joiner {el['churn']['late_joiner_tiles']} tiles; "
        f"slow host idle gap {slow['static']['idle_gap_pod_s']} -> {slow['elastic']['idle_gap_pod_s']} s, "
        f"imbalance {slow['static']['host_imbalance']} -> {slow['elastic']['host_imbalance']}, "
        f"spec wins {slow['elastic']['spec_wins']}; {legs['d']:.1f} s")

    # (e) capacity and fleet benches at the JAX tools' smoke sizes
    t0 = time.perf_counter()
    cap = tool(env, tmp, "capacity_bench", "--smoke", *CAPACITY_SMOKE, timeout=900)
    assert cap["ok"] and all(cap["invariants"].values()), cap["invariants"]
    log(f"[tools] (e) capacity_bench --smoke {time.perf_counter() - t0:.1f} s")
    fleet = tool(env, tmp, "fleet_bench", "--smoke", timeout=900)
    assert fleet["ok"] and all(fleet["invariants"].values()), fleet["invariants"]
    legs["e"] = time.perf_counter() - t0
    # a smoke cell's window holds a few jobs, which give no p99: its
    # slowest job is printed as what it is (the p99 is the full run's)
    slowest = {f"{p['replicas']}r@{p['offered_qps']}": [p["done"], p["max_s"]]
               for c in cap["curves"] for p in c["points"]}
    log(f"[tools] (e) capacity_bench --smoke: invariants met, knees "
        f"{ {c['replicas']: c['knee_offered_qps'] for c in cap['curves']} }, "
        f"[jobs done, slowest s] per cell {json.dumps(slowest)}; "
        f"fleet_bench --smoke: warm {fleet['legs']['noaff']['warm_hit_ratio']} (noaff) < "
        f"{fleet['legs']['affinity']['warm_hit_ratio']} (affinity), kill re-routed "
        f"{fleet['legs']['kill']['rerouted_jobs']}, 0 lost; {legs['e']:.1f} s")

    # (f) the slowest request of phase 11, assembled across its router and replicas
    t0 = time.perf_counter()
    trace_out = os.path.join(tmp, "slowest.trace.json")
    r = subprocess.run([sys.executable, "-m", "land_trendr_tpu_torch.tools.lt_request",
                        "--slowest", rt, "--trace", trace_out], cwd=tmp, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout)
    legs["f"] = time.perf_counter() - t0
    assert rec["found"] and rec["complete"], rec
    assert abs(rec["blame_sum_s"] - rec["latency_s"]) < 5e-3, rec
    assert os.path.getsize(trace_out) > 0 and rec["trace"]["events"] > 0
    log(f"[tools] (f) lt_request --slowest over phase 11's router: {rec['trace_id']} "
        f"latency {rec['latency_s']:.3f} s = blame {rec['blame_sum_s']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(rec["blame"].items()))
        + f"), {len(rec['hops'])} hop(s), {rec['trace']['events']} trace events")

    tool_launches = sum_launches(
        soak["launches"],
        *(c for leg in soak["replica_launches"].values() for c in leg.values()),
        {"LAUNCHES": sum(el["churn"]["survivor_launches"])},
        cap["launches"], fleet["launches"])
    out = {"own": own, "tools": tool_launches, "seconds": time.perf_counter() - t12,
           "scale_host": scale_host}
    log(f"[tools] launches in this process (a, b): {json.dumps(own)}; in the tools' processes "
        f"(c-e; replicas read over GET /debug/kernels, elastic survivors from their summaries): "
        f"{json.dumps(tool_launches)}")
    log(f"[phase 12] took {out['seconds']:.1f}s (a {legs['a']:.1f}, b {legs['b']:.1f}, "
        f"c {legs['c']:.1f}, d {legs['d']:.1f}, e {legs['e']:.1f}, f {legs['f']:.1f}) ({smi})")
    return out


def gate_phase(smi: str, env: dict, tmp: str, stack, ftv_out: str) -> dict:
    """Phase 13, after phase 12 in its directory ``tmp``: (a) the joint
    parameter-space parity, (b) ``validate_ftv`` over phase 4b's rasters
    (``ftv_out``, the scene ``stack``) and (c) the perf gate on the card
    over phase 12's elastic, fleet and capacity reports (see the module
    docstring); returns the phase's launch counts and seconds."""
    from land_trendr_tpu_torch.tools import parity_paramspace, validate_ftv

    t13 = time.perf_counter()
    dev = torch.device("cuda", 0)
    legs: dict = {}

    # (a) the JAX tool's joint draw: f64 kernel = oracle, forms = narrow, f32 = plain
    t0 = time.perf_counter()
    par = parity_paramspace.measure(PARAMSPACE_TRIALS, dev, (2000,),
                                    workers=min(8, os.cpu_count() or 1), verbose=False)
    legs["a"] = time.perf_counter() - t0
    px = PARAMSPACE_TRIALS * parity_paramspace.PX
    assert par["ok"] and par["exact"] == par["pixels_total"] == px, par["mismatches"]
    assert (par["forms_bit_identical_trials"] == par["plain_bit_identical_trials"]
            == PARAMSPACE_TRIALS), par["mismatches"]
    log(f"[gate] (a) parity_paramspace: {PARAMSPACE_TRIALS} trials x {parity_paramspace.PX} px "
        f"(seed base 2000): {par['exact']:,} / {px:,} px exact against the oracle, "
        f"{len(par['mismatches'])} mismatches; every admitting form bit-identical to narrow "
        f"in f32 and f64 on {par['forms_bit_identical_trials']} trials (forms run "
        f"{json.dumps(par['forms_run'])}), f32 kernel = plain on "
        f"{par['plain_bit_identical_trials']}; launches {json.dumps(par['launches'])}; "
        f"oracle {par['oracle_s']} s on {par['oracle_workers']} processes; {legs['a']:.1f} s")

    # (b) phase 4b's FTV rasters re-derived from the DNs through the oracle
    t0 = time.perf_counter()
    rep = validate_ftv.validate(stack, ftv_out, FTV, n_samples=64, device=dev)
    legs["b"] = time.perf_counter() - t0
    assert rep["pass"], rep
    log("[gate] (b) validate_ftv over phase 4b (64 px): " + ", ".join(
        f"ftv_{k} max |delta| {r['max_abs_delta']:.3e} (p99 {r['p99_abs_delta']:.3e})"
        for k, r in rep["indices"].items())
        + f" against the tolerance {validate_ftv.TOLERANCE}; {legs['b']:.1f} s")

    # (c) the gate on the card, over phase 12's reports (no bench runs twice)
    t0 = time.perf_counter()
    out = os.path.join(tmp, "perf_gate.json")
    r = subprocess.run(
        [sys.executable, "-m", "land_trendr_tpu_torch.tools.perf_gate", "--device", "cuda",
         "--json", "--out", out,
         "--scheduler-report", os.path.join(tmp, "elastic_soak.json"),
         "--router-report", os.path.join(tmp, "fleet_bench.json"),
         "--capacity-report", os.path.join(tmp, "capacity_bench.json")],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=900)
    legs["c"] = time.perf_counter() - t0
    assert os.path.isfile(out), (r.returncode, r.stdout[-3000:], r.stderr[-3000:])
    with open(out) as f:
        verdict = json.load(f)
    for c in verdict["checks"]:
        mark = "finding" if c.get("finding") else {True: "ok", False: "FAIL", None: "n/a"}[c["ok"]]
        log(f"[gate] (c) {mark} {c['check']}: {c['detail']}")
    # on the card every row is decided: ok, or a band the card's own record
    # cannot give (a finding, named) — never an unexplained n/a
    failed = [c["check"] for c in verdict["checks"]
              if c["ok"] is not True and not c.get("finding")]
    findings = [c["check"] for c in verdict["checks"] if c.get("finding")]
    assert r.returncode == 0 and verdict["ok"] and not failed, (r.returncode, failed)
    log(f"[gate] (c) perf_gate --device cuda: {len(verdict['checks']) - len(findings)} checks "
        f"ok ({sum(c['kind'] == 'band' and c['ok'] is True for c in verdict['checks'])} of them "
        f"bands met), findings without a band {findings}; {verdict['lint']}; "
        f"the gate's own {verdict['seconds']} s, launches {json.dumps(verdict['launches'])}; "
        f"{legs['c']:.1f} s")
    out13 = {"launches": sum_launches(par["launches"], verdict["launches"]),
             "seconds": time.perf_counter() - t13}
    log(f"[phase 13] took {out13['seconds']:.1f}s (a {legs['a']:.1f}, b {legs['b']:.1f}, "
        f"c {legs['c']:.1f}) ({smi})")
    return out13


def start_scale_host_legs(env: dict, tmp: str, ftv_tmp: str, stack) -> dict:
    """Start phase 14 (b) and (c) side by side in the directory ``tmp``
    (``ftv_tmp`` holds phase 4b's workdir and rasters over ``stack``): they
    run beside phase 12 (a)-(c), which check bytes and seams only, and
    :func:`finish_scale_host_legs` reads them before phase 12 (d)."""
    h, w = stack.shape
    return {"t0": time.perf_counter(), "shape": (h, w), "started": {
        "b": start_tool(env, tmp, "change_stream_bench", f"--size={GIGA_SIZE}", "--mmu=9",
                        "--work-root", tmp),
        "c": start_tool(
            env, tmp, "stream_assembly_bench", "scene", os.path.join(ftv_tmp, "work"),
            "--years", f"{int(stack.years[0])}:{int(stack.years[-1])}", "--shape", f"{h},{w}",
            "--tile-size", str(TILE), "--ftv", ",".join(FTV), "--change-max-dur", "4",
            "--out-dir", os.path.join(tmp, "sa_out"))}}


def stop_scale_host_legs(run: dict) -> None:
    """Kill whatever :func:`start_scale_host_legs` started that still runs."""
    for proc, _ in run["started"].values():
        if proc.poll() is None:
            kill_tool(proc)


def finish_scale_host_legs(run: dict, ftv_tmp: str) -> dict:
    """Phase 14 (b) the streamed change maps with the mmu sieve and (c)
    phase 4b's workdir re-assembled by the streaming writers, as
    :func:`start_scale_host_legs` started them; returns the seconds from
    their start to each one's end."""
    legs: dict = {}
    h, w = run["shape"]
    try:
        cs = finish_tool(run["started"]["b"], 900)[f"change_{GIGA_SIZE}x{GIGA_SIZE}_mmu9"]
        legs["b"] = time.perf_counter() - run["t0"]
        sa = finish_tool(run["started"]["c"], 900)[f"scene_{h}x{w}"]
        legs["c"] = time.perf_counter() - run["t0"]
    finally:
        stop_scale_host_legs(run)  # no process outlives the smoke
    assert cs["changed_frac_first_rows"] > 0, cs
    log(f"[scale] (b) change_stream_bench {GIGA_SIZE}^2, mmu 9: change maps "
        f"{cs['change_wall_s']:.2f} s, peak RSS {cs['peak_rss_mb']} MiB (after fabricating "
        f"{cs['rss_after_fabricate_mb']}), fabricate {cs['fabricate_s']:.1f} s; done "
        f"{legs['b']:.1f} s after its start (beside phase 12 a-c)")
    assert sa["out_sha256"] == raster_digests(os.path.join(ftv_tmp, "out")), (
        "the re-assembled rasters differ from phase 4b's")
    log(f"[scale] (c) stream_assembly_bench scene over phase 4b ({h}x{w}, {sa['products']} "
        f"rasters byte-equal to phase 4b's; beside (b), on the host): {sa['wall_s']:.2f} s, "
        f"peak RSS {sa['peak_rss_mb']} MiB ({sa['out_bytes_total']} B out); done "
        f"{legs['c']:.1f} s after its start")
    return legs


def scale_phase(smi: str, env: dict, tmp: str, host_legs: dict) -> dict:
    """Phase 14, after phase 13 in its directory ``tmp``: (a) and (d) of the
    scale tools at smoke size (see the module docstring), each as its own
    process, so each peak RSS is that process's; (b) and (c) ran beside
    phase 12 (``host_legs``: their seconds).  Returns the launch counts the
    tools report and the phase's seconds."""
    t14 = time.perf_counter()
    legs: dict = {}
    # (a) the composed run, SIGKILLed after its first durable tile and resumed
    t0 = time.perf_counter()
    giga = tool(env, tmp, "giga_run", "all", "--size", str(GIGA_SIZE), "--kill-tiles", "1",
                "--out-root", os.path.join(tmp, "giga"),
                timeout=900)[f"giga_{GIGA_SIZE}x{GIGA_SIZE}"]
    legs["a"] = time.perf_counter() - t0
    killed, resumed = giga["segment_killed"], giga["segment_resumed"]
    assert killed["rc"] == -signal.SIGKILL, killed
    assert 1 <= resumed["tiles_skipped_resume"] < giga["tiles"] == 4, resumed
    assert giga["rasters_equal_unkilled"] and giga["rasters"] == 12, giga
    # a 1024² tile is four chunks of chunk_px = 262,144: four launches
    assert resumed["launches"] == 4 * resumed["tiles_done"] > 0, resumed
    shutil.rmtree(os.path.join(tmp, "giga"))
    log(f"[scale] (a) giga_run all {GIGA_SIZE}^2 x {giga['ny']} yr, tile {giga['tile']}: segment "
        f"SIGKILLed (rc {killed['rc']}) with {killed['durable_seen']} tile(s) durable after "
        f"{killed['wall_s']:.2f} s; resume skipped {resumed['tiles_skipped_resume']} of "
        f"{giga['tiles']}; {giga['rasters']} rasters (sieved change maps included) byte-equal "
        "to an unkilled run; phase s / peak RSS MiB: " + ", ".join(
            f"{p} {giga[p]['wall_s_total']:.1f} / {giga[p]['peak_rss_mib']}"
            for p in ("gen", "segment_resumed", "assemble", "sieve", "reference"))
        + f"; {legs['a']:.1f} s")

    # (d) the per-pixel oracle, the plain version on the host and the kernel
    t0 = time.perf_counter()
    ar = tool(env, tmp, "arch_speedup", str(ARCH_ORACLE_PX), str(ARCH_PLAIN_PX),
              "--card-px", str(POP_PX))
    legs["d"] = time.perf_counter() - t0
    card = ar["card"][-1]
    assert card["launches"] > 0 and 0 < card["fit_rate"] <= 1, ar
    log(f"[scale] (d) arch_speedup: oracle {ar['oracle_px_s']} px/s ({ARCH_ORACLE_PX} px, f64, "
        f"host), plain {ar['kernel_cpu_px_s']} px/s ({ARCH_PLAIN_PX} px, f32, "
        f"{ar['torch_threads']} host threads), kernel {card['px_s']} px/s ({card['px']} px, "
        f"{card['ms']} ms): card / oracle {ar['speedup_card_vs_oracle']}x ({smi}); "
        f"{legs['d']:.1f} s")
    out = {"launches": sum_launches({"LAUNCHES": resumed["launches"]},
                                    {"LAUNCHES": giga["reference"]["launches"]},
                                    {"LAUNCHES": card["launches"]}),
           "seconds": time.perf_counter() - t14}
    log(f"[phase 14] took {out['seconds']:.1f}s (a {legs['a']:.1f}, d {legs['d']:.1f}; b and c, "
        f"beside phase 12, {host_legs['b']:.1f} / {host_legs['c']:.1f}); launches "
        f"{json.dumps(out['launches'])} ({smi})")
    return out


def build_native() -> "str | None":
    """Build the host raster codec that the loaders, the feed and the writers
    use when it is present (``native/lt_native.cc`` with the flags of
    ``native/Makefile``) into the port's ``_build/``, and point
    ``LT_NATIVE_LIB`` at it for this process and the processes it starts.
    A working tree may hold ``native/liblt_native.so`` already; a checkout
    does not.  The pure-NumPy path gives the same bytes, so a failed build
    (no g++ or zlib) is logged and the smoke goes on without it."""
    src = os.path.join(ROOT, "native", "lt_native.cc")
    if not os.path.isfile(src) or shutil.which("g++") is None:
        return None
    out_dir = os.path.join(ROOT, "land_trendr_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "liblt_native.so")
    tmp = f"{lib}.{os.getpid()}.tmp"
    r = subprocess.run(
        ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-o", tmp, src,
         "-lz", "-pthread"], capture_output=True, text=True, timeout=300, check=False)
    if r.returncode != 0:
        log(f"[build] native codec not built (g++ exit {r.returncode}): {r.stderr[-400:]}")
        return None
    os.replace(tmp, lib)
    os.environ["LT_NATIVE_LIB"] = lib
    return lib


def main() -> int:
    # directories that live across phases are removed however the run ends
    with contextlib.ExitStack() as cleanup:
        return run_phases(cleanup)


def run_phases(cleanup: contextlib.ExitStack) -> int:
    """Every phase in order (the module docstring); ``cleanup`` holds what
    outlives a single phase."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1
    t_native = time.perf_counter()
    native_lib = build_native()
    sys.path.insert(0, ROOT)
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.io import native
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.ops.change import CHANGE_PRODUCTS, ChangeFilter
    from land_trendr_tpu_torch.ops.segment import (
        _select_and_assemble,
        torch_family_stats,
        torch_segment_pixels,
    )
    from land_trendr_tpu_torch.runtime import driver
    from land_trendr_tpu_torch.runtime.driver import (
        Run,
        RunCancelled,
        RunConfig,
        StallError,
        assemble_outputs,
        run_stack,
    )
    from land_trendr_tpu_torch.runtime.stack import load_stack_dir_c2, stack_from_synthetic
    from land_trendr_tpu_torch.tools import probe
    from land_trendr_tpu_torch.tools.pod_launch import launch_pod, reap

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    smi = nvidia_smi_line()
    log(f"nvidia-smi: {smi}")
    log(f"[build] native raster codec: {os.path.relpath(native_lib, ROOT) if native_lib else 'not built'}"
        f" ({time.perf_counter() - t_native:.1f} s)")
    params = LTParams()

    # phase 4's synthetic scene is host work: it is made while nvcc builds;
    # then phase 10's stack is made and written to disk, beside phase 2
    scene: dict = {}
    serve_root = cleanup.enter_context(tempfile.TemporaryDirectory(prefix="lt_smoke_serve_",
                                                                   dir=ROOT))
    serve_stack = os.path.join(serve_root, "stack")

    def make_scene():
        t0 = time.perf_counter()
        scene["stack"] = stack_from_synthetic(make_stack(SceneSpec(height=SCENE, width=SCENE)))
        scene["seconds"] = time.perf_counter() - t0

    def make_serve_stack():
        scene_thread.join()
        t0 = time.perf_counter()
        write_stack(serve_stack, make_stack(SceneSpec(height=SERVE, width=SERVE, seed=10)))
        scene["serve_seconds"] = time.perf_counter() - t0

    scene_thread = threading.Thread(target=make_scene, name="smoke-scene", daemon=True)
    scene_thread.start()
    serve_thread = threading.Thread(target=make_serve_stack, name="smoke-serve-stack",
                                    daemon=True)
    serve_thread.start()

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    info = segment_cuda.build_info(force=True)
    log(f"[build] segment_fused.cu built in {info['build_s']:.2f}s "
        f"(phase {time.perf_counter() - t0:.2f}s) -> {os.path.relpath(info['path'], ROOT)}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    for kind in ("fused", "family"):
        for dt in (torch.float32, torch.float64):
            occ = segment_cuda.occupancy(kind, dt, NY)
            log(f"[build] occupancy {kind} {occ['dtype']} at NY={NY}: block {occ['block']}, "
                f"{occ['smem_bytes']} B shared per block, {occ['blocks_per_sm']} blocks = "
                f"{occ['warps_per_sm']} warps per SM")

    # ---- phase 2: kernel against plain version --------------------------
    years_np, vals_np, mask_np = population(np.random.default_rng(20261016), POP_PX)
    years = torch.from_numpy(years_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    v32 = torch.from_numpy(vals_np.astype(np.float32)).to(dev)
    v64 = torch.from_numpy(vals_np).to(dev)

    k32 = segment_cuda.cuda_segment_pixels(years, v32, mask, params)
    p32 = torch_segment_pixels(years, v32, mask, params)
    torch.cuda.synchronize()
    agree32 = decisions(k32, p32)
    rate32 = float(agree32.float().mean())
    err32 = max_float_err(k32, p32, agree32)
    log(f"[kernel] f32 decision agreement {rate32:.6f} (floor {F32_FLOOR}), "
        f"max |float diff| on agreeing pixels {err32:.3e} (limit {F32_ATOL}), "
        f"all fields bit-identical there: {bit_identical(k32, p32, agree32)}")
    assert rate32 >= F32_FLOOR, f"f32 decision agreement {rate32} below {F32_FLOOR}"
    assert err32 <= F32_ATOL, f"f32 float disagreement {err32} above {F32_ATOL}"

    k64 = segment_cuda.cuda_segment_pixels(years, v64, mask, params)
    p64 = torch_segment_pixels(years, v64, mask, params)
    torch.cuda.synchronize()
    agree64 = decisions(k64, p64)
    n_bad64 = int((~agree64).sum())
    assert n_bad64 == 0, f"f64 decisions differ on {n_bad64} pixels"
    err64 = max_float_err(k64, p64, agree64)
    log(f"[kernel] f64 decisions differ on {n_bad64} of {POP_PX} pixels "
        f"(max |float diff| {err64:.3e}, limit {F64_ATOL})")
    assert err64 <= F64_ATOL, f"f64 float disagreement {err64} above {F64_ATOL}"
    fit_rate_pop = float(k32.model_valid.float().mean())

    report = probe.kernel_report(years, v32, mask, reps=20)
    log("[kernel] stage shares of the f32 kernel's per-thread cycles: " + ", ".join(
        f"{k} {100 * v:.1f}%" for k, v in report["stage_share"].items())
        + f" ({sum(report['cycles_per_px'].values()):.0f} cycles per pixel's thread)")
    log("[kernel] block-size sweep (f32 fused, ms): " + ", ".join(
        f"block {r['block']} {r['ms']:.4f} "
        f"({r['warps_per_sm']} warps/SM)" for r in report["block_sweep"]))
    job = segment_cuda._Launch(years, v32, mask, params)
    kernel_ms = cuda_ms(lambda: job.run(0, POP_PX), reps=20)
    wrapper_ms = cuda_ms(lambda: segment_cuda.cuda_segment_pixels(years, v32, mask, params), reps=20)
    plain_ms = cuda_ms(lambda: torch_segment_pixels(years, v32, mask, params), reps=2)
    plain64_ms = cuda_ms(lambda: torch_segment_pixels(years, v64, mask, params), reps=1)
    ops = segment_cuda.cuda_segment_op_counts(years, v32, mask, params)
    n_ops = int(ops.sum())
    n_bytes, f_bytes = bytes_bound(POP_PX, NY, params.max_vertices, params.max_segments)
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = n_ops / FP32_OPS_S * 1e3
    bound_ms, bound_by = bound_of(n_bytes, n_ops)
    log(f"[kernel] {POP_PX} px x {NY} yr f32: kernel {kernel_ms:.4f} ms "
        f"({POP_PX / kernel_ms / 1e3:.1f} M px/s), wrapper {wrapper_ms:.4f} ms, "
        f"plain {plain_ms:.2f} ms, plain f64 {plain64_ms:.2f} ms, fit rate {fit_rate_pop:.4f}")
    log(f"[kernel] bound: {n_bytes} B -> {bytes_ms:.4f} ms at 3.35 TB/s; "
        f"{n_ops} FP32 ops ({n_ops / POP_PX:.0f}/px, "
        f"p50 {int(ops.median())} max {int(ops.max())}, hand-counted per loop) -> "
        f"{ops_ms:.4f} ms at 67 TFLOP/s (the published FP32 rate, an FMA as two); "
        f"bound {bound_ms:.4f} ms by {bound_by}; kernel at "
        f"{100 * bound_ms / kernel_ms:.1f}% of it")
    # the narrow kernel against its time before the fit frame was centred,
    # which holds only on a card at the power limit it was measured at
    if smi.endswith(", 700.00 W"):
        log(f"[kernel] against {NARROW_REF_MS} ms before the centred fit frame: "
            f"{100 * (kernel_ms / NARROW_REF_MS - 1):+.2f}% (limit 5%)")
        assert kernel_ms <= 1.05 * NARROW_REF_MS, (kernel_ms, NARROW_REF_MS)
    else:
        log(f"[kernel] {smi}: the {NARROW_REF_MS} ms reference was taken at 700 W; not compared")

    # ---- phase 3: chunked against unchunked -----------------------------
    ch = segment_cuda.cuda_segment_pixels_chunked(years, v32, mask, params, chunk=CHUNK)
    torch.cuda.synchronize()
    agree_ch = decisions(ch, k32)
    assert bool(agree_ch.all()), f"chunked decisions differ on {int((~agree_ch).sum())} px"
    identical = all(torch.equal(getattr(ch, f), getattr(k32, f)) for f in ch._fields)
    log(f"[chunked] chunk {CHUNK}: decisions identical on all {POP_PX} px; "
        f"all fields bit-identical: {identical}")

    # ---- phase 3b: family kernel against its plain version --------------
    def family_err(k, p, agree):
        return max_pair_err((("despiked", k[0], p[0]), ("sses", k[2], p[2])), agree)

    f32 = segment_cuda.cuda_family_stats(years, v32, mask, params)
    pf32 = torch_family_stats(years, v32, mask, params)
    torch.cuda.synchronize()
    fagree32 = (f32[1] == pf32[1]).all(dim=(1, 2))
    frate32 = float(fagree32.float().mean())
    ferr32 = family_err(f32, pf32, fagree32)
    log(f"[family] f32 vertex sets agree on {frate32:.6f} of pixels (floor {F32_FLOOR}), "
        f"max |despiked/sse diff| there {ferr32:.3e} (limit {F32_ATOL}), "
        f"bit-identical there: {bit_identical(f32, pf32, fagree32)}")
    assert frate32 >= F32_FLOOR, f"f32 family vertex sets agree on {frate32}"
    assert ferr32 <= F32_ATOL, f"f32 family float disagreement {ferr32}"
    f64 = segment_cuda.cuda_family_stats(years, v64, mask, params)
    pf64 = torch_family_stats(years, v64, mask, params)
    torch.cuda.synchronize()
    fagree64 = (f64[1] == pf64[1]).all(dim=(1, 2))
    n_bad = int((~fagree64).sum())
    assert n_bad == 0, f"f64 family vertex sets differ on {n_bad} pixels"
    ferr64 = family_err(f64, pf64, fagree64)
    log(f"[family] f64 vertex sets equal on all {POP_PX} px, max |despiked/sse diff| "
        f"{ferr64:.3e} (limit {F64_ATOL}), bit-identical: {bit_identical(f64, pf64, fagree64)}")
    assert ferr64 <= F64_ATOL, f"f64 family float disagreement {ferr64}"
    # the family kernel + the plain tail on the card against the fused kernel
    tail64 = _select_and_assemble(years, v64, mask, *f64, params)
    n_bad = int((~decisions(tail64, k64)).sum())
    assert n_bad == 0, f"f64 family + tail decisions differ from the fused kernel on {n_bad} px"
    tail32 = _select_and_assemble(years, v32, mask, *f32, params)
    trate32 = float(decisions(tail32, k32).float().mean())
    log(f"[family] family kernel + plain tail vs fused kernel: f64 decisions identical on "
        f"all {POP_PX} px, f32 on {trate32:.6f}")
    assert trate32 >= F32_FLOOR, f"f32 family + tail decisions agree on {trate32}"
    fjob = segment_cuda._FamilyLaunch(years, v32, mask, params)
    fam_ms = cuda_ms(fjob.run, reps=20)
    fam_wrapper_ms = cuda_ms(lambda: segment_cuda.cuda_family_stats(years, v32, mask, params), reps=20)
    fam_plain_ms = cuda_ms(lambda: torch_family_stats(years, v32, mask, params), reps=2)
    fops = segment_cuda.cuda_family_op_counts(years, v32, mask, params)
    f_ops = int(fops.sum())
    f_bytes_ms = f_bytes / HBM_BYTES_S * 1e3
    f_ops_ms = f_ops / FP32_OPS_S * 1e3
    fam_bound_ms, fam_bound_by = bound_of(f_bytes, f_ops)
    log(f"[family] {POP_PX} px x {NY} yr f32: kernel {fam_ms:.4f} ms, wrapper "
        f"{fam_wrapper_ms:.4f} ms, plain {fam_plain_ms:.2f} ms")
    log(f"[family] bound: {f_bytes} B -> {f_bytes_ms:.4f} ms at 3.35 TB/s; {f_ops} FP32 ops "
        f"({f_ops / POP_PX:.0f}/px, p50 {int(fops.median())} max {int(fops.max())}) -> "
        f"{f_ops_ms:.4f} ms at 67 TFLOP/s; bound {fam_bound_ms:.4f} ms by {fam_bound_by}; "
        f"kernel at {100 * fam_bound_ms / fam_ms:.1f}% of it")
    del k32, p32, k64, p64, ch, job, v64, f32, pf32, f64, pf64, tail32, tail64, fjob

    # ---- phase 2c: the wide kernels against their plain versions --------
    wide = wide_kernels(dev, kernel_ms)

    # ---- phase 2d: the global forms against their plain versions ---------
    glob = global_kernels(dev, report["stage_share"])

    # ---- phase 4: scene through run_stack + assemble_outputs ------------
    t0 = time.perf_counter()
    scene_thread.join()
    assert "stack" in scene, "making phase 4's synthetic scene failed (its traceback is above)"
    stack, synth_s = scene["stack"], scene["seconds"]
    n_tiles = (SCENE // TILE) ** 2
    log(f"[scene] synthetic {SCENE}x{SCENE}x{stack.n_years} stack made in {synth_s:.1f}s "
        f"beside the build and phase 2 (waited {time.perf_counter() - t0:.1f}s for it)")
    log(f"[scene] host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} usable; "
        f"native gather library loaded: {native.available()}")
    with tempfile.TemporaryDirectory(prefix="lt_smoke_", dir=ROOT) as tmp:
        cfg = RunConfig(
            tile_size=TILE,
            workdir=os.path.join(tmp, "work"),
            out_dir=os.path.join(tmp, "out"),
        )
        segment_cuda.LAUNCHES = 0
        summary = run_stack(stack, cfg, device="cuda")
        launches = segment_cuda.LAUNCHES
        t0 = time.perf_counter()
        paths = assemble_outputs(stack, cfg)
        assemble_s = time.perf_counter() - t0
        scene_digests = raster_digests(cfg.out_dir)  # phase 9's reference
        with open(os.path.join(cfg.workdir, "manifest.jsonl")) as f:
            header = json.loads(f.readline())
        log(f"[scene] px_per_s {summary['px_per_s']} wall_s {summary['wall_s']} "
            f"fit_rate {summary['fit_rate']:.4f} tiles {summary['tiles_done']} "
            f"launches {launches} assemble_s {assemble_s:.2f} outputs {len(paths)}")
        log(f"[scene] stage_s {json.dumps(summary['stage_s'])}")
        log(f"[scene] upload {json.dumps(summary['upload'])}")
        log(f"[scene] fetch {json.dumps(summary['fetch'])}")
        log(f"[scene] HBM peak (the telemetry gauge's value) {summary['device_bytes_peak']} B, "
            f"torch max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
            f"retries {summary['retries']}, quarantined {summary['tiles_quarantined']}")
        assert summary["retries"] == 0 and summary["tiles_quarantined"] == [], summary
        assert summary["tiles_done"] == n_tiles, summary
        scene_px_s = [summary["px_per_s"]]
        assert launches == n_tiles, f"{launches} kernel launches for {n_tiles} tiles"
        assert header.get("context", {}).get("impl") == "cuda", header
        assert 0.0 < summary["fit_rate"] <= 1.0, summary["fit_rate"]
        assert summary["pixels"] == SCENE * SCENE, summary["pixels"]
        assert len(paths) == 11, sorted(paths)
        for rep in range(SCENE_REPEATS):
            work = os.path.join(tmp, f"work{rep}")
            again = run_stack(stack, dataclasses.replace(cfg, workdir=work), device="cuda")
            assert again["tiles_done"] == n_tiles, again
            assert again["retries"] == 0 and again["tiles_quarantined"] == [], again
            scene_px_s.append(again["px_per_s"])
            log(f"[scene] repeat {rep + 1}: px_per_s {again['px_per_s']} "
                f"wall_s {again['wall_s']} stage_s {json.dumps(again['stage_s'])}")
            shutil.rmtree(work)

    # ---- phase 4b: the scene with FTV + change --------------------------
    # its rasters stay until phase 13 (b) validates them against the oracle,
    # and its workdir until phase 14 (c) re-assembles it
    ftv_tmp = cleanup.enter_context(tempfile.TemporaryDirectory(prefix="lt_smoke_ftv_", dir=ROOT))
    cfg = RunConfig(
        tile_size=TILE,
        workdir=os.path.join(ftv_tmp, "work"),
        out_dir=os.path.join(ftv_tmp, "out"),
        ftv_indices=FTV,
        change_filt=ChangeFilter(max_dur=4.0),
    )
    segment_cuda.LAUNCHES = 0
    summary = run_stack(stack, cfg, device="cuda")
    tail_launches = segment_cuda.LAUNCHES
    t0 = time.perf_counter()
    paths = assemble_outputs(stack, cfg)
    assemble_s = time.perf_counter() - t0
    with open(os.path.join(cfg.workdir, "manifest.jsonl")) as f:
        header = json.loads(f.readline())
    log(f"[ftv+change] ftv {','.join(FTV)}, change max_dur 4: px_per_s "
        f"{summary['px_per_s']} wall_s {summary['wall_s']} fit_rate "
        f"{summary['fit_rate']:.4f} launches {tail_launches} assemble_s {assemble_s:.2f} "
        f"outputs {len(paths)}")
    log(f"[ftv+change] stage_s {json.dumps(summary['stage_s'])}")
    log(f"[ftv+change] fetch {json.dumps(summary['fetch'])}")
    log(f"[ftv+change] HBM peak (the telemetry gauge's value) "
        f"{summary['device_bytes_peak']} B; retries {summary['retries']}, "
        f"quarantined {summary['tiles_quarantined']}")
    assert summary["retries"] == 0 and summary["tiles_quarantined"] == [], summary
    assert summary["tiles_done"] == n_tiles, summary
    assert tail_launches == n_tiles, f"{tail_launches} kernel launches for {n_tiles} tiles"
    assert header.get("context", {}).get("impl") == "cuda", header
    assert 0.0 < summary["fit_rate"] <= 1.0, summary["fit_rate"]
    want = {f"ftv_{i}" for i in FTV} | {f"change_{k}" for k in CHANGE_PRODUCTS}
    assert want <= set(paths), sorted(want - set(paths))

    # ---- phase 5: the CLI ----------------------------------------------
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the CLI's synthetic stack, which phase 8's CLI reads too (no command
    # writes into it: each writes its workdir and rasters under its cwd)
    cli_stack = os.path.join(cleanup.enter_context(
        tempfile.TemporaryDirectory(prefix="lt_smoke_clistack_", dir=ROOT)), "D")
    with tempfile.TemporaryDirectory(prefix="lt_smoke_cli_", dir=ROOT) as tmp:
        def cli(*argv: str) -> str:
            out = subprocess.run(
                [sys.executable, "-m", "land_trendr_tpu_torch", *argv],
                cwd=tmp, env=env, capture_output=True, text=True, check=False, timeout=600,
            )
            if out.returncode != 0:
                raise RuntimeError(f"CLI {argv} exited {out.returncode}:\n{out.stderr[-3000:]}")
            return out.stdout

        def ftv_and_change() -> "tuple[dict, list]":
            tail = json.loads(cli("segment", cli_stack, "--ftv", "ndvi", "--change",
                                  "--change-mmu", "4", "--workdir", "w_tail", "--out-dir",
                                  "o_tail"))
            return tail, json.loads(cli("change", "o_tail", "--mmu", "4", "--dest",
                                        "c_tail"))["outputs"]

        cli("synth", cli_stack, "--size", "256")
        # the FTV and change commands (their own workdir and rasters) run
        # beside the first segment and its resume: checks, none of them timed
        with ThreadPoolExecutor(1) as pool:
            tail_fut = pool.submit(ftv_and_change)
            # the first segment through run_segment_measured: the CLI's own
            # output on stdout, this process's peak RSS on stderr
            measured = subprocess.run(
                [sys.executable, "-m", "land_trendr_tpu_torch.tools.run_segment_measured",
                 "segment", cli_stack], cwd=tmp, env=env, capture_output=True, text=True,
                timeout=600)
            assert measured.returncode == 0, measured.stderr[-3000:]
            first = json.loads(measured.stdout)["summary"]
            first_rss = json.loads(measured.stderr.strip().splitlines()[-1])["peak_rss_mib"]
            again = json.loads(cli("segment", cli_stack))["summary"]
            tail, maps = tail_fut.result()
        log(f"[cli] segment (run_segment_measured): tiles {first['tiles']} impl {first['impl']} "
            f"device {first['device']} fit_rate {first['fit_rate']:.4f}, peak RSS {first_rss} "
            f"MiB; resume skipped {again['tiles_skipped_resume']} of {again['tiles']}")
        assert first["impl"] == "cuda" and first["device"].startswith("cuda"), first
        assert first["tiles_done"] == first["tiles"], first
        assert again["tiles_skipped_resume"] == again["tiles"] and again["tiles_done"] == 0, again
        log(f"[cli] segment --ftv ndvi --change --change-mmu 4: impl {tail['summary']['impl']}, "
            f"{len(tail['outputs'])} rasters; change --mmu 4: {len(maps)} rasters")
        assert tail["summary"]["impl"] == "cuda", tail["summary"]
        assert {"ftv_ndvi", "change_mask", "change_yod"} <= set(tail["outputs"]), tail["outputs"]
        assert sorted(maps) == sorted(CHANGE_PRODUCTS), maps

    # ---- phase 6: the stage probe (the family kernel's path) ------------
    segment_cuda.LAUNCHES = 0
    segment_cuda.FAMILY_LAUNCHES = 0
    stages = probe.stages(POP_PX, "cuda", reps=PROBE_REPS)
    family_launches = segment_cuda.FAMILY_LAUNCHES
    log(f"[probe] family kernel launches {family_launches}, fused {segment_cuda.LAUNCHES}")
    print(json.dumps(stages), flush=True)
    assert family_launches > 0, "the stage probe never launched the family kernel"
    segment_cuda.WIDE_LAUNCHES = 0
    segment_cuda.WIDE_FAMILY_LAUNCHES = 0
    wide_stages = probe.stages(65_536, "cuda", reps=PROBE_REPS, ny=72)
    wide_family_launches = segment_cuda.WIDE_FAMILY_LAUNCHES
    log(f"[probe] at 72 years: wide family kernel launches {wide_family_launches}, wide fused "
        f"{segment_cuda.WIDE_LAUNCHES}")
    print(json.dumps(wide_stages), flush=True)
    assert wide_family_launches > 0, "the 72-year stage probe never launched the wide family kernel"
    segment_cuda.GLOBAL_LAUNCHES = 0
    segment_cuda.GLOBAL_FAMILY_LAUNCHES = 0
    global_stages = probe.stages(GLOBAL_PX, "cuda", reps=2, ny=160)
    global_family_launches = segment_cuda.GLOBAL_FAMILY_LAUNCHES
    log(f"[probe] at 160 years: global family kernel launches {global_family_launches}, "
        f"global fused {segment_cuda.GLOBAL_LAUNCHES}")
    print(json.dumps(global_stages), flush=True)
    assert global_family_launches > 0, (
        "the 160-year stage probe never launched the global family kernel")

    # ---- phase 7: robustness on the card --------------------------------
    t7 = time.perf_counter()
    rstack = stack_from_synthetic(make_stack(SceneSpec(height=ROBUST, width=ROBUST, seed=7)))
    r_tiles = (ROBUST // ROBUST_TILE) ** 2
    with tempfile.TemporaryDirectory(prefix="lt_smoke_robust_", dir=ROOT) as tmp:
        def rcfg(name, **kw):
            kw.setdefault("retry_backoff_s", 0.0)
            return RunConfig(tile_size=ROBUST_TILE, workdir=os.path.join(tmp, name, "w"),
                             out_dir=os.path.join(tmp, name, "o"), **kw)

        clean = rcfg("clean")
        segment_cuda.LAUNCHES = 0
        s_clean = run_stack(rstack, clean, device="cuda")
        assert segment_cuda.LAUNCHES == r_tiles and s_clean["retries"] == 0, s_clean
        assemble_outputs(rstack, clean)
        clean_bytes = raster_bytes(clean.out_dir)

        # (a) every host seam once; the record fault is the last tile's
        sched = "seed=1,feed@2,dispatch@5,compute.wait@8,fetch.wait@11,manifest.record@15"
        faulty = rcfg("faults", max_retries=2, fault_schedule=sched)
        segment_cuda.LAUNCHES = 0
        run = Run(rstack, faulty, device="cuda")
        try:
            run.execute()
            raise AssertionError("the manifest.record fault did not stop the run")
        except OSError as e:
            assert "manifest.record#15" in str(e), e
        fault_launches = segment_cuda.LAUNCHES
        segment_cuda.LAUNCHES = 0
        resumed = run_stack(rstack, rcfg("faults", max_retries=2), device="cuda")
        resume_launches = segment_cuda.LAUNCHES
        assert resumed["tiles_done"] == 1 and resumed["tiles_skipped_resume"] == r_tiles - 1
        redispatches = 2  # the compute.wait and the fetch.wait fault each re-dispatch once
        assert run.progress["retries"] == 4, run.progress
        assert fault_launches + resume_launches == r_tiles + redispatches + 1, (
            fault_launches, resume_launches)
        assemble_outputs(rstack, faulty)
        assert raster_bytes(faulty.out_dir) == clean_bytes, "fault-run rasters differ"
        log(f"[robust] faults {sched}: retries {run.progress['retries']}, launches "
            f"{fault_launches} + {resume_launches} (resume of the last tile) = {r_tiles} tiles + "
            f"{redispatches} re-dispatches + 1; rasters byte-equal to the clean run's")

        # (b) one tile fails its dispatch three times: quarantined
        quar = rcfg("quar", max_retries=2, quarantine_tiles=True,
                    fault_schedule="seed=1,dispatch@4*3")
        segment_cuda.LAUNCHES = 0
        s_q = run_stack(rstack, quar, device="cuda")
        assert s_q["tiles_quarantined"] == [4], s_q["tiles_quarantined"]
        assert segment_cuda.LAUNCHES == r_tiles - 1 and s_q["retries"] == 2
        log(f"[robust] quarantine: tiles_quarantined {s_q['tiles_quarantined']}, "
            f"launches {segment_cuda.LAUNCHES}, pixels {s_q['pixels']}")

        # (c) the device spins ~6 s before one tile's event: StallError
        real_dispatch = driver.process_tile_dn
        n_calls = [0]

        def spin_third_tile(*a, **kw):
            out = real_dispatch(*a, **kw)
            n_calls[0] += 1
            if n_calls[0] == 3:
                torch.cuda._sleep(STALL_CYCLES)
            return out

        driver.process_tile_dn = spin_third_tile
        t0 = time.perf_counter()
        try:
            run_stack(rstack, rcfg("stall", stall_timeout_s=2.0), device="cuda")
            raise AssertionError("the stall did not raise StallError")
        except StallError as e:
            stall_s = time.perf_counter() - t0
            log(f"[robust] stall: StallError after {stall_s:.2f}s ({e})")
        finally:
            driver.process_tile_dn = real_dispatch
        assert stall_s < 4.0, f"StallError took {stall_s:.2f}s"
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        log(f"[robust] stall: the spin drained {time.perf_counter() - t0:.2f}s later")

        # (d) cancel after the third durable tile, then resume
        cancel = threading.Event()
        durable = []

        def on_durable(t, arrays, meta):
            durable.append(t.tile_id)
            if len(durable) == 3:
                cancel.set()

        canc = rcfg("cancel")
        try:
            Run(rstack, canc, device="cuda", cancel=cancel, on_tile_durable=on_durable).execute()
            raise AssertionError("the cancel did not raise RunCancelled")
        except RunCancelled:
            pass
        rest = run_stack(rstack, canc, device="cuda")
        assert rest["tiles_skipped_resume"] == len(durable), (rest, durable)
        assert rest["tiles_done"] == r_tiles - len(durable)
        assemble_outputs(rstack, canc)
        assert raster_bytes(canc.out_dir) == clean_bytes, "cancel + resume rasters differ"
        log(f"[robust] cancel: {len(durable)} tiles durable at the cancel, resume did "
            f"{rest['tiles_done']}; rasters byte-equal")
    del rstack
    log(f"[robust] phase 7 took {time.perf_counter() - t7:.1f}s")

    # ---- phase 8: composite, telemetry and trace ------------------------
    t8 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lt_smoke_c2_", dir=ROOT) as tmp:
        arc = os.path.join(tmp, "c2")
        synth = make_stack(SceneSpec(height=ROBUST, width=ROBUST, seed=9))
        n_acq = write_multidate_c2(arc, synth, np.random.default_rng(9))
        del synth
        t0 = time.perf_counter()
        on_card = load_stack_dir_c2(arc, bands=("nir", "swir2"), composite="medoid",
                                    device="cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = load_stack_dir_c2(arc, bands=("nir", "swir2"), composite="medoid",
                                   device="cpu")
        cpu_s = time.perf_counter() - t0
        for b in ("nir", "swir2"):
            assert np.array_equal(on_card.dn_bands[b], on_cpu.dn_bands[b]), b
        assert np.array_equal(on_card.qa, on_cpu.qa)
        ccfg = RunConfig(tile_size=256, workdir=os.path.join(tmp, "w"),
                         out_dir=os.path.join(tmp, "o"))
        segment_cuda.LAUNCHES = 0
        s_c = run_stack(on_card, ccfg, device="cuda")
        assert segment_cuda.LAUNCHES == 4 and s_c["tiles_done"] == 4 and s_c["retries"] == 0
        log(f"[composite] {ROBUST}x{ROBUST} archive, {on_card.n_years} years, {n_acq} "
            f"acquisitions: medoid load on the card {card_s:.2f}s (CPU {cpu_s:.2f}s, load "
            f"and decode included), byte-equal to the CPU's; segmented: fit_rate "
            f"{s_c['fit_rate']:.4f}, px_per_s {s_c['px_per_s']}")
        del on_card, on_cpu

    with tempfile.TemporaryDirectory(prefix="lt_smoke_tel_", dir=ROOT) as tmp:
        tcfg = RunConfig(tile_size=TILE, workdir=os.path.join(tmp, "w"),
                         out_dir=os.path.join(tmp, "o"), telemetry=True, flight=True,
                         sampler_interval_s=0.5)
        segment_cuda.LAUNCHES = 0
        s_t = run_stack(stack, tcfg, device="cuda")
        assert segment_cuda.LAUNCHES == n_tiles and s_t["retries"] == 0
        with open(s_t["telemetry"]["events"]) as f:
            evs = [json.loads(line) for line in f]
        done_ids = sorted(r["tile_id"] for r in evs if r["ev"] == "tile_done")
        assert done_ids == list(range(n_tiles)), done_ids
        assert os.path.getsize(s_t["telemetry"]["flight"]) > 0
        hbm_peak = prom_gauge(s_t["telemetry"]["metrics"], "lt_device_bytes_peak")
        assert hbm_peak == s_t["device_bytes_peak"], (hbm_peak, s_t["device_bytes_peak"])
        log(f"[telemetry] telemetry+flight: px_per_s {s_t['px_per_s']} (phase 4 runs "
            f"{scene_px_s}), {len(done_ids)} tile_done events, flight.jsonl "
            f"{os.path.getsize(s_t['telemetry']['flight'])} B, HBM peak gauge "
            f"lt_device_bytes_peak {hbm_peak:.0f} B")
        # the compute-wait poll against a blocking wait, alternating
        from land_trendr_tpu_torch.runtime import fetch as fetchmod

        poll_wait = fetchmod.wait_event
        rates = {"poll": [], "synchronize": []}
        for rep in range(WAIT_REPS):
            for mode in ("poll", "synchronize"):
                fetchmod.wait_event = poll_wait if mode == "poll" else (
                    lambda ev: ev.synchronize())
                try:
                    s_w = run_stack(stack, dataclasses.replace(
                        tcfg, telemetry=False, flight=False,
                        workdir=os.path.join(tmp, f"{mode}{rep}")), device="cuda")
                finally:
                    fetchmod.wait_event = poll_wait
                rates[mode].append(s_w["px_per_s"])
        log(f"[telemetry] compute/fetch wait px_per_s: poll {rates['poll']}, "
            f"blocking synchronize {rates['synchronize']}")
        # the device's busy share of the scene run: union of the kernel
        # intervals in a profiler trace over the run's wall
        from land_trendr_tpu_torch.utils.profiling import trace

        tdir = os.path.join(tmp, "trace")
        with trace(tdir):
            s_p = run_stack(stack, dataclasses.replace(
                tcfg, telemetry=False, flight=False, workdir=os.path.join(tmp, "traced")),
                device="cuda")
        with open(os.path.join(tdir, os.listdir(tdir)[0])) as f:
            evs = json.load(f)["traceEvents"]
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs if e.get("cat") == "kernel")
        busy, end = 0.0, float("-inf")
        for t0_us, t1_us in spans:
            busy += max(0.0, t1_us - max(t0_us, end))
            end = max(end, t1_us)
        fused_us = sum(e["dur"] for e in evs
                       if e.get("cat") == "kernel" and "segment_fused_kernel" in e["name"])
        log(f"[telemetry] profiled NBR run: wall {s_p['wall_s']} s, px_per_s "
            f"{s_p['px_per_s']}, {len(spans)} kernels, device busy {busy / 1e6:.4f} s "
            f"= {100 * busy / 1e6 / s_p['wall_s']:.2f}% of wall (idle "
            f"{100 - 100 * busy / 1e6 / s_p['wall_s']:.2f}%), segment_fused_kernel "
            f"{fused_us / 1e3:.3f} ms in total")

    with tempfile.TemporaryDirectory(prefix="lt_smoke_cli8_", dir=ROOT) as tmp:
        def cli8(*argv: str) -> str:
            out = subprocess.run(
                [sys.executable, "-m", "land_trendr_tpu_torch", *argv],
                cwd=tmp, env=env, capture_output=True, text=True, check=False, timeout=600,
            )
            if out.returncode != 0:
                raise RuntimeError(f"CLI {argv} exited {out.returncode}:\n{out.stderr[-3000:]}")
            return out.stdout

        # the two `pixel` calls read the stack only: they run beside the
        # traced segment and `info` (checks, none of them timed)
        pixels = ((10, 20), (24, 0))  # (10, 20) fits no model; (24, 0) is disturbed
        with ThreadPoolExecutor(len(pixels)) as pool:
            pix_futs = [pool.submit(cli8, "pixel", "--from-stack", cli_stack, "--x", str(x),
                                    "--y", str(y), "--engine", "both") for x, y in pixels]
            traced = json.loads(cli8("segment", cli_stack, "--trace", "T", "--out-overviews",
                                     "2"))
            path = traced["outputs"]["rmse"]
            info = json.loads(cli8("info", path))[path]
            pix_out = [json.loads(f.result()) for f in pix_futs]
        names = set()
        for fn in os.listdir(os.path.join(tmp, "T")):
            with open(os.path.join(tmp, "T", fn)) as f:
                names |= {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
        kernels = sorted(n for n in names if "segment_fused_kernel" in n)
        assert kernels, "the trace does not name segment_fused_kernel"
        log(f"[cli] segment --trace --out-overviews 2: impl {traced['summary']['impl']}, trace "
            f"names {kernels[0][:90]}; lt_ ranges in the trace: "
            f"{sorted(n for n in names if n.startswith('lt_'))}")
        for (x, y), pix in zip(pixels, pix_out):
            assert pix["parity"]["vertex_years_equal"], pix["parity"]
            assert pix["parity"]["model_valid_equal"] and pix["torch"]["device"].startswith("cuda")
            log(f"[cli] pixel ({x}, {y}) --engine both: model_valid "
                f"{pix['oracle']['model_valid']}, vertex years oracle "
                f"{pix['oracle']['vertex_years']} kernel {pix['torch']['vertex_years']} "
                f"({pix['torch']['dtype']} on {pix['torch']['device']})")
        assert pix["oracle"]["model_valid"], "the disturbed pixel fit no model"
        assert info["overview_pages"] == 2, info
        log(f"[cli] info {path}: {info['height']}x{info['width']} {info['dtype']} "
            f"{info['compression']}, {info['overview_pages']} overview pages, "
            f"{info['file_bytes']} B")
    log(f"[phase 8] took {time.perf_counter() - t8:.1f}s")

    # ---- phase 9: elastic, pod, mesh and tuning -------------------------
    t9 = time.perf_counter()
    from land_trendr_tpu_torch.io.synthetic import write_stack
    from land_trendr_tpu_torch.ops.indices import required_bands
    from land_trendr_tpu_torch.parallel import make_mesh, segment_pixels_sharded
    from land_trendr_tpu_torch.runtime.leases import LeaseQueue
    from land_trendr_tpu_torch.runtime.manifest import TileManifest
    from land_trendr_tpu_torch.runtime.stack import load_stack_dir

    def leg(name: str, wall_s: float, px: int, summary: "dict | None" = None) -> None:
        stages = f", stage_s {json.dumps(summary['stage_s'])}" if summary else ""
        log(f"[phase 9] {name}: {wall_s:.3f} s, {px / wall_s:.1f} px/s{stages} ({smi})")

    with tempfile.TemporaryDirectory(prefix="lt_smoke_p9_", dir=ROOT) as tmp:
        def scfg(name, **kw):
            return RunConfig(tile_size=TILE, workdir=os.path.join(tmp, name, "w"),
                             out_dir=os.path.join(tmp, name, "o"), **kw)

        # (a) elastic at full tile size; the TTL sits far above the first
        # tile's library load, so nothing is stolen by accident
        ecfg = scfg("elastic", lease_batch=2, lease_ttl_s=600.0)
        segment_cuda.LAUNCHES = 0
        s_e = run_stack(stack, ecfg, device="cuda")
        e_launches = segment_cuda.LAUNCHES
        assert s_e["lease"]["acquired"] == n_tiles and s_e["lease"]["stolen"] == 0, s_e["lease"]
        assert e_launches == n_tiles, e_launches
        leg(f"elastic lease_batch=2 ({n_tiles} tiles leased, {e_launches} launches)",
            s_e["wall_s"], s_e["pixels"], s_e)
        # ... then a peer that died holding four leases: the lease.expire
        # seam reads its live leases as expired, so this run steals them
        xcfg = scfg("steal", lease_batch=2, lease_ttl_s=600.0,
                    fault_schedule="seed=1,lease.expire%1.0")
        peer_manifest = TileManifest(xcfg.workdir, xcfg.fingerprint(stack),
                                     context={"mesh_devices": 1, "impl": "cuda"})
        peer_manifest.open(resume=True)  # writes the header the peer leased under
        dead = LeaseQueue(peer_manifest.path, range(n_tiles),
                          ttl_s=600.0, owner="deadhost:1:peer")
        assert len(dead.acquire(4)) == 4
        segment_cuda.LAUNCHES = 0
        s_x = run_stack(stack, xcfg, device="cuda")
        x_launches = segment_cuda.LAUNCHES
        assert s_x["lease"]["stolen"] == 4 and s_x["lease"]["acquired"] == n_tiles, s_x["lease"]
        assert x_launches == n_tiles, x_launches
        leg(f"elastic with a dead peer's 4 leases stolen ({x_launches} launches)",
            s_x["wall_s"], s_x["pixels"], s_x)

        # (c) mesh: the sharded kernel against the unsharded one, bit for bit
        log(f"[mesh] torch.cuda.device_count() = {torch.cuda.device_count()}; a mesh over "
            "more than one card is not verifiable on a one-card machine — the two-shard "
            "mesh below repeats cuda:0")
        whole = segment_cuda.cuda_segment_pixels(years, v32, mask, params)
        every = torch.ones(POP_PX, dtype=torch.bool)
        for mesh in (make_mesh(), [dev, dev]):
            segment_cuda.LAUNCHES = 0
            sharded = segment_pixels_sharded(years, v32, mask, params, mesh=mesh)
            assert segment_cuda.LAUNCHES == len(mesh), segment_cuda.LAUNCHES
            assert bit_identical(sharded, type(whole)(*(f.cpu() for f in whole)), every), (
                f"sharded over {mesh} differs from the unsharded kernel")
            log(f"[mesh] segment_pixels_sharded over {[str(d) for d in mesh]}: "
                f"{segment_cuda.LAUNCHES} launches, bit-identical to the unsharded kernel")
        del whole, sharded
        mcfg = scfg("mesh")
        segment_cuda.LAUNCHES = 0
        s_m = run_stack(stack, mcfg, device="cuda", mesh=[dev, dev])
        m_launches = segment_cuda.LAUNCHES
        assert s_m["mesh_devices"] == 2 and m_launches == 2 * n_tiles, (s_m["mesh_devices"], m_launches)
        leg(f"two-shard mesh [cuda:0, cuda:0] ({m_launches} launches)", s_m["wall_s"],
            s_m["pixels"], s_m)

        # the three scene runs' rasters against phase 4's, assembled together
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as ex:
            list(ex.map(lambda c: assemble_outputs(stack, c), (ecfg, xcfg, mcfg)))
        for name, c in (("elastic", ecfg), ("steal", xcfg), ("mesh", mcfg)):
            assert raster_digests(c.out_dir) == scene_digests, f"{name} rasters differ from phase 4"
        log(f"[phase 9] elastic, steal and mesh rasters byte-equal to phase 4's "
            f"(assembled in {time.perf_counter() - t0:.1f} s)")

        # (b) pods on the one card over phase 7's stack written to disk
        synth = make_stack(SceneSpec(height=ROBUST, width=ROBUST, seed=7))
        stack_dir = os.path.join(tmp, "stack512")
        write_stack(stack_dir, synth)
        del synth
        pstack = load_stack_dir(stack_dir, bands=required_bands("nbr"))
        pod_px = ROBUST * ROBUST

        def pcfg(name, **kw):
            kw.setdefault("tile_size", ROBUST_TILE)
            return RunConfig(workdir=os.path.join(tmp, name, "w"),
                             out_dir=os.path.join(tmp, name, "o"), **kw)

        one = pcfg("single")
        s_1 = run_stack(pstack, one, device="cuda")
        assemble_outputs(pstack, one)
        pod_ref = raster_digests(one.out_dir)
        leg("512^2 single process (the pods' reference)", s_1["wall_s"], s_1["pixels"])

        static = pcfg("pod")
        outs = [os.path.join(tmp, f"pod{i}.json") for i in range(2)]
        t0 = time.perf_counter()
        launch_pod(lambda coord, i: [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                                     "--pod-worker", coord, "2", str(i), stack_dir,
                                     static.workdir, outs[i]],
                   env, before_attempt=lambda: shutil.rmtree(static.workdir, ignore_errors=True))
        pod_s = time.perf_counter() - t0
        per = []
        for o in outs:
            with open(o) as f:
                per.append(json.load(f))
        assert [s["tiles_done"] for s in per] == [8, 8], [s["tiles_done"] for s in per]
        assert [s["launches"] for s in per] == [8, 8], [s["launches"] for s in per]
        hosts = per[0]["telemetry"]["hosts"]
        assert [h["process_index"] for h in hosts] == [0, 1], hosts
        assert all(h["status"] == "ok" for h in hosts), hosts
        assert "hosts" not in per[1]["telemetry"], "the fold is the primary's only"
        assemble_outputs(pstack, static)
        assert raster_digests(static.out_dir) == pod_ref, "pod rasters differ"
        leg("two-process pod under init_distributed (8 + 8 tiles, hosts fold ok, byte-equal)",
            pod_s, pod_px)

        lease_work = os.path.join(tmp, "leasecli", "w")
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "land_trendr_tpu_torch", "segment", stack_dir,
                 "--tile-size", str(ROBUST_TILE), "--workdir", lease_work,
                 "--out-dir", os.path.join(tmp, "leasecli", f"o{i}"),
                 "--lease-batch", "2", "--lease-ttl-s", "600"],
                cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)
        ]
        results = reap(procs, timeout=600)
        lease_s = time.perf_counter() - t0
        won = [json.loads(out)["summary"]["lease"]["acquired"] for out, _ in results]
        assert sum(won) == (ROBUST // ROBUST_TILE) ** 2, won
        for i in range(2):
            assert raster_digests(os.path.join(tmp, "leasecli", f"o{i}")) == pod_ref, (
                f"lease CLI process {i} rasters differ")
        leg(f"two `segment --lease-batch 2` processes, no process group (tiles won {won}, "
            "byte-equal)", lease_s, pod_px)

        # (d) tuning: probe, reload with zero probes, then "auto" knobs
        store = os.path.join(tmp, "tune_store")

        def cli9(*argv: str) -> dict:
            out = subprocess.run(
                [sys.executable, "-m", "land_trendr_tpu_torch", *argv],
                cwd=tmp, env=env, capture_output=True, text=True, check=False, timeout=600,
            )
            if out.returncode != 0:
                raise RuntimeError(f"CLI {argv} exited {out.returncode}:\n{out.stderr[-3000:]}")
            return json.loads(out.stdout)

        shape = f"{ROBUST},{ROBUST},{NY}"
        t0 = time.perf_counter()
        prof = cli9("tune", "--smoke", "--store-dir", store, "--shape", shape)
        tune_s = time.perf_counter() - t0
        assert prof["source"] == "probed" and prof["probes"] > 0, prof
        assert all(g["ok"] for g in prof["groups"].values()), prof["groups"]
        log(f"[tune] probed {prof['probes']} reps in {tune_s:.1f} s: key {prof['key']!r}, "
            f"knobs {json.dumps(prof['knobs'])}")
        log(f"[tune] groups {json.dumps(prof['groups'])}")
        again = cli9("tune", "--smoke", "--store-dir", store, "--shape", shape)
        assert again["source"] == "store" and again["probes"] == 0, again
        assert again["knobs"] == prof["knobs"] and again["key"] == prof["key"]
        log(f"[tune] second call: source {again['source']}, probes {again['probes']}")
        auto = cli9("segment", stack_dir, "--workdir", "w_auto", "--out-dir", "o_auto",
                    "--tile-size", "auto", "--chunk-px", "auto", "--fetch-depth", "auto",
                    "--tune-store-dir", store)["summary"]
        tune_blk = auto["tune"]
        assert tune_blk["source"] == "store" and tune_blk["key"] == prof["key"], tune_blk
        knobs = {k: prof["knobs"][k] for k in ("tile_size", "chunk_px", "fetch_depth")}
        assert tune_blk["knobs"] == knobs, (tune_blk, knobs)
        explicit = pcfg("explicit", **knobs)
        run_stack(pstack, explicit, device="cuda")
        assemble_outputs(pstack, explicit)
        assert raster_digests(os.path.join(tmp, "o_auto")) == raster_digests(explicit.out_dir), (
            "the auto run's rasters differ from the explicit run's")
        leg(f"segment with auto knobs {json.dumps(knobs)} (tune block names {tune_blk['key']!r}; "
            "rasters equal the explicit run's)", auto["wall_s"], auto["pixels"])
        # the dispatch probe in full mode, in this process so its launches
        # count: the tile-size sweep runs the tile program per tile, the
        # chunk_px sweep the chunked kernel (one launch per chunk)
        from land_trendr_tpu_torch.tune import KNOB_DEFAULTS
        from land_trendr_tpu_torch.tune import probes as probemod

        segment_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        d_best, d_rep = probemod.probe_group("dispatch", reps=3, smoke=False,
                                             defaults=KNOB_DEFAULTS, device=dev)
        d_launches = segment_cuda.LAUNCHES
        assert d_launches > 0 and d_rep["best_s"] <= d_rep["default_s"], d_rep
        log(f"[tune] dispatch probe, full mode: {d_launches} fused-kernel launches in "
            f"{time.perf_counter() - t0:.2f} s, {d_rep['probes']} timed reps, knobs "
            f"{json.dumps(d_best)}, timings {json.dumps(d_rep['timings'])} ({smi})")
        del pstack
    log(f"[phase 9] took {time.perf_counter() - t9:.1f}s")

    # ---- phases 10 and 11: serve, then route and load, on the card -------
    t0 = time.perf_counter()
    serve_thread.join()
    assert "serve_seconds" in scene, "writing phase 10's stack failed (its traceback is above)"
    log(f"[serve] {SERVE}^2 x {NY} stack made and written in {scene['serve_seconds']:.1f} s "
        f"beside the earlier phases (waited {time.perf_counter() - t0:.1f} s for it)")
    served = serve_phase(dev, smi, env, serve_root, serve_stack)
    routed = route_phase(smi, env, serve_root, served["stack_dir"])
    # ---- phase 12: the port's tools on the card -------------------------
    tools_tmp = os.path.join(serve_root, "tools")
    os.makedirs(tools_tmp)
    scale_tmp = os.path.join(serve_root, "scale")
    os.makedirs(scale_tmp)
    # phase 14 (b) and (c) run beside phase 12 (a)-(c)
    scale_run = start_scale_host_legs(env, scale_tmp, ftv_tmp, stack)
    cleanup.callback(stop_scale_host_legs, scale_run)
    tooled = tools_phase(smi, env, tools_tmp, routed["rt"], scale_run, ftv_tmp)
    # ---- phase 13: the oracle, the FTV rasters and the perf gate ---------
    gated = gate_phase(smi, env, tools_tmp, stack, os.path.join(ftv_tmp, "out"))
    # ---- phase 14: the scale tools at smoke size ------------------------
    scaled = scale_phase(smi, env, scale_tmp, tooled["scale_host"])
    del stack
    serve_launches = served["cold_launches"] + served["warm_launches"] + served["flood_launches"]
    # phases 12 and 13: their own process (parity, identity, paramspace)
    # and the tools' and the gate's; phase 14: the scale tools'
    tool_launches = sum_launches(tooled["own"], tooled["tools"], gated["launches"],
                                 scaled["launches"])

    src = "land_trendr_tpu_torch/csrc/segment_fused.cu"
    kernel = {
        "name": "segment_fused",
        "route": "cuda",
        "source": src,
        "replaces": "land_trendr_tpu/ops/segment_pallas.py:1027",
        # the narrow kernel's paths: phase 4's scene, phase 10's serve jobs
        # and phase 11's routed jobs (counted in the replicas); phases 12
        # to 14's tools run other shapes and stand apart, under "tools"
        "launches": launches + serve_launches + routed["route_launches"],
        "launches_by_path": {"segment": launches, "serve": serve_launches,
                             "route": routed["route_launches"],
                             "tools": tool_launches["LAUNCHES"]},
        "max_abs_err": err32,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "wrapper_ms": wrapper_ms,
    }
    w72, w18 = wide["fused_ny72"], wide["fused_nc18"]
    kernel_wide = {
        "name": "segment_fused (wide: 128 years, 32 candidates)",
        "route": "cuda",
        "source": src,
        "replaces": "land_trendr_tpu/ops/segment_pallas.py:1027",
        # the 18-candidate serve job of phase 10 (c); phase 12's NY = 72
        # identity run stands apart, under "tools"
        "launches": served["wide_launches"],
        "launches_by_path": {"serve": served["wide_launches"],
                             "tools": tool_launches["WIDE_LAUNCHES"]},
        "max_abs_err": max(w72["max_abs_err"], w18["max_abs_err"]),
        "ms": w72["ms"],
        "plain_ms": w72["plain_ms"],
        "bound_ms": w72["bound_ms"],
        "bound_by": w72["bound_by"],
        "library_ms": None,
        "shape": "262,144 px x 72 years f32",
        "ms_18_candidates": w18["ms"],
        "plain_ms_18_candidates": w18["plain_ms"],
        "bound_ms_18_candidates": w18["bound_ms"],
    }
    family = {
        "name": "family_stats",
        "route": "cuda",
        "source": src,
        "replaces": "land_trendr_tpu/ops/segment_pallas.py:938",
        "launches": family_launches,
        "max_abs_err": ferr32,
        "ms": fam_ms,
        "plain_ms": fam_plain_ms,
        "bound_ms": fam_bound_ms,
        "bound_by": fam_bound_by,
        "library_ms": None,
        "wrapper_ms": fam_wrapper_ms,
    }
    fw = wide["family_ny72"]
    family_wide = {
        "name": "family_stats (wide: 128 years, 32 candidates)",
        "route": "cuda",
        "source": src,
        "replaces": "land_trendr_tpu/ops/segment_pallas.py:938",
        # the 72-year stage probe of phase 6
        "launches": wide_family_launches,
        "max_abs_err": fw["max_abs_err"],
        "ms": fw["ms"],
        "plain_ms": fw["plain_ms"],
        "bound_ms": fw["bound_ms"],
        "bound_by": fw["bound_by"],
        "library_ms": None,
        "shape": "262,144 px x 72 years f32",
    }
    g160, g40 = glob["fused_ny160"], glob["fused_nc40"]
    kernel_global = {
        "name": "segment_fused (global: any years and candidates)",
        "route": "cuda",
        "source": src,
        "replaces": "land_trendr_tpu/ops/segment_pallas.py:1027",
        # the 40-candidate serve job of phase 10 (g); phase 12's NY = 160
        # identity run stands apart, under "tools"
        "launches": served["global_launches"],
        "launches_by_path": {"serve": served["global_launches"],
                             "tools": tool_launches["GLOBAL_LAUNCHES"]},
        "max_abs_err": max(g160["max_abs_err"], g40["max_abs_err"]),
        "ms": g160["ms"],
        "plain_ms": g160["plain_ms"],
        "bound_ms": g160["bound_ms"],
        "bound_by": g160["bound_by"],
        "library_ms": None,
        "shape": f"{GLOBAL_PX:,} px x 160 years f32",
        "ms_f64": g160["ms_f64"],
        "scratch_bytes": g160["scratch_bytes"],
        "bound_ms_with_scratch": g160["bound_ms_with_scratch"],
        "ms_40_candidates": g40["ms"],
        "ms_40_candidates_f64": g40["ms_f64"],
        "plain_ms_40_candidates": g40["plain_ms"],
        "bound_ms_40_candidates": g40["bound_ms"],
        "ms_forced_at_40_years": glob["forced_ms"],
        "forced_ratio_to_narrow": glob["forced_ms"] / glob["forced_narrow_ms"],
        "ms_scratch_tier": glob["scratch_tier"]["float32"]["ms"],
        "scratch_tier_shape": f"{SCRATCH_PX:,} px x {SCRATCH_NY} years f32",
    }
    gf = glob["family_ny160"]
    family_global = {
        "name": "family_stats (global: any years and candidates)",
        "route": "cuda",
        "source": src,
        "replaces": "land_trendr_tpu/ops/segment_pallas.py:938",
        # the 160-year stage probe of phase 6
        "launches": global_family_launches,
        "max_abs_err": gf["max_abs_err"],
        "ms": gf["ms"],
        "plain_ms": gf["plain_ms"],
        "bound_ms": gf["bound_ms"],
        "bound_by": gf["bound_by"],
        "library_ms": None,
        "shape": f"{GLOBAL_PX:,} px x 160 years f32",
        "scratch_bytes": gf["scratch_bytes"],
        "bound_ms_with_scratch": gf["bound_ms_with_scratch"],
        "ms_40_candidates": glob["family_nc40"]["ms"],
        "ms_scratch_tier": glob["scratch_tier"]["float32"]["family_ms"],
    }
    print(nvidia_smi_line())
    print(json.dumps({"kernels": [kernel, kernel_wide, kernel_global, family, family_wide,
                                  family_global]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pod-worker"]:
        sys.exit(pod_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase-2d"]:
        sys.exit(phase_2d_alone())
    sys.exit(main())
