"""Chip smoke for the PyTorch/CUDA port: the `segment` path and the stage
probe on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result,
without them (or when run outside a checkout of the repository).  Phases,
each of which fails the script on its own:

1. **Build** the kernels (``csrc/segment_fused.cu``: the fused
   segmentation kernel and the family kernel) from the checkout's source
   with nvcc; print the build seconds, the ptxas register/stack/spill
   report, each kernel's occupancy (blocks and warps per SM) and shared
   bytes per block, and the card's name and power limit.
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
5. **CLI**: ``synth``, ``segment`` on the default device, then a second
   ``segment`` that resumes every tile; then ``segment --ftv ndvi
   --change --change-mmu 4`` and ``change OUT --mmu 4``.
6. **Stage probe** (``tools/probe.py stages``) at 262,144 px: the fused
   kernel, the family kernel, family + plain tail and the plain version,
   timed with CUDA events; its JSON line is printed.  This is the family
   kernel's path: its launch count is read around this phase.
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
   completes; (c) ``stall_timeout_s=2`` with ~10 s of ``torch.cuda._sleep``
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
   (c) the CLI: ``segment --trace --out-overviews 2`` (the trace names
   ``segment_fused_kernel``),
   ``pixel --from-stack --engine both`` at two pixels (oracle and kernel
   agree on vertex years), and ``info`` on an output raster (two
   overview pages).

Phases 4 and 4b also assert that nothing was retried or quarantined and
print the run's HBM peak (the value the telemetry gauge holds).  Each
kernel's launch count is set to 0 just before its path (phase 4 for the
fused kernel, phase 6 for the family kernel; phases 7 and 8 count their
own runs) and read just after.
The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON object describing each kernel, and the result line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

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
#: cycles of the device spin behind the stall (phase 7c): ~10 s at H100 clocks
STALL_CYCLES = int(2e10)
#: NVIDIA H100 SXM published peaks (dense): HBM3 bytes/s, FP32 (non-tensor) op/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events, after
    one warm-up call."""
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


def prom_gauge(path: str, name: str) -> "float | None":
    with open(path) as f:
        for line in f:
            if line.startswith(name + " "):
                return float(line.split()[1])
    return None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.io import native
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
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

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    smi = nvidia_smi_line()
    log(f"nvidia-smi: {smi}")
    params = LTParams()

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
    nv, nm = params.max_vertices, params.max_segments
    bytes_in = POP_PX * NY * (4 + 1) + NY * 4
    bytes_out = POP_PX * (4 * (2 * NY + 4 * nv + 3 * nm + 3) + 1)
    n_bytes = bytes_in + bytes_out
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = n_ops / FP32_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"[kernel] {POP_PX} px x {NY} yr f32: kernel {kernel_ms:.4f} ms "
        f"({POP_PX / kernel_ms / 1e3:.1f} M px/s), wrapper {wrapper_ms:.4f} ms, "
        f"plain {plain_ms:.2f} ms, plain f64 {plain64_ms:.2f} ms, fit rate {fit_rate_pop:.4f}")
    log(f"[kernel] bound: {n_bytes} B -> {bytes_ms:.4f} ms at 3.35 TB/s; "
        f"{n_ops} FP32 ops ({n_ops / POP_PX:.0f}/px, "
        f"p50 {int(ops.median())} max {int(ops.max())}, hand-counted per loop) -> "
        f"{ops_ms:.4f} ms at 67 TFLOP/s (the published FP32 rate, an FMA as two); "
        f"bound {bound_ms:.4f} ms by {bound_by}; kernel at "
        f"{100 * bound_ms / kernel_ms:.1f}% of it")

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
    f_bytes = bytes_in + POP_PX * (4 * NY + nm * NY + 4 * nm)
    f_bytes_ms = f_bytes / HBM_BYTES_S * 1e3
    f_ops_ms = f_ops / FP32_OPS_S * 1e3
    fam_bound_ms = max(f_bytes_ms, f_ops_ms)
    fam_bound_by = "bytes" if f_bytes_ms >= f_ops_ms else "operations"
    log(f"[family] {POP_PX} px x {NY} yr f32: kernel {fam_ms:.4f} ms, wrapper "
        f"{fam_wrapper_ms:.4f} ms, plain {fam_plain_ms:.2f} ms")
    log(f"[family] bound: {f_bytes} B -> {f_bytes_ms:.4f} ms at 3.35 TB/s; {f_ops} FP32 ops "
        f"({f_ops / POP_PX:.0f}/px, p50 {int(fops.median())} max {int(fops.max())}) -> "
        f"{f_ops_ms:.4f} ms at 67 TFLOP/s; bound {fam_bound_ms:.4f} ms by {fam_bound_by}; "
        f"kernel at {100 * fam_bound_ms / fam_ms:.1f}% of it")
    del k32, p32, k64, p64, ch, job, v64, f32, pf32, f64, pf64, tail32, tail64, fjob

    # ---- phase 4: scene through run_stack + assemble_outputs ------------
    t0 = time.perf_counter()
    stack = stack_from_synthetic(make_stack(SceneSpec(height=SCENE, width=SCENE)))
    synth_s = time.perf_counter() - t0
    n_tiles = (SCENE // TILE) ** 2
    log(f"[scene] synthetic {SCENE}x{SCENE}x{stack.n_years} stack made in {synth_s:.1f}s")
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
    with tempfile.TemporaryDirectory(prefix="lt_smoke_", dir=ROOT) as tmp:
        cfg = RunConfig(
            tile_size=TILE,
            workdir=os.path.join(tmp, "work"),
            out_dir=os.path.join(tmp, "out"),
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
    with tempfile.TemporaryDirectory(prefix="lt_smoke_cli_", dir=ROOT) as tmp:
        def cli(*argv: str) -> str:
            out = subprocess.run(
                [sys.executable, "-m", "land_trendr_tpu_torch", *argv],
                cwd=tmp, env=env, capture_output=True, text=True, check=False, timeout=600,
            )
            if out.returncode != 0:
                raise RuntimeError(f"CLI {argv} exited {out.returncode}:\n{out.stderr[-3000:]}")
            return out.stdout

        cli("synth", "D", "--size", "256")
        first = json.loads(cli("segment", "D"))["summary"]
        again = json.loads(cli("segment", "D"))["summary"]
        log(f"[cli] segment: tiles {first['tiles']} impl {first['impl']} device "
            f"{first['device']} fit_rate {first['fit_rate']:.4f}; resume skipped "
            f"{again['tiles_skipped_resume']} of {again['tiles']}")
        assert first["impl"] == "cuda" and first["device"].startswith("cuda"), first
        assert first["tiles_done"] == first["tiles"], first
        assert again["tiles_skipped_resume"] == again["tiles"] and again["tiles_done"] == 0, again
        tail = json.loads(cli("segment", "D", "--ftv", "ndvi", "--change", "--change-mmu", "4",
                              "--workdir", "w_tail", "--out-dir", "o_tail"))
        maps = json.loads(cli("change", "o_tail", "--mmu", "4", "--dest", "c_tail"))["outputs"]
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

        # (c) the device spins ~10 s before one tile's event: StallError
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
        for rep in range(2):
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
    del stack

    with tempfile.TemporaryDirectory(prefix="lt_smoke_cli8_", dir=ROOT) as tmp:
        def cli8(*argv: str) -> str:
            out = subprocess.run(
                [sys.executable, "-m", "land_trendr_tpu_torch", *argv],
                cwd=tmp, env=env, capture_output=True, text=True, check=False, timeout=600,
            )
            if out.returncode != 0:
                raise RuntimeError(f"CLI {argv} exited {out.returncode}:\n{out.stderr[-3000:]}")
            return out.stdout

        cli8("synth", "D", "--size", "256")
        traced = json.loads(cli8("segment", "D", "--trace", "T", "--out-overviews", "2"))
        names = set()
        for fn in os.listdir(os.path.join(tmp, "T")):
            with open(os.path.join(tmp, "T", fn)) as f:
                names |= {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
        kernels = sorted(n for n in names if "segment_fused_kernel" in n)
        assert kernels, "the trace does not name segment_fused_kernel"
        log(f"[cli] segment --trace --out-overviews 2: impl {traced['summary']['impl']}, trace "
            f"names {kernels[0][:90]}; lt_ ranges in the trace: "
            f"{sorted(n for n in names if n.startswith('lt_'))}")
        # (10, 20) fits no model on this stack; (24, 0) is a disturbed pixel
        for x, y in ((10, 20), (24, 0)):
            pix = json.loads(cli8("pixel", "--from-stack", "D", "--x", str(x), "--y", str(y),
                                  "--engine", "both"))
            assert pix["parity"]["vertex_years_equal"], pix["parity"]
            assert pix["parity"]["model_valid_equal"] and pix["torch"]["device"].startswith("cuda")
            log(f"[cli] pixel ({x}, {y}) --engine both: model_valid "
                f"{pix['oracle']['model_valid']}, vertex years oracle "
                f"{pix['oracle']['vertex_years']} kernel {pix['torch']['vertex_years']} "
                f"({pix['torch']['dtype']} on {pix['torch']['device']})")
        assert pix["oracle"]["model_valid"], "the disturbed pixel fit no model"
        path = traced["outputs"]["rmse"]
        info = json.loads(cli8("info", path))[path]
        assert info["overview_pages"] == 2, info
        log(f"[cli] info {path}: {info['height']}x{info['width']} {info['dtype']} "
            f"{info['compression']}, {info['overview_pages']} overview pages, "
            f"{info['file_bytes']} B")
    log(f"[phase 8] took {time.perf_counter() - t8:.1f}s")

    kernel = {
        "name": "segment_fused",
        "route": "cuda",
        "source": "land_trendr_tpu_torch/csrc/segment_fused.cu",
        "replaces": "land_trendr_tpu/ops/segment_pallas.py:1027",
        "launches": launches,
        "max_abs_err": err32,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "wrapper_ms": wrapper_ms,
    }
    family = {
        "name": "family_stats",
        "route": "cuda",
        "source": "land_trendr_tpu_torch/csrc/segment_fused.cu",
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
    print(nvidia_smi_line())
    print(json.dumps({"kernels": [kernel, family]}))
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
    sys.exit(main())
