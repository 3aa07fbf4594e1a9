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

Each kernel's launch count is set to 0 just before its path (phase 4 for
the fused kernel, phase 6 for the family kernel) and read just after.
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
    from land_trendr_tpu_torch.runtime.driver import RunConfig, assemble_outputs, run_stack
    from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic
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
        assert summary["tiles_done"] == n_tiles, summary
        assert launches == n_tiles, f"{launches} kernel launches for {n_tiles} tiles"
        assert header.get("context", {}).get("impl") == "cuda", header
        assert 0.0 < summary["fit_rate"] <= 1.0, summary["fit_rate"]
        assert summary["pixels"] == SCENE * SCENE, summary["pixels"]
        assert len(paths) == 11, sorted(paths)
        for rep in range(SCENE_REPEATS):
            work = os.path.join(tmp, f"work{rep}")
            again = run_stack(stack, dataclasses.replace(cfg, workdir=work), device="cuda")
            assert again["tiles_done"] == n_tiles, again
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
        assert summary["tiles_done"] == n_tiles, summary
        assert tail_launches == n_tiles, f"{tail_launches} kernel launches for {n_tiles} tiles"
        assert header.get("context", {}).get("impl") == "cuda", header
        assert 0.0 < summary["fit_rate"] <= 1.0, summary["fit_rate"]
        want = {f"ftv_{i}" for i in FTV} | {f"change_{k}" for k in CHANGE_PRODUCTS}
        assert want <= set(paths), sorted(want - set(paths))
    del stack

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
