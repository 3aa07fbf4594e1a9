"""The kernel source, compiled for the host, against the plain version on
the CPU: every form of both kernels.

``csrc/segment_fused.cu`` is compiled with g++ (C++20) through
``tests/_cuda_host_shim.h``: CUDA's qualifiers and intrinsics as plain
C++, and a launch run block after block, each block as one thread per CUDA
thread over its own shared memory, ``__syncthreads()`` a barrier of the
block's threads (a thread that returns drops out of it), the bulk copy of
the slab a ``memcpy``.  So the narrow and wide forms and both tiers of the
global form run here as their blocks do on the card: the same slab load,
shared columns, barriers and staged output, launched through the
wrapper's own plan (``_Launch`` / ``_FamilyLaunch``; the scratch tier cut
into pieces).  Decisions and every output are bit-identical to the plain
version, except ``rmse`` and ``p_of_f``: their square roots, logs and
exponentials come from the host's libm here and from PyTorch's CPU
kernels in the plain version, so they agree to a few units in the last
place (1e-8 absolute in float32, 1e-15 in float64).  On the card the same
comparison is bit for bit (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda as sc
from land_trendr_tpu_torch.ops.segment import torch_family_stats, torch_segment_pixels
from land_trendr_tpu_torch.tools.population import make_population

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
#: outputs whose elementary functions come from different libraries here
LIBM = {"rmse": {torch.float32: 1e-8, torch.float64: 1e-15},
        "p_of_f": {torch.float32: 1e-8, torch.float64: 1e-15}}


def build_host_library(out: Path) -> Path:
    """The kernel source with the host shim's substitutions, built by g++
    into ``out``; returns the library's path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = sc._SRC.read_text()
    for old, new in (
        ("#include <cuda_runtime.h>", f'#include "{HERE / "_cuda_host_shim.h"}"'),
        # the bulk copy lands the slab, and the wait on its mbarrier (which
        # every thread of the block makes) is a barrier behind the copy
        ("uint32_t bytes,\n                                          uint64_t* bar) {\n",
         "uint32_t bytes,\n                                          uint64_t* bar) {\n"
         "  std::memcpy(dst, src, bytes);\n"),
        ("uint32_t done = 0;", "__syncthreads();\n  uint32_t done = 1;"),
        ("asm volatile(", "LT_NOASM("),
        ("extern __shared__ __align__(16) unsigned char smem[];",
         "unsigned char* smem = lt_emu_smem;"),
        ("  kernel<<<(unsigned)grid, block, (size_t)bytes, st>>>(args...);",
         "  (void)st;\n  lt_emu_launch(kernel, grid, block, (size_t)bytes, args...);"),
    ):
        assert old in src, old
        src = src.replace(old, new)
    (out / "segment_fused_host.cpp").write_text(src)
    lib = out / "libsegment_fused_host.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared",
                        "-fPIC", "-w", "-o", str(lib), str(out / "segment_fused_host.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory, request):
    """The kernel library built for the host and loaded through the
    wrapper (its argtypes and plan checks), restored afterwards."""
    lib = build_host_library(tmp_path_factory.mktemp("kernel_host"))
    mp = pytest.MonkeyPatch()
    sc.load_library.cache_clear()
    mp.setattr(sc, "_built", lambda: (str(lib), {}))
    mp.setattr(torch.cuda, "current_stream",
               lambda device=None: types.SimpleNamespace(cuda_stream=0))
    request.addfinalizer(lambda: (mp.undo(), sc.load_library.cache_clear()))
    return sc.load_library()  # cross-checks the shared-memory, block and scratch plans


def _inputs(ny: int, px: int, dtype):
    years, vals, mask = make_population(np.random.default_rng(7), px, ny)
    return (torch.from_numpy(years.astype(np.float64)).to(dtype),
            torch.from_numpy(vals.astype(np.float64)).to(dtype).contiguous(),
            torch.from_numpy(mask).contiguous())


def assert_matches_plain(got, years, vals, mask, params, dtype, family=None):
    """Every output of ``got`` (and of ``family``, the family kernel's)
    bit-identical to the plain version but the libm fields."""
    ref = torch_segment_pixels(years, vals, mask, params)
    for name, a, b in zip(got._fields, got, ref):
        if name in LIBM:
            assert torch.equal(a.isnan(), b.isnan()), name
            assert float((a - b).abs().nan_to_num().max()) <= LIBM[name][dtype], name
        else:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    if family is not None:
        for a, b in zip(family, torch_family_stats(years, vals, mask, params)):
            assert torch.equal(a, b)


def _run_both(years, vals, mask, params, cap, tier=None):
    """Both kernels of form ``cap`` on the host; their results and launches."""
    names = {"narrow": ("LAUNCHES", "FAMILY_LAUNCHES"),
             "wide": ("WIDE_LAUNCHES", "WIDE_FAMILY_LAUNCHES"),
             "global": ("GLOBAL_LAUNCHES", "GLOBAL_FAMILY_LAUNCHES")}[cap]
    before = [getattr(sc, n) for n in names]
    job = sc._Launch(years, vals, mask, params, cap=cap, _tier=tier)
    job.run(0, vals.shape[0])
    fjob = sc._FamilyLaunch(years, vals, mask, params, cap=cap, _tier=tier)
    fjob.run()
    launches = [getattr(sc, n) - b for n, b in zip(names, before)]
    return job, fjob, launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ny,over,budget_blocks",
    [
        (40, {}, None),                                                  # forced at a narrow shape
        (160, {}, None),                                                 # three set words
        (40, {"max_segments": 36, "vertex_count_overshoot": 3}, None),   # 40 candidates
        (72, {}, 1),                                                     # one block per piece
    ],
)
def test_global_form_on_the_host_matches_plain(host_lib, monkeypatch, dtype, ny, over,
                                               budget_blocks):
    # the shared tier at its own block, or (a budget given) the scratch
    # tier forced, one launch per budget-sized piece
    params = LTParams(**over)
    px = 200
    tier = None
    if budget_blocks is not None:
        tier = "scratch"
        monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", sc.global_scratch_bytes(
            ny, params, dtype, budget_blocks * sc.CUDA_BLOCK))
    years, vals, mask = _inputs(ny, px, dtype)
    job, fjob, launches = _run_both(years, vals, mask, params, "global", tier)
    assert job.plan.tier == fjob.plan.tier == (tier or "shared")
    pieces = 1 if tier is None else -(-px // sc.global_chunk(ny, params, dtype))
    assert launches == [pieces, pieces]
    assert (job.scratch is None) == (tier is None)
    assert_matches_plain(job.result(), years, vals, mask, params, dtype, fjob.result())
    assert int(job.result().n_vertices.max()) >= 3  # real models, not only flat ones


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ny,over,px",
    [
        (1000, {}, 5),                                                   # a series no block holds
        (80, {"max_segments": 62, "vertex_count_overshoot": 3}, 40),     # 66 candidates
    ],
)
def test_global_scratch_tier_on_the_host_matches_plain(host_lib, dtype, ny, over, px):
    params = LTParams(**over)
    years, vals, mask = _inputs(ny, px, dtype)
    job, fjob, launches = _run_both(years, vals, mask, params, "global")
    assert job.plan.tier == fjob.plan.tier == "scratch" and launches == [1, 1]
    assert job.scratch.tensor.numel() == sc.global_scratch_bytes(ny, params, dtype, px)
    assert_matches_plain(job.result(), years, vals, mask, params, dtype, fjob.result())
    assert int(job.result().n_vertices.max()) >= 3


def test_scratch_tier_op_counts_equal_the_shared_tiers(host_lib, monkeypatch):
    # the scratch tier's op tally (the operation side of its bound) is the
    # shared tier's on the same pixels: the same arithmetic in another
    # storage; the scratch tier cut into one-block pieces
    params, ny, px = LTParams(), 72, 200
    monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", sc.global_scratch_bytes(
        ny, params, torch.float32, sc.CUDA_BLOCK))
    years, vals, mask = _inputs(ny, px, torch.float32)
    counts = {}
    for tier in (None, "scratch"):
        job = sc._Launch(years, vals, mask, params, cap="global", _tier=tier)
        fjob = sc._FamilyLaunch(years, vals, mask, params, cap="global", _tier=tier)
        ops, fops = (torch.zeros(px, dtype=torch.int64) for _ in range(2))
        job.run(0, px, op_count=ops)
        fjob.run(op_count=fops)
        assert job.plan.tier == fjob.plan.tier == (tier or "shared")
        counts[tier] = ops, fops
    for shared, scratch in zip(counts[None], counts["scratch"]):
        assert int(shared.min()) > 0
        assert torch.equal(shared, scratch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "cap,ny,over",
    [
        ("narrow", 40, {}),
        ("wide", 72, {}),
        ("wide", 40, {"max_segments": 14, "vertex_count_overshoot": 3}),  # 18 candidates
    ],
)
def test_fixed_forms_on_the_host_match_plain(host_lib, dtype, cap, ny, over):
    # 300 px: the ragged last block of every block size; the bulk-copied
    # slab, the barriers and the staged output as on the card
    params = LTParams(**over)
    years, vals, mask = _inputs(ny, 300, dtype)
    assert sc.instantiation(ny, params) == cap
    job, fjob, launches = _run_both(years, vals, mask, params, cap)
    assert launches == [1, 1]
    assert_matches_plain(job.result(), years, vals, mask, params, dtype, fjob.result())
    assert int(job.result().n_vertices.max()) >= 3


# ---------------------------------------------------------------------------
# the FTV kernel (ops/segment_cuda.py:cuda_fit_to_vertices)
# ---------------------------------------------------------------------------

#: the FTV populations, row by row (row % len): what each makes of the
#: target's mask, its values or the vertex sets
FTV_KINDS = ("drawn", "under_two_valid", "under_two_vertices", "one_position", "inside_span",
             "non_finite", "repeated_vertices", "edge_years")


def ftv_population(seed: int, px: int, ny: int, params: LTParams, dtype):
    """``(years, values, mask, vertex_indices, n_vertices)`` for the FTV
    kernel: a target from one draw of the population, vertex sets of
    sorted year indices (two to NV live, padded -1), and row by row one of
    :data:`FTV_KINDS` — fewer than two valid years, fewer than two live
    vertices, every vertex mapping to one compacted position (the target
    valid only after the last vertex), a set inside the valid span (it
    starts after the first valid year and ends before the last), non-finite
    values under the mask (an index's 0/0 and x/0), repeated vertex years,
    vertices at the first and last year."""
    rng = np.random.default_rng(seed)
    years, vals, mask = make_population(rng, px, ny)
    nv = params.max_vertices
    vidx = np.full((px, nv), -1, np.int32)
    nvert = np.zeros(px, np.int32)
    for p in range(px):
        kind = FTV_KINDS[p % len(FTV_KINDS)]
        lo, hi = (ny // 4, 3 * ny // 4) if kind in ("inside_span", "one_position") else (0, ny)
        k = int(rng.integers(2, min(nv, hi - lo) + 1))
        pick = np.sort(rng.choice(np.arange(lo, hi), size=k, replace=False))
        if kind == "under_two_vertices":
            k = p % 2
        elif kind == "repeated_vertices":
            pick = np.sort(np.resize(pick[: (k + 1) // 2], k))
        elif kind == "edge_years":
            pick[0], pick[-1] = 0, ny - 1
        vidx[p, :k] = pick[:k]
        nvert[p] = k
        if kind == "under_two_valid":
            mask[p] = False
            if p % 2:
                mask[p, rng.integers(ny)] = True
        elif kind == "one_position":
            mask[p, : hi + 1] = False
        elif kind == "non_finite":
            bad = rng.choice(ny, size=max(1, ny // 8), replace=False)
            vals[p, bad] = np.where(np.arange(bad.size) % 2, np.inf, np.nan)
            vals[p, bad[:1]] = -np.inf
    return (torch.from_numpy(years.astype(np.float64)).to(dtype),
            torch.from_numpy(vals).to(dtype).contiguous(), torch.from_numpy(mask).contiguous(),
            torch.from_numpy(vidx), torch.from_numpy(nvert))


def run_ftv_host(args, params, tier=None):
    """The FTV kernel built for the host on CPU tensors; its result and
    launches (the segmentation's counter must not move)."""
    before = (sc.FTV_LAUNCHES, sc.LAUNCHES, sc.GLOBAL_LAUNCHES)
    got = sc._ftv_launch(*args, params, tier)
    assert (sc.LAUNCHES, sc.GLOBAL_LAUNCHES) == before[1:]
    return got, sc.FTV_LAUNCHES - before[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ny,over,px,tier",
    [
        (40, {}, 300, None),                         # the shared tier; a ragged last block
        (160, {}, 200, None),                        # three set words, a block of 32
        (72, {}, 300, "scratch"),                    # forced scratch, one block per piece
        (1000, {}, 9, None),                         # a series no block holds
        (40, {"max_segments": 70}, 130, None),       # 71 vertices: more than the locals
    ],
)
def test_ftv_kernel_on_the_host_matches_plain(host_lib, monkeypatch, dtype, ny, over, px, tier):
    # every population bit for bit: the FTV arithmetic has no libm call
    from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices

    params = LTParams(**over)
    if tier is not None:
        monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", sc.global_scratch_bytes(
            ny, sc._ftv_params(params), dtype, sc.CUDA_BLOCK))
    plan = sc.global_plan(ny, sc._ftv_params(params), dtype, _tier=tier)
    assert plan.tier == ("shared" if (ny, over, tier) in ((40, {}, None), (160, {}, None))
                         else "scratch")
    args = ftv_population(11, px, ny, params, dtype)
    got, launches = run_ftv_host(args, params, tier)
    pieces = 1 if tier is None else -(-px // sc.CUDA_BLOCK)
    assert launches == pieces
    ref = torch_fit_to_vertices(*args, params)
    assert got.dtype == ref.dtype == dtype and got.shape == (px, ny)
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    assert bool(got.isfinite().all())
    # fitted trajectories, not only flat means
    assert int((got[:, 1:] != got[:, :-1]).any(1).sum()) >= px // 4


@pytest.mark.parametrize("tier", [None, "scratch"])
def test_ftv_launch_passes_the_plans_overshoot_to_the_kernel(host_lib, monkeypatch, tier):
    # _ftv_params alone sets the candidate count: the plan sizes the shared
    # memory and the scratch regions by it, and the launch hands the same
    # overshoot to the kernel, which lays its arrays out by it
    from dataclasses import replace

    from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices

    params, ny, px = LTParams(), 72, 300
    monkeypatch.setattr(sc, "_ftv_params", lambda p: replace(p, vertex_count_overshoot=3))
    if tier is not None:
        monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", sc.global_scratch_bytes(
            ny, sc._ftv_params(params), torch.float32, sc.CUDA_BLOCK))
    seen = []
    real = host_lib.lt_ftv_fit_f32

    def spy(*a):
        seen.append(a[8:10])  # max_segments, overshoot
        return real(*a)

    monkeypatch.setattr(host_lib, "lt_ftv_fit_f32", spy)
    args = ftv_population(13, px, ny, params, torch.float32)
    got, launches = run_ftv_host(args, params, tier)
    assert launches == len(seen) >= 1
    assert set(seen) == {(params.max_segments, 3)}
    ref = torch_fit_to_vertices(*args, params)
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
