"""Wrappers of the LandTrendr CUDA kernels (``csrc/segment_fused.cu``).

Counterpart of ``land_trendr_tpu/ops/segment_pallas.py``:
:func:`cuda_segment_pixels` replaces ``jax_segment_pixels_pallas`` and
:func:`cuda_segment_pixels_chunked` replaces
``jax_segment_pixels_pallas_chunked``, with the same output contract
(:class:`~land_trendr_tpu_torch.ops.segment.SegOutputs`);
:func:`cuda_family_stats` replaces ``family_stats_pallas`` (stages 1–4a:
despiked series, family vertex sets, SSEs).

* **Build.**  The kernel is compiled at first use with ``nvcc`` for
  ``sm_90a`` (two processes at once, the fixed forms and the global form,
  from the one source) into a shared library with a plain C interface
  (``land_trendr_tpu_torch/_build/``, named by the source's hash, so an
  edited source is rebuilt) and loaded with :mod:`ctypes`.  Nothing is
  built or imported when this module is imported.
* **Three forms.**  Each kernel is built three times: the narrow
  instantiation (up to :data:`NARROW_NY` years and :data:`NARROW_NC`
  candidates, ``max_segments + 1 + vertex_count_overshoot``), which every
  40-year stack takes, the wide one (up to :data:`WIDE_NY` years and
  :data:`WIDE_NC` candidates, half the block), and the global form, whose
  NY, candidate count and block are runtime values (:func:`global_plan`).
  Its shared tier keeps the series in shared memory as the fixed forms do,
  at the block of :data:`GLOBAL_SWEEP` an SM holds the most warps of, and its
  per-thread arrays in locals of :data:`GLOBAL_LOCAL_NC`; its scratch tier,
  for a NY that not even a block of 32 holds or more candidates than that,
  keeps the same layout in a device-memory scratch the wrapper allocates
  per call (:func:`global_scratch_bytes`), the launch cut to
  :data:`GLOBAL_SCRATCH_BUDGET` bytes of it (:func:`global_chunk`).
  :func:`instantiation` picks the form from NY and the params; nothing is
  refused for its size.
* **Launch.**  The kernel runs on PyTorch's current stream of the input's
  device, one thread per pixel.  It reads the caller's pixel-major
  ``(PX, NY)`` values and bool mask as they are (no transposed or cleaned
  copy: the kernel tests ``isfinite`` itself) and the fused kernel writes
  its outputs pixel-major, so :class:`SegOutputs` holds the tensors the
  kernel wrote.  Each block brings its contiguous slab into shared memory
  (:func:`smem_bytes` is its plan; a block of the global form's scratch
  tier, into its region of the scratch).
  The C entry returns ``cudaGetLastError()`` and the wrapper raises on a
  non-zero code.  Every launch of the narrow fused kernel adds one to
  :data:`LAUNCHES`, of the wide and global ones to :data:`WIDE_LAUNCHES`
  and :data:`GLOBAL_LAUNCHES`, of the family kernel's three forms to
  :data:`FAMILY_LAUNCHES`, :data:`WIDE_FAMILY_LAUNCHES` and
  :data:`GLOBAL_FAMILY_LAUNCHES`, and nothing else does.
  Each launch is an NVTX range (``lt_segment_fused``, ``lt_family_stats``).
* **Plain version.**  For tensors on the CPU — and only because they are
  on the CPU — the wrappers run the plain PyTorch version
  (:func:`~land_trendr_tpu_torch.ops.segment.torch_segment_pixels`,
  :func:`~land_trendr_tpu_torch.ops.segment.torch_family_stats`).  A
  CUDA tensor is launched or rejected; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.segment import (
    SegOutputs,
    lentz_iters,
    torch_family_stats,
    torch_segment_pixels,
    torch_segment_pixels_chunked,
)
from land_trendr_tpu_torch.utils.profiling import nvtx_range

__all__ = [
    "BLOCKS",
    "CAPS",
    "CUDA_BLOCK",
    "FAMILY_LAUNCHES",
    "GLOBAL_FAMILY_LAUNCHES",
    "GLOBAL_LAUNCHES",
    "GLOBAL_LOCAL_NC",
    "GLOBAL_SCRATCH_BUDGET",
    "GLOBAL_SWEEP",
    "LAUNCHES",
    "NARROW_NC",
    "NARROW_NY",
    "SMEM_LIMIT",
    "STAGES",
    "SWEEP",
    "WIDE_BLOCKS",
    "WIDE_FAMILY_LAUNCHES",
    "WIDE_LAUNCHES",
    "WIDE_NC",
    "WIDE_NY",
    "block_of",
    "build_info",
    "cuda_family_op_counts",
    "cuda_family_stats",
    "cuda_segment_op_counts",
    "cuda_segment_pixels",
    "cuda_segment_pixels_chunked",
    "cuda_segment_stage_cycles",
    "global_chunk",
    "global_plan",
    "GlobalPlan",
    "global_scratch_bytes",
    "instantiation",
    "kernel_attributes",
    "launch_counts",
    "load_library",
    "occupancy",
    "smem_bytes",
]

#: the chunk granule: a chunk larger than this must be a multiple of it
#: (the counterpart of the Pallas block of the JAX package), and every
#: kernel block is a multiple of it
CUDA_BLOCK = 128
#: threads per block of both narrow kernels by value dtype: float32, the
#: timed path, at the fastest block of the sweep that holds NY = 64 in
#: shared memory; float64 at 128, for the same reason
BLOCKS = {torch.float32: 256, torch.float64: 128}
#: threads per block of both wide kernels: half the narrow blocks, so that
#: NY = 128 fits a block's shared memory (64 still divides the chunk granule)
WIDE_BLOCKS = {torch.float32: 128, torch.float64: 64}
#: candidates the global form's shared tier holds in its per-thread local
#: arrays; more take the scratch tier
GLOBAL_LOCAL_NC = 64
#: block sizes of the float32 fused kernel's block-size sweep: the
#: float64 block, the float32 block, and the largest that holds NY = 40
SWEEP = (128, 256, 512)
#: the global form's blocks: its shared tier runs the one an SM holds the
#: most warps of (:func:`global_plan`), and the float32 fused kernel's
#: block-size sweep runs each that fits
GLOBAL_SWEEP = (32, 64, 128)
#: shared bytes of one SM on sm_90, and what the system keeps of them per
#: resident block (the occupancy the global plan's block is picked by)
SM_SMEM, SMEM_PER_BLOCK = 233_472, 1_024
#: shared-memory bytes one block may use on sm_90
SMEM_LIMIT = 232_448
#: capacity bounds (years, candidates) of each instantiation: the narrow
#: one holds a vertex set in one 64-bit word, the wide one in two; the
#: global form has none (``None``: only the device memory bounds it)
CAPS = {"narrow": (64, 16), "wide": (128, 32), "global": (None, None)}
NARROW_NY, NARROW_NC = CAPS["narrow"]
WIDE_NY, WIDE_NC = CAPS["wide"]
#: bytes of device-memory scratch one launch of the global form's scratch
#: tier may allocate; the launch loop cuts the pixels of a call to stay
#: within it (the shared tier allocates none)
GLOBAL_SCRATCH_BUDGET = 1 << 30

#: the fused kernel's stages, in the order of the columns of
#: :func:`cuda_segment_stage_cycles`
STAGES = (
    "load_compact", "despike", "candidates_cull", "family_fits", "scoring_selection",
    "refit_output",
)

#: narrow fused-kernel launches made by this process — one per launch,
#: counted where the kernel is launched and nowhere else
LAUNCHES = 0
#: wide fused-kernel launches, counted the same way
WIDE_LAUNCHES = 0
#: global fused-kernel launches (one per scratch-sized piece of a call)
GLOBAL_LAUNCHES = 0
#: narrow, wide and global family-kernel launches, counted the same way
FAMILY_LAUNCHES = 0
WIDE_FAMILY_LAUNCHES = 0
GLOBAL_FAMILY_LAUNCHES = 0



def launch_counts() -> "dict[str, int]":
    """This process's launches of each kernel form, by counter name (what
    ``serve``'s ``GET /debug/kernels`` reports)."""
    return {
        "LAUNCHES": LAUNCHES, "WIDE_LAUNCHES": WIDE_LAUNCHES,
        "GLOBAL_LAUNCHES": GLOBAL_LAUNCHES, "FAMILY_LAUNCHES": FAMILY_LAUNCHES,
        "WIDE_FAMILY_LAUNCHES": WIDE_FAMILY_LAUNCHES,
        "GLOBAL_FAMILY_LAUNCHES": GLOBAL_FAMILY_LAUNCHES,
    }


_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "segment_fused.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: the library's parts: the source compiled once per part (``-DLT_PART``:
#: 1 the fixed forms, 2 the global form), all started together, then
#: linked into one shared library
_PARTS = (1, 2)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = [
    _P, _P, _P, _LL, _I,                      # years, values, mask, px, ny
    _P, _P, _P, _P, _P, _P, _P,               # despiked .. vertex_fit_vals
    _P, _P, _P, _P, _P, _P,                   # seg_* , rmse, p_of_f, model_valid
    _I, _I, _D, _D, _I, _D, _D, _I, _I,       # params
    _P,                                       # stream
]
_FAMILY_ARGTYPES = [
    _P, _P, _P, _LL, _I,                      # years, values, mask, px, ny
    _P, _P, _P, _LL,                          # despiked, vmasks, sses, out_ld
    _I, _I, _D, _D, _I,                       # params
    _P,                                       # stream
]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH): "
        "the fused segmentation kernel is built from csrc/segment_fused.cu at "
        "first use and needs the CUDA toolkit"
    )


@functools.lru_cache(maxsize=1)
def _built() -> tuple[str, dict]:
    """Build (or reuse) the kernel library; ``(path, info)``."""
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _BUILD_DIR / f"libsegment_fused_{digest}.so"
    log_path = _BUILD_DIR / f"segment_fused_{digest}.ptxas.txt"
    info = {"path": str(lib), "built": False, "build_s": 0.0, "ptxas": ""}
    if not lib.exists():
        # per-process temp names: concurrent builders (the processes of a
        # pod on a cold _build/) each rename their own identical copy
        tag = f".tmp_{os.getpid()}_"
        tmp = _BUILD_DIR / f"{tag}{lib.name}"
        objs = [_BUILD_DIR / f"{tag}segment_fused_{digest}_{n}.o" for n in _PARTS]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        try:
            parts = [subprocess.Popen([nvcc, *_NVCC_FLAGS, f"-DLT_PART={n}", "-c", "-o",
                                       str(obj), str(_SRC)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                     for n, obj in zip(_PARTS, objs)]
            logs = [p.communicate() for p in parts]
            failed = [(p.returncode, err) for p, (_, err) in zip(parts, logs) if p.returncode]
            if not failed:
                link = subprocess.run([nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                       *map(str, objs)],
                                      capture_output=True, text=True, check=False)
                if link.returncode:
                    failed.append((link.returncode, link.stderr))
            info["build_s"] = time.perf_counter() - t0
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({failed[0][0]}) building {_SRC.name}:\n"
                    f"{failed[0][1][-4000:]}"
                )
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        log_tmp = _BUILD_DIR / f"{tag}{log_path.name}"
        log_tmp.write_text("".join(err for _, err in logs))
        os.replace(log_tmp, log_path)
        os.replace(tmp, lib)  # atomic: a concurrent builder's copy is identical
        info["built"] = True
    if log_path.exists():
        info["ptxas"] = log_path.read_text()
    return str(lib), info


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernel library, built from the repo's source at first use."""
    path, _info = _built()
    lib = ctypes.CDLL(path)
    for name in ("lt_segment_fused_f32", "lt_segment_fused_f64",
                 "lt_segment_fused_wide_f32", "lt_segment_fused_wide_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    for name in ("lt_segment_fused_f32_opcount", "lt_segment_fused_wide_f32_opcount",
                 "lt_segment_fused_f32_stagecycles"):
        getattr(lib, name).argtypes = [*_ARGTYPES, _P]
        getattr(lib, name).restype = ctypes.c_int
    # the global form's entries take (scratch, block, tier) after the stream
    for name in ("lt_segment_fused_global_f32", "lt_segment_fused_global_f64"):
        getattr(lib, name).argtypes = [*_ARGTYPES, _P, _I, _I]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("lt_segment_fused_global_f32_opcount", "lt_segment_fused_global_f32_stagecycles"):
        getattr(lib, name).argtypes = [*_ARGTYPES, _P, _I, _I, _P]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("lt_segment_kernel_attrs", "lt_segment_global_kernel_attrs"):
        getattr(lib, name).argtypes = [_I, _I, _I, _P]
        getattr(lib, name).restype = ctypes.c_int
    lib.lt_segment_fused_f32_block.argtypes = [*_ARGTYPES, _I]
    lib.lt_segment_fused_f32_block.restype = ctypes.c_int
    lib.lt_segment_occupancy.argtypes = [_I, _I, _I, _I, _I, _P]
    lib.lt_segment_occupancy.restype = ctypes.c_int
    lib.lt_segment_global_occupancy.argtypes = [_I, _I, _I, _I, _I, _P]
    lib.lt_segment_global_occupancy.restype = ctypes.c_int
    lib.lt_segment_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.lt_segment_smem_bytes.restype = ctypes.c_longlong
    for name in ("lt_family_stats_f32", "lt_family_stats_f64",
                 "lt_family_stats_wide_f32", "lt_family_stats_wide_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _FAMILY_ARGTYPES
        fn.restype = ctypes.c_int
    for name in ("lt_family_stats_f32_opcount", "lt_family_stats_wide_f32_opcount"):
        getattr(lib, name).argtypes = [*_FAMILY_ARGTYPES, _P]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("lt_family_stats_global_f32", "lt_family_stats_global_f64"):
        getattr(lib, name).argtypes = [*_FAMILY_ARGTYPES, _P, _I, _I]
        getattr(lib, name).restype = ctypes.c_int
    lib.lt_family_stats_global_f32_opcount.argtypes = [*_FAMILY_ARGTYPES, _P, _I, _I, _P]
    lib.lt_family_stats_global_f32_opcount.restype = ctypes.c_int
    lib.lt_segment_global_block.argtypes = [_I, _I, _I]
    lib.lt_segment_global_block.restype = ctypes.c_int
    lib.lt_segment_global_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.lt_segment_global_smem_bytes.restype = ctypes.c_longlong
    lib.lt_segment_global_scratch_bytes.argtypes = [_I, _I, _I, _I, _LL]
    lib.lt_segment_global_scratch_bytes.restype = ctypes.c_longlong
    for name in ("lt_segment_max_ny", "lt_segment_max_nc", "lt_segment_wide_max_ny",
                 "lt_segment_wide_max_nc", "lt_segment_nstage", "lt_segment_global_local_nc"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    for name in ("lt_segment_block", "lt_segment_wide_block"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [_I]
    _check_plans(lib)
    return lib


def _check_plans(lib: ctypes.CDLL) -> None:
    """Raise unless the kernel library's capacities and its shared-memory,
    block and scratch plans equal this module's."""
    caps = (
        (lib.lt_segment_max_ny(), lib.lt_segment_max_nc(),
         lib.lt_segment_block(4), lib.lt_segment_block(8)),
        (lib.lt_segment_wide_max_ny(), lib.lt_segment_wide_max_nc(),
         lib.lt_segment_wide_block(4), lib.lt_segment_wide_block(8)),
        lib.lt_segment_global_local_nc(),
        lib.lt_segment_nstage(),
    )
    want = tuple(
        (*CAPS[cap], block_of(torch.float32, cap), block_of(torch.float64, cap))
        for cap in ("narrow", "wide")
    ) + (GLOBAL_LOCAL_NC, len(STAGES))
    if caps != want:
        raise RuntimeError(f"kernel capacities {caps} != wrapper's {want}")
    for code, cap in enumerate(("narrow", "wide")):
        for ny in (1, 2, 40, CAPS[cap][0]):
            for elem in (4, 8):
                for block in (*SWEEP, *WIDE_BLOCKS.values()):
                    got = lib.lt_segment_smem_bytes(ny, elem, block, code)
                    plan = _smem_plan(ny, elem, block, CAPS[cap][1])
                    if got != plan:
                        raise RuntimeError(
                            f"kernel's shared-memory plan {got} B (ny={ny}, {elem}-byte "
                            f"values, block {block}, {cap}) != wrapper's {plan} B"
                        )
    # the global plan on each side of its tier boundaries (the scratch tier
    # from NY 444 in float64 and 880 in float32, and above 64 candidates)
    for ny in (1, 40, 160, 443, 444, 879, 880, 1000):
        for nc in (4, 10, 40, GLOBAL_LOCAL_NC, GLOBAL_LOCAL_NC + 1):
            for elem in (4, 8):
                got = (lib.lt_segment_global_block(ny, elem, nc),
                       [lib.lt_segment_global_smem_bytes(ny, nc, elem, b) for b in GLOBAL_SWEEP],
                       [lib.lt_segment_global_scratch_bytes(ny, nc, nc - 3, elem, px)
                        for px in (1, 129, 65_536)])
                plan = (_global_block(ny, elem, nc),
                        [_global_smem_plan(ny, nc, elem, b) for b in GLOBAL_SWEEP],
                        [_scratch_plan(ny, nc, nc - 3, elem, px) for px in (1, 129, 65_536)])
                if got != plan:
                    raise RuntimeError(
                        f"kernel's global plan {got} (ny={ny}, nc={nc}, {elem}-byte values: "
                        f"block, shared bytes at {GLOBAL_SWEEP}, scratch bytes) != wrapper's "
                        f"{plan}"
                    )


def build_info(force: bool = False) -> dict:
    """Where the library is, whether this process built it, how long the
    build took, and nvcc's ``-Xptxas -v`` report (registers, spills).

    ``force`` discards a library already built from the same source and
    builds it again (before this process has loaded one)."""
    if force:
        load_library.cache_clear()
        _built.cache_clear()
        for old in _BUILD_DIR.glob("libsegment_fused_*.so"):
            old.unlink()
    load_library()
    return dict(_built()[1])


#: the C entries' code of each instantiation
_CAP_CODES = ("narrow", "wide", "global")


def instantiation(ny: int, params: LTParams) -> str:
    """The kernels' instantiation that holds ``ny`` years and ``params``'
    candidates: ``"narrow"`` up to :data:`NARROW_NY` years and
    :data:`NARROW_NC` candidates, ``"wide"`` up to :data:`WIDE_NY` and
    :data:`WIDE_NC`, else ``"global"``, which has no cap."""
    nc = params.max_candidates
    if ny <= NARROW_NY and nc <= NARROW_NC:
        return "narrow"
    return "wide" if ny <= WIDE_NY and nc <= WIDE_NC else "global"


def _holds(cap: str, ny: int, params: LTParams) -> bool:
    """Whether instantiation ``cap`` holds ``ny`` years and ``params``."""
    max_ny, max_nc = CAPS[cap]
    return max_ny is None or (ny <= max_ny and params.max_candidates <= max_nc)


def block_of(dtype: torch.dtype, cap: str = "narrow") -> int:
    """Threads per block of both kernels of the fixed instantiation ``cap``
    (the global form's block follows the shape: :func:`global_plan`)."""
    if cap not in ("narrow", "wide"):
        raise ValueError(f"the {cap} form's block follows the shape: see global_plan")
    return {"narrow": BLOCKS, "wide": WIDE_BLOCKS}[cap][dtype]


def _elem(dtype: torch.dtype) -> int:
    if dtype not in BLOCKS:
        raise TypeError(f"values must be float32 or float64; got {dtype}")
    return 8 if dtype == torch.float64 else 4


def _smem_plan(ny: int, elem: int, block: int, nc: int) -> int:
    """Dynamic shared-memory bytes of one block (``smem_bytes`` in the
    source): a 16-byte mbarrier, the year axis rounded up to 16 bytes, the
    y columns (NY per thread; the mask slab lands there), and the t
    columns (W = max(NY, NC) | 1 per thread for the candidate capacity NC;
    the value slab lands there and the output staging tile reuses them)."""
    width = max(ny, nc) | 1
    return 16 + (ny * elem + 15) // 16 * 16 + block * (ny + width) * elem


def _global_smem_plan(ny: int, nc: int, elem: int, block: int) -> int:
    """The global form's block (``global_smem_bytes`` in the source): the
    fixed forms' layout at the launch's NC, with the valid-year set as
    ceil(NY / 64) columns of 64-bit words beside it."""
    return _smem_plan(ny, elem, block, nc) + (ny + 63) // 64 * block * 8


def _global_block(ny: int, elem: int, nc: int) -> int:
    """The global form's shared-tier block (``global_block`` in the
    source): of the blocks of :data:`GLOBAL_SWEEP` that fit in
    :data:`SMEM_LIMIT` bytes, the one an SM holds the most warps of
    (:data:`SM_SMEM` over each block's bytes plus :data:`SMEM_PER_BLOCK`,
    at most 32 blocks and 64 warps), ties to the larger; 0 — the scratch
    tier — when none fits or there are more than :data:`GLOBAL_LOCAL_NC`
    candidates."""
    if nc > GLOBAL_LOCAL_NC:
        return 0
    best, best_warps = 0, 0
    for b in sorted(GLOBAL_SWEEP, reverse=True):
        n = _global_smem_plan(ny, nc, elem, b)
        if n > SMEM_LIMIT:
            continue
        warps = min(SM_SMEM // (n + SMEM_PER_BLOCK), 32, 2048 // b) * b // 32
        if warps > best_warps:
            best, best_warps = b, warps
    return best


def _scratch_plan(ny: int, nc: int, nm: int, elem: int, px: int) -> int:
    """Bytes of the global form's scratch tier for ``px`` pixels
    (``lt_segment_global_scratch_bytes`` in the source): one region per
    block of :data:`CUDA_BLOCK` threads, each the block's layout
    (:func:`_global_smem_plan`) and then the per-thread arrays as planes
    [position][thread] — NC ints x 4 (vertices, farthest points, the chosen
    vertices, their years), NM ints (the family's removals), NC values x 4
    (deviations, the chosen fits, regression anchors, rates) and NM values
    x 3 (SSEs, p-values, scores)."""
    arrays = ((4 * nc + nm) * 4 + (4 * nc + 3 * nm) * elem) * CUDA_BLOCK
    region = _global_smem_plan(ny, nc, elem, CUDA_BLOCK) + arrays
    return -(-px // CUDA_BLOCK) * region


class GlobalPlan(NamedTuple):
    """A launch plan of the global form: its tier (``"shared"`` or
    ``"scratch"``), threads per block, dynamic shared bytes per block, and
    scratch bytes per :data:`CUDA_BLOCK`-pixel block (0 in the shared tier)."""

    tier: str
    block: int
    smem: int
    scratch_per_block: int


def global_plan(ny: int, params: LTParams, dtype: torch.dtype = torch.float32, *,
                _tier: "str | None" = None) -> GlobalPlan:
    """The global form's plan at ``ny`` years and ``params``' candidates:
    the shared tier at the block of :data:`GLOBAL_SWEEP` an SM holds the
    most warps of (:func:`_global_block`), else the scratch tier (blocks of
    :data:`CUDA_BLOCK`).  ``_tier`` is a test hook, which no caller of the
    port passes: it forces one tier, so that the tests hold the scratch
    tier to the shared one on the same shapes; forcing the shared tier on a
    shape it cannot hold raises :class:`ValueError`."""
    elem, nc = _elem(dtype), params.max_candidates
    if ny < 1:
        raise ValueError(f"NY={ny}: a series needs a year")
    if _tier not in (None, "shared", "scratch"):
        raise ValueError(f"tier {_tier!r} is not 'shared' or 'scratch'")
    block = _global_block(ny, elem, nc)
    if _tier == "shared" and not block:
        raise ValueError(
            f"the global form's shared tier holds NY={ny} at {nc} candidates in no block of "
            f"{GLOBAL_SWEEP} ({dtype}, at most {GLOBAL_LOCAL_NC} candidates)")
    if block and _tier != "scratch":
        return GlobalPlan("shared", block, _global_smem_plan(ny, nc, elem, block), 0)
    return GlobalPlan("scratch", CUDA_BLOCK, 0,
                      _scratch_plan(ny, nc, params.max_segments, elem, CUDA_BLOCK))


def global_scratch_bytes(ny: int, params: LTParams, dtype: torch.dtype = torch.float32,
                         px: int = 1) -> int:
    """Bytes of device-memory scratch one launch of the global form's
    scratch tier needs for ``px`` pixels at ``ny`` years and ``params``'
    candidates."""
    return _scratch_plan(ny, params.max_candidates, params.max_segments, _elem(dtype), px)


def global_chunk(ny: int, params: LTParams, dtype: torch.dtype = torch.float32,
                 budget: "int | None" = None) -> int:
    """Pixels per launch of the global form's scratch tier: the most, a
    multiple of :data:`CUDA_BLOCK`, whose scratch stays within ``budget``
    bytes (default :data:`GLOBAL_SCRATCH_BUDGET`); raises
    :class:`ValueError` when not even one block's fits."""
    budget = GLOBAL_SCRATCH_BUDGET if budget is None else budget
    per_block = global_scratch_bytes(ny, params, dtype, CUDA_BLOCK)
    if per_block > budget:
        raise ValueError(
            f"one block of {CUDA_BLOCK} px at NY={ny} needs {per_block:,} B of scratch; "
            f"the budget is {budget:,} B"
        )
    # the scratch is whole blocks' regions: the plan is linear in the blocks
    return budget // per_block * CUDA_BLOCK


def smem_bytes(ny: int, dtype: torch.dtype = torch.float32, block: "int | None" = None,
               cap: str = "narrow", nc: "int | None" = None) -> int:
    """Dynamic shared-memory bytes per block of both kernels of
    instantiation ``cap`` at ``ny`` years for ``dtype`` values and
    ``block`` threads (default: the instantiation's block for the dtype,
    :func:`block_of`); raises :class:`ValueError` when a block may not
    hold that much on sm_90 (more than :data:`SMEM_LIMIT` bytes).  The
    global form's block also holds the valid-year words and follows the
    candidates ``nc`` (required; its block defaults to :func:`global_plan`'s
    shared tier, and a shape only the scratch tier holds raises)."""
    elem = _elem(dtype)
    if cap == "global":
        if nc is None:
            raise ValueError("the global form's shared memory follows the candidates: pass nc")
        if ny < 1:
            raise ValueError(f"NY={ny}: a series needs a year")
        block = block or _global_block(ny, elem, nc)
        n = _global_smem_plan(ny, nc, elem, block or 32)
    else:
        block = block_of(dtype, cap) if block is None else block
        max_ny = CAPS[cap][0]
        if not 1 <= ny <= max_ny:
            raise ValueError(f"NY={ny} outside the {cap} kernel's 1..{max_ny}-year capacity")
        n = _smem_plan(ny, elem, block, CAPS[cap][1])
    if n > SMEM_LIMIT or not block:
        raise ValueError(
            f"a block of {block or 32} threads at NY={ny} ({dtype}) needs {n:,} B of shared "
            f"memory; a block may hold {SMEM_LIMIT:,} B"
        )
    return n


def _check(years: torch.Tensor, values: torch.Tensor, mask: torch.Tensor) -> None:
    """Validate what the kernel (and its plain version) accept."""
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values must be float32 or float64; got {values.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool; got {mask.dtype}")
    if values.dim() != 2 or tuple(mask.shape) != tuple(values.shape):
        raise ValueError(
            f"values and mask must be matching (PX, NY); got "
            f"{tuple(values.shape)} and {tuple(mask.shape)}"
        )
    ny = values.shape[1]
    if years.dim() != 1 or years.shape[0] != ny:
        raise ValueError(f"years must be ({ny},); got {tuple(years.shape)}")
    if not (values.is_contiguous() and mask.is_contiguous()):
        raise ValueError("values and mask must be contiguous")
    if values.device != mask.device:
        raise ValueError(f"values on {values.device}, mask on {mask.device}")


def _kernel_years(years: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The year axis as the kernels read it: NY values of the values' dtype
    on their device (the only copy a wrapper makes of its inputs)."""
    return years.to(device=values.device, dtype=values.dtype).contiguous()


def _plan_cap(ny: int, params: LTParams, cap: "str | None") -> str:
    """The instantiation a launch uses: ``cap`` when given (tests and the
    smoke force one; it must hold the shape), else :func:`instantiation`."""
    if cap is None:
        return instantiation(ny, params)
    if cap not in CAPS:
        raise ValueError(f"cap {cap!r} is not one of {sorted(CAPS)}")
    if not _holds(cap, ny, params):
        raise ValueError(
            f"the {cap} kernel holds {CAPS[cap][0]} years and {CAPS[cap][1]} candidates; "
            f"got NY={ny} and {params.max_candidates}"
        )
    return cap


class _Scratch:
    """The global form's scratch tier for one call: allocated once for the
    largest piece, and the pieces each launch takes (:func:`global_chunk`
    pixels, the last one ragged)."""

    def __init__(self, ny: int, params: LTParams, dtype: torch.dtype, px: int, device):
        self.chunk = global_chunk(ny, params, dtype)
        self.tensor = torch.empty(
            global_scratch_bytes(ny, params, dtype, min(px, self.chunk)),
            dtype=torch.uint8, device=device,
        )

    def pieces(self, start: int, count: int):
        """``(start, count)`` of each launch over pixels ``[start, start +
        count)``."""
        for s in range(start, start + count, self.chunk):
            yield s, min(self.chunk, start + count - s)


class _Planned:
    """The form of one call of either kernel and its plan: ``cap`` forces a
    form (tests, the smoke) and ``_tier`` the global form's tier (the test
    hook of :func:`global_plan`)."""

    def _plan(self, values, params: LTParams, cap: "str | None", _tier: "str | None") -> None:
        self.dtype = values.dtype
        self.params = params
        self.px, self.ny = values.shape
        self.cap = _plan_cap(self.ny, params, cap)
        if _tier is not None and self.cap != "global":
            raise ValueError(f"tier {_tier!r} is the global form's; the form is {self.cap}")
        self.plan = (global_plan(self.ny, params, self.dtype, _tier=_tier)
                     if self.cap == "global" else None)
        self.block = self.plan.block if self.plan else block_of(self.dtype, self.cap)
        self.smem = self.plan.smem if self.plan else smem_bytes(self.ny, self.dtype, cap=self.cap)
        self.scratch = (
            _Scratch(self.ny, params, self.dtype, self.px, values.device)
            if self.plan and self.plan.tier == "scratch" else None
        )

    def _global_args(self, block: "int | None" = None) -> list:
        """The global form's (scratch, block, tier) after the stream."""
        return [None if self.scratch is None else self.scratch.tensor.data_ptr(),
                self.block if block is None else block, int(self.scratch is not None)]

    def _pieces(self, start: int, count: int):
        return [(start, count)] if self.scratch is None else self.scratch.pieces(start, count)


class _Launch(_Planned):
    """Inputs and pixel-major outputs of one (possibly chunked) kernel call:
    the kernel reads the caller's ``values`` and ``mask`` themselves."""

    def __init__(self, years, values, mask, params: LTParams, cap: "str | None" = None, *,
                 _tier: "str | None" = None):
        dev = values.device
        self._plan(values, params, cap, _tier)
        px, ny = self.px, self.ny
        self.years = _kernel_years(years, values)
        self.values, self.mask = values, mask
        nv, nm = params.max_vertices, params.max_segments

        def out(*shape, dt=self.dtype):
            return torch.empty((px, *shape), dtype=dt, device=dev)

        i32 = torch.int32
        self.outs = [
            out(ny), out(ny), out(dt=i32), out(nv, dt=i32), out(nv), out(nv), out(nv),
            out(nm), out(nm), out(nm), out(), out(), out(dt=torch.bool),
        ]

    def run(self, start: int, count: int, op_count: "torch.Tensor | None" = None,
            cycles: "torch.Tensor | None" = None, block: "int | None" = None) -> None:
        """Launch the kernel on pixels ``[start, start + count)`` (the
        global form: one launch per scratch-sized piece); with
        ``op_count`` (int64, PX) the float32 kernel also writes each
        pixel's floating-point operation tally there, with ``cycles``
        (int64, PX x (len(STAGES) + 1)) each pixel's cycles per stage and
        their total; ``block`` (one of :data:`SWEEP`, of :data:`GLOBAL_SWEEP`
        for the global form) runs the float32 kernel at that block size.
        Those three are float32 only, stage cycles and the sweep are the
        narrow and global forms' only, and the global form's three are its
        shared tier's."""
        if self.dtype != torch.float32 and (
                op_count is not None or cycles is not None or block is not None):
            raise ValueError(
                f"op counts, stage cycles and the block sweep are float32 kernels; "
                f"values are {self.dtype}")
        if self.cap == "wide" and (cycles is not None or block is not None):
            raise ValueError("stage cycles and the block sweep are the narrow and global "
                             "kernels'; the wide kernel has neither")
        if self.scratch is not None and (
                op_count is not None or cycles is not None or block is not None):
            raise ValueError("op counts, stage cycles and the block sweep are the global "
                             "form's shared tier's; this shape takes its scratch tier")
        sweep = GLOBAL_SWEEP if self.cap == "global" else SWEEP
        if block is not None and block not in sweep:
            raise ValueError(f"block {block} is not one of the sweep's {sweep}")
        if self.plan is not None and block is not None:
            # raises when a block of that size cannot hold the shape
            smem_bytes(self.ny, self.dtype, block, "global", self.params.max_candidates)
        lib = load_library()
        form = "" if self.cap == "narrow" else f"_{self.cap}"
        fn = getattr(lib, f"lt_segment_fused{form}_{'f64' if self.dtype == torch.float64 else 'f32'}")
        record = None  # a per-pixel record the kernel writes
        if op_count is not None:
            fn, record = getattr(lib, f"lt_segment_fused{form}_f32_opcount"), op_count
        elif cycles is not None:
            fn, record = getattr(lib, f"lt_segment_fused{form}_f32_stagecycles"), cycles
        elif block is not None and self.plan is None:
            fn = lib.lt_segment_fused_f32_block
        for first, n in self._pieces(start, count):
            tail = [_at(record, first)] if record is not None else []
            if self.plan is not None:
                tail = [*self._global_args(block), *tail]
            elif block is not None:
                tail = [block]
            self._launch(fn, first, n, tail)

    def _launch(self, fn, start: int, count: int, extra: list) -> None:
        """One launch of ``fn`` on pixels ``[start, start + count)``, with
        ``extra`` after the stream."""
        global LAUNCHES, WIDE_LAUNCHES, GLOBAL_LAUNCHES
        p = self.params
        stream = torch.cuda.current_stream(self.values.device).cuda_stream
        with nvtx_range("lt_segment_fused"):
            rc = fn(
                self.years.data_ptr(), _at(self.values, start), _at(self.mask, start),
                count, self.ny,
                *(_at(o, start) for o in self.outs),
                p.max_segments, p.vertex_count_overshoot, float(p.spike_threshold),
                float(p.recovery_threshold), int(bool(p.prevent_one_year_recovery)),
                float(p.p_val_threshold), float(p.best_model_proportion),
                int(p.min_observations_needed), lentz_iters(self.ny),
                stream, *extra,
            )
        if rc != 0:
            raise RuntimeError(f"segment_fused ({self.cap}) launch failed: CUDA error {rc}")
        if self.cap == "global":
            GLOBAL_LAUNCHES += 1
        elif self.cap == "wide":
            WIDE_LAUNCHES += 1
        else:
            LAUNCHES += 1

    def result(self) -> SegOutputs:
        """The tensors the kernel wrote, as they are."""
        (desp, fit, nvert, vidx, vyear, vsrc, vfit, smag, sdur, srate, rmse, pof, mv) = self.outs
        return SegOutputs(
            n_vertices=nvert,
            vertex_indices=vidx,
            vertex_years=vyear,
            vertex_src_vals=vsrc,
            vertex_fit_vals=vfit,
            seg_magnitude=smag,
            seg_duration=sdur,
            seg_rate=srate,
            rmse=rmse,
            p_of_f=pof,
            model_valid=mv,
            fitted=fit,
            despiked=desp,
        )


def _at(a: torch.Tensor, start: int) -> int:
    """Address of row ``start`` of a row-major tensor."""
    return a.data_ptr() + start * a.stride(0) * a.element_size()


def _col(a: torch.Tensor, start: int) -> int:
    """Address of column ``start`` of a tensor whose last axis is the
    pixels (the family kernel's year-major outputs)."""
    return a.data_ptr() + start * a.element_size()


def cuda_segment_pixels(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
) -> SegOutputs:
    """Segment a ``(PX, NY)`` batch with the fused kernel — one launch
    (the global form: one per :func:`global_chunk` pixels).

    ``values`` is float32 (the production path) or float64 (for holding
    the kernel's decisions exactly against the plain version), ``mask``
    bool, both contiguous; :func:`instantiation` picks the narrow, wide or
    global kernel from NY and the candidates.  CUDA tensors launch the
    kernel; CPU tensors run the plain PyTorch version.
    """
    _check(years, values, mask)
    if values.device.type != "cuda":
        return torch_segment_pixels(years, values, mask, params)
    with torch.cuda.device(values.device):
        job = _Launch(years, values, mask, params)
        job.run(0, values.shape[0])
        return job.result()


def cuda_segment_pixels_chunked(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
    chunk: int = 262144,
) -> SegOutputs:
    """:func:`cuda_segment_pixels` as one launch per ``chunk`` pixels.

    The launches write into slices of outputs allocated once, so device
    memory beyond inputs and outputs stays bounded by the chunk.  PX must
    be a multiple of ``chunk``, and ``chunk`` a multiple of
    :data:`CUDA_BLOCK` when it is larger than the block.  Results equal
    the unchunked call exactly (every pixel is independent).
    """
    _check(years, values, mask)
    px = values.shape[0]
    if chunk < 1 or px % chunk:
        raise ValueError(f"pixel count {px} not a multiple of chunk {chunk}; pad first")
    if chunk > CUDA_BLOCK and chunk % CUDA_BLOCK:
        raise ValueError(
            f"chunk={chunk} must be a multiple of the CUDA block ({CUDA_BLOCK})"
        )
    if values.device.type != "cuda":
        return torch_segment_pixels_chunked(years, values, mask, params, chunk)
    with torch.cuda.device(values.device):
        job = _Launch(years, values, mask, params)
        for start in range(0, px, chunk):
            job.run(start, chunk)
        return job.result()


def cuda_segment_op_counts(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
) -> torch.Tensor:
    """Per-pixel floating-point operation counts of the float32 kernel on
    these inputs (int64, PX) — what this data needs, early exits included;
    the operation side of the kernel's roofline bound.  CUDA tensors only.
    """
    _check(years, values, mask)
    if values.dtype != torch.float32 or values.device.type != "cuda":
        raise ValueError("op counts come from the float32 kernel on CUDA tensors")
    with torch.cuda.device(values.device):
        job = _Launch(years, values, mask, params)
        counts = torch.zeros(values.shape[0], dtype=torch.int64, device=values.device)
        job.run(0, values.shape[0], op_count=counts)
        return counts


def cuda_segment_stage_cycles(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
    cap: "str | None" = None,
) -> torch.Tensor:
    """Per-pixel ``clock64()`` cycles of each stage of the float32 fused
    kernel on these inputs: int64 ``(PX, len(STAGES) + 1)``, the stages'
    columns in the order of :data:`STAGES`, then their total (the thread's
    cycles from kernel entry to its last stage mark).  A stage a pixel
    skips counts 0; the output stage includes the block's staging barriers.
    The form is picked as a launch picks it (``cap`` forces one); the
    narrow and global forms have the entry, the wide one not.  CUDA
    tensors only."""
    _check(years, values, mask)
    if values.dtype != torch.float32 or values.device.type != "cuda":
        raise ValueError("stage cycles come from the float32 kernel on CUDA tensors")
    with torch.cuda.device(values.device):
        job = _Launch(years, values, mask, params, cap=cap)
        cycles = torch.zeros((values.shape[0], len(STAGES) + 1), dtype=torch.int64,
                             device=values.device)
        job.run(0, values.shape[0], cycles=cycles)
        return cycles


def occupancy(kernel: str = "fused", dtype: torch.dtype = torch.float32, ny: int = 40,
              block: "int | None" = None, cap: str = "narrow", nc: "int | None" = None) -> dict:
    """Resident blocks and warps per SM of ``kernel`` ("fused" or
    "family") of instantiation ``cap`` at ``ny`` years (CUDA occupancy
    calculator), with the block size and its dynamic shared-memory bytes.
    ``block`` defaults to the instantiation's (:func:`block_of`); others:
    the narrow float32 fused kernel of the sweep only.  The global form is
    its shared tier at ``nc`` candidates (required), at any block of
    :data:`GLOBAL_SWEEP` that holds the shape (default :func:`global_plan`'s)."""
    lib = load_library()
    smem = smem_bytes(ny, dtype, block, cap, nc)
    if block is None:
        block = (_global_block(ny, _elem(dtype), nc) if cap == "global"
                 else block_of(dtype, cap))
    blocks = ctypes.c_int(0)
    which = {"fused": 0, "family": 1}[kernel]
    f64 = int(dtype == torch.float64)
    if cap == "global":
        rc = lib.lt_segment_global_occupancy(which, f64, ny, nc, block, ctypes.addressof(blocks))
    else:
        rc = lib.lt_segment_occupancy(which, f64, ny, block, _CAP_CODES.index(cap),
                                      ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return {
        "kernel": kernel,
        "cap": cap,
        "dtype": str(dtype).replace("torch.", ""),
        "block": block,
        "smem_bytes": smem,
        "blocks_per_sm": blocks.value,
        "warps_per_sm": blocks.value * block // 32,
    }


def kernel_attributes() -> "list[dict]":
    """Registers a thread and local (stack) bytes of every production
    instantiation of both kernels (``cudaFuncGetAttributes``; the global
    form's two tiers as ``global`` and ``global_scratch``), with its static
    shared bytes and its most threads a block: one dict each."""
    lib = load_library()
    rows = []
    for kernel, which in (("fused", 0), ("family", 1)):
        for cap, fn, code in (("narrow", lib.lt_segment_kernel_attrs, 0),
                              ("wide", lib.lt_segment_kernel_attrs, 1),
                              ("global", lib.lt_segment_global_kernel_attrs, 0),
                              ("global_scratch", lib.lt_segment_global_kernel_attrs, 1)):
            for dtype in (torch.float32, torch.float64):
                out = (ctypes.c_int * 4)()
                rc = fn(which, int(dtype == torch.float64), code, ctypes.addressof(out))
                if rc != 0:
                    raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
                rows.append({"kernel": kernel, "cap": cap,
                             "dtype": str(dtype).replace("torch.", ""),
                             "registers": out[0], "local_bytes": out[1],
                             "static_shared_bytes": out[2], "max_threads": out[3]})
    return rows


class _FamilyLaunch(_Planned):
    """Inputs and year-major outputs of one family-kernel call: the kernel
    reads the caller's ``values`` and ``mask`` themselves."""

    def __init__(self, years, values, mask, params: LTParams, cap: "str | None" = None, *,
                 _tier: "str | None" = None):
        dev = values.device
        self._plan(values, params, cap, _tier)
        px, ny = self.px, self.ny
        self.years = _kernel_years(years, values)
        self.values, self.mask = values, mask
        nm = params.max_segments
        # one row per (year) / (member, year) / (member): a warp's stores
        # to a row are contiguous
        self.despiked = torch.empty((ny, px), dtype=self.dtype, device=dev)
        self.vmasks = torch.empty((nm, ny, px), dtype=torch.bool, device=dev)
        self.sses = torch.empty((nm, px), dtype=self.dtype, device=dev)

    def run(self, op_count: "torch.Tensor | None" = None) -> None:
        """Launch the family kernel on every pixel (the global form: one
        launch per scratch-sized piece); with ``op_count`` (int64, PX) the
        float32 kernel also writes each pixel's floating-point operation
        tally there."""
        global FAMILY_LAUNCHES, WIDE_FAMILY_LAUNCHES, GLOBAL_FAMILY_LAUNCHES
        lib = load_library()
        form = "" if self.cap == "narrow" else f"_{self.cap}"
        fn = getattr(lib, f"lt_family_stats{form}_{'f64' if self.dtype == torch.float64 else 'f32'}")
        if op_count is not None:
            if self.scratch is not None:
                raise ValueError("op counts are the global form's shared tier's; this shape "
                                 "takes its scratch tier")
            fn = getattr(lib, f"lt_family_stats{form}_f32_opcount")
        p = self.params
        stream = torch.cuda.current_stream(self.values.device).cuda_stream
        for start, count in self._pieces(0, self.px):
            extra = [] if self.plan is None else self._global_args()
            if op_count is not None:
                extra.append(_at(op_count, start))
            # a piece writes columns [start, start + count) of the
            # year-major outputs, whose rows stay PX long
            with nvtx_range("lt_family_stats"):
                rc = fn(
                    self.years.data_ptr(), _at(self.values, start), _at(self.mask, start),
                    count, self.ny,
                    _col(self.despiked, start), _col(self.vmasks, start),
                    _col(self.sses, start), self.px,
                    p.max_segments, p.vertex_count_overshoot, float(p.spike_threshold),
                    float(p.recovery_threshold), int(bool(p.prevent_one_year_recovery)),
                    stream, *extra,
                )
            if rc != 0:
                raise RuntimeError(f"family_stats ({self.cap}) launch failed: CUDA error {rc}")
            if self.cap == "global":
                GLOBAL_FAMILY_LAUNCHES += 1
            elif self.cap == "wide":
                WIDE_FAMILY_LAUNCHES += 1
            else:
                FAMILY_LAUNCHES += 1

    def result(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(despiked (PX, NY), vmasks (PX, NM, NY) bool, sses (PX, NM))``
        as permuted views of the year-major outputs."""
        return self.despiked.t(), self.vmasks.permute(2, 0, 1), self.sses.t()


def cuda_family_stats(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stages 1–4a with the family kernel — one launch (the global form:
    one per :func:`global_chunk` pixels).

    Returns ``(despiked, vmasks, sses)`` in the layout of
    :func:`~land_trendr_tpu_torch.ops.segment.torch_family_stats` (the
    device outputs are year-major; these are permuted views of them).
    Inputs as for :func:`cuda_segment_pixels`.  CUDA tensors launch the
    kernel; CPU tensors run the plain PyTorch version.
    """
    _check(years, values, mask)
    if values.device.type != "cuda":
        return torch_family_stats(years, values, mask, params)
    with torch.cuda.device(values.device):
        job = _FamilyLaunch(years, values, mask, params)
        job.run()
        return job.result()


def cuda_family_op_counts(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
) -> torch.Tensor:
    """Per-pixel floating-point operation counts of the float32 family
    kernel on these inputs (int64, PX) — the operation side of its
    roofline bound.  CUDA tensors only.
    """
    _check(years, values, mask)
    if values.dtype != torch.float32 or values.device.type != "cuda":
        raise ValueError("op counts come from the float32 kernel on CUDA tensors")
    with torch.cuda.device(values.device):
        job = _FamilyLaunch(years, values, mask, params)
        counts = torch.zeros(values.shape[0], dtype=torch.int64, device=values.device)
        job.run(op_count=counts)
        return counts
