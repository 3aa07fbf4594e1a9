"""Wrappers of the LandTrendr CUDA kernels (``csrc/segment_fused.cu``).

Counterpart of ``land_trendr_tpu/ops/segment_pallas.py``:
:func:`cuda_segment_pixels` replaces ``jax_segment_pixels_pallas`` and
:func:`cuda_segment_pixels_chunked` replaces
``jax_segment_pixels_pallas_chunked``, with the same output contract
(:class:`~land_trendr_tpu_torch.ops.segment.SegOutputs`);
:func:`cuda_family_stats` replaces ``family_stats_pallas`` (stages 1–4a:
despiked series, family vertex sets, SSEs).

* **Build.**  The kernel is compiled at first use with ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface
  (``land_trendr_tpu_torch/_build/``, named by the source's hash, so an
  edited source is rebuilt) and loaded with :mod:`ctypes`.  Nothing is
  built or imported when this module is imported.
* **Launch.**  The kernel runs on PyTorch's current stream of the input's
  device, one thread per pixel.  It reads the caller's pixel-major
  ``(PX, NY)`` values and bool mask as they are (no transposed or cleaned
  copy: the kernel tests ``isfinite`` itself) and the fused kernel writes
  its outputs pixel-major, so :class:`SegOutputs` holds the tensors the
  kernel wrote.  Each block brings its contiguous slab into shared memory
  (:func:`smem_bytes` is its plan).  The C entry returns
  ``cudaGetLastError()`` and the wrapper raises on a non-zero code.  Every
  launch of the fused kernel adds one to :data:`LAUNCHES`, every launch of
  the family kernel one to :data:`FAMILY_LAUNCHES`, and nothing else does.
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
    "CUDA_BLOCK",
    "FAMILY_LAUNCHES",
    "LAUNCHES",
    "MAX_NC",
    "MAX_NY",
    "SMEM_LIMIT",
    "STAGES",
    "SWEEP",
    "build_info",
    "cuda_family_op_counts",
    "cuda_family_stats",
    "cuda_segment_op_counts",
    "cuda_segment_pixels",
    "cuda_segment_pixels_chunked",
    "cuda_segment_stage_cycles",
    "load_library",
    "occupancy",
    "smem_bytes",
]

#: the chunk granule: a chunk larger than this must be a multiple of it
#: (the counterpart of the Pallas block of the JAX package), and every
#: kernel block is a multiple of it
CUDA_BLOCK = 128
#: threads per block of both kernels by value dtype: float32, the timed
#: path, at the fastest block of the sweep that holds NY = 64 in shared
#: memory; float64 at 128, for the same reason
BLOCKS = {torch.float32: 256, torch.float64: 128}
#: block sizes of the float32 fused kernel's block-size sweep: the
#: float64 block, the float32 block, and the largest that holds NY = 40
SWEEP = (128, 256, 512)
#: shared-memory bytes one block may use on sm_90
SMEM_LIMIT = 232_448
#: compile-time capacity bounds of the kernel (checked before a launch)
MAX_NY = 64
MAX_NC = 16

#: the fused kernel's stages, in the order of the columns of
#: :func:`cuda_segment_stage_cycles`
STAGES = (
    "load_compact", "despike", "candidates_cull", "family_fits", "scoring_selection",
    "refit_output",
)

#: fused-kernel launches made by this process — one per launch, counted
#: where the kernel is launched and nowhere else
LAUNCHES = 0
#: family-kernel launches made by this process, counted the same way
FAMILY_LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "segment_fused.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

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
        tmp = _BUILD_DIR / f".tmp_{os.getpid()}_{lib.name}"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        info["build_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {_SRC.name}:\n"
                f"{proc.stderr[-4000:]}"
            )
        log_tmp = log_path.with_suffix(".txt.tmp")
        log_tmp.write_text(proc.stderr)
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
    for name in ("lt_segment_fused_f32", "lt_segment_fused_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    for name in ("lt_segment_fused_f32_opcount", "lt_segment_fused_f32_stagecycles"):
        getattr(lib, name).argtypes = [*_ARGTYPES, _P]
        getattr(lib, name).restype = ctypes.c_int
    lib.lt_segment_fused_f32_block.argtypes = [*_ARGTYPES, _I]
    lib.lt_segment_fused_f32_block.restype = ctypes.c_int
    lib.lt_segment_occupancy.argtypes = [_I, _I, _I, _I, _P]
    lib.lt_segment_occupancy.restype = ctypes.c_int
    lib.lt_segment_smem_bytes.argtypes = [_I, _I, _I]
    lib.lt_segment_smem_bytes.restype = ctypes.c_longlong
    for name in ("lt_family_stats_f32", "lt_family_stats_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _FAMILY_ARGTYPES
        fn.restype = ctypes.c_int
    lib.lt_family_stats_f32_opcount.argtypes = [*_FAMILY_ARGTYPES, _P]
    lib.lt_family_stats_f32_opcount.restype = ctypes.c_int
    for name in ("lt_segment_max_ny", "lt_segment_max_nc", "lt_segment_nstage"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.lt_segment_block.restype = ctypes.c_int
    lib.lt_segment_block.argtypes = [_I]
    caps = (lib.lt_segment_max_ny(), lib.lt_segment_max_nc(), lib.lt_segment_nstage(),
            lib.lt_segment_block(4), lib.lt_segment_block(8))
    want = (MAX_NY, MAX_NC, len(STAGES), BLOCKS[torch.float32], BLOCKS[torch.float64])
    if caps != want:
        raise RuntimeError(f"kernel capacities {caps} != wrapper's {want}")
    for ny in (1, 2, 40, MAX_NY):
        for elem in (4, 8):
            for block in SWEEP:
                got = lib.lt_segment_smem_bytes(ny, elem, block)
                if got != _smem_plan(ny, elem, block):
                    raise RuntimeError(
                        f"kernel's shared-memory plan {got} B (ny={ny}, {elem}-byte values, "
                        f"block {block}) != wrapper's {_smem_plan(ny, elem, block)} B"
                    )
    return lib


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


def _smem_plan(ny: int, elem: int, block: int) -> int:
    """Dynamic shared-memory bytes of one block (``smem_bytes`` in the
    source): a 16-byte mbarrier, the year axis rounded up to 16 bytes, the
    y columns (NY per thread; the mask slab lands there), and the t
    columns (W = max(NY, MAX_NC) | 1 per thread; the value slab lands
    there and the output staging tile reuses them)."""
    width = max(ny, MAX_NC) | 1
    return 16 + (ny * elem + 15) // 16 * 16 + block * (ny + width) * elem


def smem_bytes(ny: int, dtype: torch.dtype = torch.float32, block: "int | None" = None) -> int:
    """Dynamic shared-memory bytes per block of both kernels at ``ny``
    years for ``dtype`` values and ``block`` threads (default: the
    dtype's block, :data:`BLOCKS`); raises :class:`ValueError` when a block
    may not hold that much on sm_90 (more than :data:`SMEM_LIMIT` bytes)."""
    if dtype not in BLOCKS:
        raise TypeError(f"values must be float32 or float64; got {dtype}")
    block = BLOCKS[dtype] if block is None else block
    if not 1 <= ny <= MAX_NY:
        raise ValueError(f"NY={ny} outside the kernel's 1..{MAX_NY}-year capacity")
    n = _smem_plan(ny, 8 if dtype == torch.float64 else 4, block)
    if n > SMEM_LIMIT:
        raise ValueError(
            f"a block of {block} threads at NY={ny} ({dtype}) needs {n:,} B of shared "
            f"memory; a block may hold {SMEM_LIMIT:,} B"
        )
    return n


def _check(years: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
           params: LTParams) -> None:
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
    if ny > MAX_NY:
        raise ValueError(f"NY={ny} exceeds the kernel's {MAX_NY}-year capacity")
    if params.max_candidates > MAX_NC:
        raise ValueError(
            f"max_segments + 1 + vertex_count_overshoot = {params.max_candidates} "
            f"exceeds the kernel's candidate capacity {MAX_NC}"
        )
    if values.device != mask.device:
        raise ValueError(f"values on {values.device}, mask on {mask.device}")


def _kernel_years(years: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The year axis as the kernels read it: NY values of the values' dtype
    on their device (the only copy a wrapper makes of its inputs)."""
    return years.to(device=values.device, dtype=values.dtype).contiguous()


class _Launch:
    """Inputs and pixel-major outputs of one (possibly chunked) kernel call:
    the kernel reads the caller's ``values`` and ``mask`` themselves."""

    def __init__(self, years, values, mask, params: LTParams):
        dev = values.device
        self.dtype = values.dtype
        self.params = params
        px, ny = values.shape
        self.px, self.ny = px, ny
        self.smem = smem_bytes(ny, values.dtype)
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
        """Launch the kernel on pixels ``[start, start + count)``; with
        ``op_count`` (int64, PX) the float32 kernel also writes each
        pixel's floating-point operation tally there, with ``cycles``
        (int64, PX x (len(STAGES) + 1)) each pixel's cycles per stage and
        their total; ``block`` (one of :data:`SWEEP`) runs the float32
        kernel built for that block size.  Those three are float32 only."""
        global LAUNCHES
        if self.dtype != torch.float32 and (
                op_count is not None or cycles is not None or block is not None):
            raise ValueError(
                f"op counts, stage cycles and the block sweep are float32 kernels; "
                f"values are {self.dtype}")
        if block is not None and block not in SWEEP:
            raise ValueError(f"block {block} is not one of the sweep's {SWEEP}")
        lib = load_library()
        fn = lib.lt_segment_fused_f64 if self.dtype == torch.float64 else lib.lt_segment_fused_f32
        extra = ()
        if op_count is not None:
            fn = lib.lt_segment_fused_f32_opcount
            extra = (_at(op_count, start),)
        elif cycles is not None:
            fn = lib.lt_segment_fused_f32_stagecycles
            extra = (_at(cycles, start),)
        elif block is not None:
            fn = lib.lt_segment_fused_f32_block
            extra = (block,)
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
            raise RuntimeError(f"segment_fused launch failed: CUDA error {rc}")
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


def cuda_segment_pixels(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
) -> SegOutputs:
    """Segment a ``(PX, NY)`` batch with the fused kernel — one launch.

    ``values`` is float32 (the production path) or float64 (for holding
    the kernel's decisions exactly against the plain version), ``mask``
    bool, both contiguous; NY is at most 64.  CUDA tensors launch the
    kernel; CPU tensors run the plain PyTorch version.
    """
    _check(years, values, mask, params)
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
    _check(years, values, mask, params)
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
    _check(years, values, mask, params)
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
) -> torch.Tensor:
    """Per-pixel ``clock64()`` cycles of each stage of the float32 fused
    kernel on these inputs: int64 ``(PX, len(STAGES) + 1)``, the stages'
    columns in the order of :data:`STAGES`, then their total (the thread's
    cycles from kernel entry to its last stage mark).  A stage a pixel
    skips counts 0; the output stage includes the block's staging barriers.
    CUDA tensors only."""
    _check(years, values, mask, params)
    if values.dtype != torch.float32 or values.device.type != "cuda":
        raise ValueError("stage cycles come from the float32 kernel on CUDA tensors")
    with torch.cuda.device(values.device):
        job = _Launch(years, values, mask, params)
        cycles = torch.zeros((values.shape[0], len(STAGES) + 1), dtype=torch.int64,
                             device=values.device)
        job.run(0, values.shape[0], cycles=cycles)
        return cycles


def occupancy(kernel: str = "fused", dtype: torch.dtype = torch.float32, ny: int = 40,
              block: "int | None" = None) -> dict:
    """Resident blocks and warps per SM of ``kernel`` ("fused" or
    "family") at ``ny`` years (CUDA occupancy calculator), with the block
    size and its dynamic shared-memory bytes.  ``block`` defaults to the
    dtype's (:data:`BLOCKS`); others: the float32 fused kernel of the
    sweep only."""
    lib = load_library()
    block = BLOCKS[dtype] if block is None else block
    blocks = ctypes.c_int(0)
    which = {"fused": 0, "family": 1}[kernel]
    f64 = int(dtype == torch.float64)
    rc = lib.lt_segment_occupancy(which, f64, ny, block, ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return {
        "kernel": kernel,
        "dtype": str(dtype).replace("torch.", ""),
        "block": block,
        "smem_bytes": smem_bytes(ny, dtype, block),
        "blocks_per_sm": blocks.value,
        "warps_per_sm": blocks.value * block // 32,
    }


class _FamilyLaunch:
    """Inputs and year-major outputs of one family-kernel call: the kernel
    reads the caller's ``values`` and ``mask`` themselves."""

    def __init__(self, years, values, mask, params: LTParams):
        dev = values.device
        self.dtype = values.dtype
        self.params = params
        px, ny = values.shape
        self.px, self.ny = px, ny
        self.smem = smem_bytes(ny, values.dtype)
        self.years = _kernel_years(years, values)
        self.values, self.mask = values, mask
        nm = params.max_segments
        # one row per (year) / (member, year) / (member): a warp's stores
        # to a row are contiguous
        self.despiked = torch.empty((ny, px), dtype=self.dtype, device=dev)
        self.vmasks = torch.empty((nm, ny, px), dtype=torch.bool, device=dev)
        self.sses = torch.empty((nm, px), dtype=self.dtype, device=dev)

    def run(self, op_count: "torch.Tensor | None" = None) -> None:
        """Launch the family kernel on every pixel; with ``op_count``
        (int64, PX) the float32 kernel also writes each pixel's
        floating-point operation tally there."""
        global FAMILY_LAUNCHES
        lib = load_library()
        fn = lib.lt_family_stats_f64 if self.dtype == torch.float64 else lib.lt_family_stats_f32
        extra = ()
        if op_count is not None:
            fn = lib.lt_family_stats_f32_opcount
            extra = (op_count.data_ptr(),)
        p = self.params
        stream = torch.cuda.current_stream(self.values.device).cuda_stream
        with nvtx_range("lt_family_stats"):
            rc = fn(
                self.years.data_ptr(), self.values.data_ptr(), self.mask.data_ptr(),
                self.px, self.ny,
                self.despiked.data_ptr(), self.vmasks.data_ptr(), self.sses.data_ptr(),
                self.px,
                p.max_segments, p.vertex_count_overshoot, float(p.spike_threshold),
                float(p.recovery_threshold), int(bool(p.prevent_one_year_recovery)),
                stream, *extra,
            )
        if rc != 0:
            raise RuntimeError(f"family_stats launch failed: CUDA error {rc}")
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
    """Stages 1–4a with the family kernel — one launch.

    Returns ``(despiked, vmasks, sses)`` in the layout of
    :func:`~land_trendr_tpu_torch.ops.segment.torch_family_stats` (the
    device outputs are year-major; these are permuted views of them).
    Inputs as for :func:`cuda_segment_pixels`.  CUDA tensors launch the
    kernel; CPU tensors run the plain PyTorch version.
    """
    _check(years, values, mask, params)
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
    _check(years, values, mask, params)
    if values.dtype != torch.float32 or values.device.type != "cuda":
        raise ValueError("op counts come from the float32 kernel on CUDA tensors")
    with torch.cuda.device(values.device):
        job = _FamilyLaunch(years, values, mask, params)
        counts = torch.zeros(values.shape[0], dtype=torch.int64, device=values.device)
        job.run(op_count=counts)
        return counts
