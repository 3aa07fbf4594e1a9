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
  device, one thread per pixel; the C entry returns ``cudaGetLastError()``
  and the wrapper raises on a non-zero code.  Every launch of the fused
  kernel adds one to :data:`LAUNCHES`, every launch of the family kernel
  one to :data:`FAMILY_LAUNCHES`, and nothing else does.
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

__all__ = [
    "CUDA_BLOCK",
    "FAMILY_LAUNCHES",
    "LAUNCHES",
    "MAX_NC",
    "MAX_NY",
    "build_info",
    "cuda_family_op_counts",
    "cuda_family_stats",
    "cuda_segment_op_counts",
    "cuda_segment_pixels",
    "cuda_segment_pixels_chunked",
    "load_library",
]

#: threads per block of the kernel; a chunk larger than this must be a
#: multiple of it (the counterpart of the Pallas block of the JAX package)
CUDA_BLOCK = 128
#: compile-time capacity bounds of the kernel (checked before a launch)
MAX_NY = 64
MAX_NC = 16

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
    _P, _P, _P, _LL, _LL, _I,                 # years, values, mask, px, in_ld, ny
    _P, _P, _P, _P, _P, _P, _P,               # despiked .. vertex_fit_vals
    _P, _P, _P, _P, _P, _P, _LL,              # seg_* , rmse, p_of_f, model_valid, out_ld
    _I, _I, _D, _D, _I, _D, _D, _I, _I,       # params
    _P,                                       # stream
]
_FAMILY_ARGTYPES = [
    _P, _P, _P, _LL, _LL, _I,                 # years, values, mask, px, in_ld, ny
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
    lib.lt_segment_fused_f32_opcount.argtypes = [*_ARGTYPES, _P]
    lib.lt_segment_fused_f32_opcount.restype = ctypes.c_int
    for name in ("lt_family_stats_f32", "lt_family_stats_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _FAMILY_ARGTYPES
        fn.restype = ctypes.c_int
    lib.lt_family_stats_f32_opcount.argtypes = [*_FAMILY_ARGTYPES, _P]
    lib.lt_family_stats_f32_opcount.restype = ctypes.c_int
    for name in ("lt_segment_max_ny", "lt_segment_max_nc", "lt_segment_block"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    caps = (lib.lt_segment_max_ny(), lib.lt_segment_max_nc(), lib.lt_segment_block())
    if caps != (MAX_NY, MAX_NC, CUDA_BLOCK):
        raise RuntimeError(f"kernel capacities {caps} != wrapper's {(MAX_NY, MAX_NC, CUDA_BLOCK)}")
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


def _year_major(years, values, mask):
    """The kernels' inputs: the year axis in the values' dtype, and the
    values and cleaned mask year-major (NY, PX), so neighbouring threads
    read neighbouring words."""
    return (
        years.to(device=values.device, dtype=values.dtype).contiguous(),
        values.t().contiguous(),
        (mask & torch.isfinite(values)).t().contiguous(),
    )


class _Launch:
    """Year-major inputs and outputs of one (possibly chunked) kernel call."""

    def __init__(self, years, values, mask, params: LTParams):
        dev = values.device
        self.dtype = values.dtype
        self.params = params
        px, ny = values.shape
        self.px, self.ny = px, ny
        self.years, self.values_t, self.mask_t = _year_major(years, values, mask)
        nv, nm = params.max_vertices, params.max_segments

        def out(rows, dt):
            return torch.empty((rows, px), dtype=dt, device=dev)

        t, i32 = self.dtype, torch.int32
        self.outs = [
            out(ny, t), out(ny, t), out(1, i32), out(nv, i32), out(nv, t), out(nv, t),
            out(nv, t), out(nm, t), out(nm, t), out(nm, t), out(1, t), out(1, t),
            out(1, torch.bool),
        ]

    def run(self, start: int, count: int, op_count: "torch.Tensor | None" = None) -> None:
        """Launch the kernel on pixels ``[start, start + count)``; with
        ``op_count`` (int64, PX) the float32 kernel also writes each
        pixel's floating-point operation tally there."""
        global LAUNCHES
        lib = load_library()
        fn = lib.lt_segment_fused_f64 if self.dtype == torch.float64 else lib.lt_segment_fused_f32
        extra = ()
        if op_count is not None:
            fn = lib.lt_segment_fused_f32_opcount
            extra = (op_count.data_ptr() + start * op_count.element_size(),)
        p = self.params

        def at(a: torch.Tensor) -> int:
            return a.data_ptr() + start * a.element_size()

        stream = torch.cuda.current_stream(self.values_t.device).cuda_stream
        rc = fn(
            self.years.data_ptr(), at(self.values_t), at(self.mask_t),
            count, self.px, self.ny,
            *(at(o) for o in self.outs), self.px,
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
        (desp, fit, nvert, vidx, vyear, vsrc, vfit, smag, sdur, srate, rmse, pof, mv) = self.outs

        def pm(a):  # (rows, PX) -> (PX, rows)
            return a.t().contiguous()

        return SegOutputs(
            n_vertices=nvert[0],
            vertex_indices=pm(vidx),
            vertex_years=pm(vyear),
            vertex_src_vals=pm(vsrc),
            vertex_fit_vals=pm(vfit),
            seg_magnitude=pm(smag),
            seg_duration=pm(sdur),
            seg_rate=pm(srate),
            rmse=rmse[0],
            p_of_f=pof[0],
            model_valid=mv[0],
            fitted=pm(fit),
            despiked=pm(desp),
        )


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


class _FamilyLaunch:
    """Year-major inputs and outputs of one family-kernel call."""

    def __init__(self, years, values, mask, params: LTParams):
        dev = values.device
        self.dtype = values.dtype
        self.params = params
        px, ny = values.shape
        self.px, self.ny = px, ny
        self.years, self.values_t, self.mask_t = _year_major(years, values, mask)
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
        stream = torch.cuda.current_stream(self.values_t.device).cuda_stream
        rc = fn(
            self.years.data_ptr(), self.values_t.data_ptr(), self.mask_t.data_ptr(),
            self.px, self.px, self.ny,
            self.despiked.data_ptr(), self.vmasks.data_ptr(), self.sses.data_ptr(), self.px,
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
