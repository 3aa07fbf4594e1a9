"""Fused tile program: raw Landsat DNs in, segmentation out (PyTorch).

Counterpart of ``land_trendr_tpu/ops/tile.py``.  The driver ships the
narrowest representation to the device — int16/uint16 surface-reflectance
DNs plus the uint16 QA bitfield — and this program does DN→reflectance
scaling, QA + range masking, the spectral index and the segmentation on
the device the tensors live on.  On a CUDA device the segmentation is the
hand-written kernel (:mod:`land_trendr_tpu_torch.ops.segment_cuda`); on
the CPU it is the plain PyTorch version.  The scaling, the masks and every
index the tile needs are picked the same way: one pass of the index kernel
(:func:`~land_trendr_tpu_torch.ops.segment_cuda.cuda_tile_indices`) on a
CUDA device, its plain version
(:func:`~land_trendr_tpu_torch.ops.indices.torch_tile_indices`) on the
CPU.  The optional tail: FTV fits of
secondary indices, picked the same way (the FTV kernel,
:func:`~land_trendr_tpu_torch.ops.segment_cuda.cuda_fit_to_vertices`, on a
CUDA device, its plain version
:func:`~land_trendr_tpu_torch.ops.ftv.torch_fit_to_vertices` on the CPU),
and the fused change-map selection
(:func:`~land_trendr_tpu_torch.ops.change.select_change`), plain PyTorch
on the same device, as it is XLA in the JAX package.  Further indices of
an ensemble (the LandTrendr multispectral ensemble: each index segmented
on its own) ride the same segmentation call as rows below the primary's.
"""

from __future__ import annotations

from types import MappingProxyType
from typing import Mapping, NamedTuple

import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.ops.change import ChangeFilter, select_change
from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices
from land_trendr_tpu_torch.ops.segment import (
    SegOutputs,
    torch_segment_pixels,
    torch_segment_pixels_chunked,
)
from land_trendr_tpu_torch.ops.segment_cuda import (
    cuda_fit_to_vertices,
    cuda_segment_pixels,
    cuda_segment_pixels_chunked,
    cuda_tile_indices,
)
from land_trendr_tpu_torch.parallel.mesh import pad_to_multiple
from land_trendr_tpu_torch.utils.profiling import span

__all__ = ["IMPLS", "TileOutputs", "ftv_fit", "process_tile_dn", "resolve_impl", "tile_indices"]

#: segmentation implementations: the hand-written kernel and its plain
#: PyTorch version
IMPLS = ("cuda", "torch")


class TileOutputs(NamedTuple):
    """Segmentation of the primary index plus FTV fits of secondary indices."""

    seg: SegOutputs
    #: index name → (PX, NY) fitted-trajectory values (disturbance-positive
    #: convention, matching the segmentation input sign)
    ftv: dict[str, torch.Tensor]
    #: fused change-map products (``ops/change.CHANGE_PRODUCTS`` → (PX,)
    #: tensors, natural orientation) when the run asked for them; the
    #: spatial mmu sieve needs the whole raster and applies post-assembly
    change: "dict[str, torch.Tensor] | None" = None
    #: ensemble index name → its own segmentation, in the same
    #: disturbance-positive convention as ``seg``
    ens: "Mapping[str, SegOutputs]" = MappingProxyType({})


def resolve_impl(impl: str, device: "torch.device | str") -> str:
    """Resolve ``impl`` ("auto"/"cuda"/"torch") for tensors on ``device``.

    The device decides: the kernel ("cuda") on a CUDA device, the plain
    version ("torch") on the CPU.  "auto" picks it; naming the other one
    raises, so the main path on the card always runs the kernel.  The
    resolved value is what the driver records in the manifest's execution
    context.
    """
    dev = torch.device(device)
    resolved = "cuda" if dev.type == "cuda" else "torch"
    if impl not in ("auto", *IMPLS):
        raise ValueError(f"impl={impl!r} not one of 'auto', 'cuda', 'torch'")
    if impl not in ("auto", resolved):
        raise ValueError(
            f"impl={impl!r} does not run on {dev}: the kernel ('cuda') runs on "
            "CUDA tensors only and the plain version ('torch') on CPU tensors only"
        )
    return resolved


def ftv_fit(impl: str):
    """The FTV fit of a resolved ``impl`` (:func:`resolve_impl`): the FTV
    kernel (:func:`~land_trendr_tpu_torch.ops.segment_cuda.cuda_fit_to_vertices`)
    for "cuda", its plain version
    (:func:`~land_trendr_tpu_torch.ops.ftv.torch_fit_to_vertices`) for "torch"."""
    return cuda_fit_to_vertices if impl == "cuda" else torch_fit_to_vertices


def tile_indices(impl: str):
    """The index pass of a resolved ``impl`` (:func:`resolve_impl`): the
    index kernel
    (:func:`~land_trendr_tpu_torch.ops.segment_cuda.cuda_tile_indices`)
    for "cuda", its plain version
    (:func:`~land_trendr_tpu_torch.ops.indices.torch_tile_indices`) for
    "torch"."""
    return cuda_tile_indices if impl == "cuda" else idx.torch_tile_indices


def process_tile_dn(
    years: torch.Tensor,
    dn_bands: Mapping[str, torch.Tensor],
    qa: torch.Tensor,
    index: str = "nbr",
    params: LTParams = LTParams(),
    scale: float = 2.75e-5,
    offset: float = -0.2,
    reject_bits: int = idx.DEFAULT_QA_REJECT,
    chunk: "int | None" = None,
    impl: str = "auto",
    ftv_indices: tuple[str, ...] = (),
    change_filt: "ChangeFilter | None" = None,
    ensemble_indices: tuple[str, ...] = (),
) -> TileOutputs:
    """Segment one tile straight from Collection-2 style DNs.

    ``years`` is the ``(NY,)`` year axis; ``dn_bands`` maps band name →
    ``(PX, NY)`` int16/uint16 DNs (one of the two for every band on a
    CUDA device, which the index kernel is built for) and must hold the
    bands ``index``, ``ftv_indices`` and ``ensemble_indices`` need (all
    six for a tasseled-cap index); ``qa`` is the ``(PX, NY)``
    uint16 (or int16) QA_PIXEL bitfield, all on one device.  ``ftv_indices`` are
    secondary indices fitted to the chosen vertices; ``change_filt``
    selects each pixel's change segment (natural orientation).
    ``ensemble_indices`` are further indices each segmented on its own:
    their K - 1 series go below the primary's as rows of ONE segmentation
    call over K·PX rows (one mask, repeated), split back per index into
    ``ens``.  With ``chunk`` set and those rows > ``chunk``, the
    segmentation runs chunked: the rows are padded to a chunk multiple
    with fully-masked rows and cropped back, so results equal the
    unchunked path and each index segmented alone.  With the kernel, a
    chunk larger than the CUDA block must be a multiple of it (the
    chunked wrapper raises otherwise).

    While a profiler session records, each stage is a span on the tile's
    device (:func:`~land_trendr_tpu_torch.utils.profiling.span`):
    ``lt_tile_prep`` (scaling, masks and every index: the primary, the
    ensemble's and FTV's, :func:`tile_indices`; the index kernel's launch
    span ``lt_tile_index`` nests inside), ``lt_tile_ensemble`` (the mask
    repeated for the K series; only with ``ensemble_indices``),
    ``lt_tile_segment``
    (padding, the kernel's launches, the crop and the split),
    ``lt_tile_ftv`` (the FTV kernel's launch spans ``lt_ftv_fit`` nest
    inside) and ``lt_tile_change`` (when asked for).
    """
    dev = qa.device
    impl = resolve_impl(impl, dev)
    with span("lt_tile_prep", dev):
        years = years.to(dev)
        series, mask, ftv_values = tile_indices(impl)(
            dn_bands, qa, (index, *ensemble_indices), ftv_indices, scale, offset, reject_bits)
    px = mask.shape[0]
    series_mask = mask
    if ensemble_indices:
        with span("lt_tile_ensemble", dev):
            # the mask once per index: on the card cat copies in wide
            # vectors, three times repeat's speed (a byte a thread)
            series_mask = torch.cat([mask] * (1 + len(ensemble_indices)))
    rows = series.shape[0]
    if impl == "cuda":
        whole, chunked = cuda_segment_pixels, cuda_segment_pixels_chunked
    else:
        whole, chunked = torch_segment_pixels, torch_segment_pixels_chunked
    fit = ftv_fit(impl)
    ens = {}
    with span("lt_tile_segment", dev):
        if chunk is not None and rows > chunk:
            series_p, mask_p, _ = pad_to_multiple(series, series_mask, chunk)
            seg = chunked(years, series_p, mask_p, params, chunk)
            if series_p.shape[0] != rows:
                seg = SegOutputs(*(o[:rows] for o in seg))
        else:
            seg = whole(years, series, series_mask, params)
        if ensemble_indices:
            parts = [SegOutputs(*(o[k * px:(k + 1) * px] for o in seg))
                     for k in range(1 + len(ensemble_indices))]
            seg, ens = parts[0], dict(zip(ensemble_indices, parts[1:]))
    ftv = {}
    if ftv_indices:
        with span("lt_tile_ftv", dev):
            ftv = {
                name: fit(years, values, mask, seg.vertex_indices, seg.n_vertices, params)
                for name, values in zip(ftv_indices, ftv_values)
            }
    change = None
    if change_filt is not None:
        # the kernel fits in the disturbance-positive orientation; the
        # selector's contract is the natural one, so flip first
        sign = idx.DISTURBANCE_SIGN[index.lower()]
        with span("lt_tile_change", dev):
            change = select_change(
                seg.vertex_years,
                sign * seg.vertex_fit_vals,
                sign * seg.seg_magnitude,
                seg.seg_duration,
                sign * seg.seg_rate,
                seg.model_valid,
                seg.p_of_f,
                seg.rmse,
                sign=sign,
                filt=change_filt,
            )
    return TileOutputs(seg=seg, ftv=ftv, change=change, ens=ens)
