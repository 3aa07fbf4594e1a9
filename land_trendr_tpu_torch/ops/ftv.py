"""FTV — fitted-trajectory values of secondary indices (plain PyTorch).

Counterpart of ``land_trendr_tpu/ops/ftv.py`` (``jax_fit_to_vertices``,
``ftv_pixel``).  Classic LandTrendr fits *other* spectral indices to the
vertex years chosen by the segmentation index: the vertex set is fixed,
and the target series is fitted through those years with the
segmentation's anchored fit (:func:`~land_trendr_tpu_torch.ops.segment._fit_model`).

The JAX package runs this as XLA, not as a Pallas kernel.  Here it is the
plain version of the FTV kernel (``ftv_fit_kernel`` in
``csrc/segment_fused.cu``, wrapped by
:func:`~land_trendr_tpu_torch.ops.segment_cuda.cuda_fit_to_vertices`): the
tile program runs the kernel on CUDA tensors and this on CPU tensors, and
the tests hold the two bit for bit.  Like the segmentation's plain version
it works on each pixel's *compacted* target series (valid years first),
where the JAX function works on the year axis:

* a stack-axis vertex index maps to the target's nearest valid year at or
  after it (the JAX ``searchsorted`` + clip) — in compacted terms, the
  count of valid years before it, clipped to the last valid one;
* duplicate mapped vertices merge, and a set of fewer than two falls back
  to the first and last valid years;
* the fit's span rule matters here: the target's mask is not the
  segmentation's, so a mapped set may start after the first valid year or
  end before the last — ``_fit_model`` sums its SSE over the vertex span
  only, and the full-year trajectory is flat outside it
  (:func:`~land_trendr_tpu_torch.ops.segment._interp_through_vertices`);
* a pixel with fewer than two vertices or two valid years gets the flat
  mean of its valid target values.
"""

from __future__ import annotations

import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.segment import (
    _check_batch,
    _compact,
    _Ctx,
    _fit_model,
    _interp_through_vertices,
    _positions,
    _ranges,
    _seqsum,
    _take,
    result_dtype,
)

__all__ = ["torch_fit_to_vertices"]


def torch_fit_to_vertices(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    vertex_indices: torch.Tensor,
    n_vertices: torch.Tensor,
    params: LTParams = LTParams(),
) -> torch.Tensor:
    """Fit ``(PX, NY)`` target series to per-pixel vertex sets.

    ``vertex_indices`` is ``(PX, NV)`` int (stack-axis year indices,
    padded -1) and ``n_vertices`` ``(PX,)`` — the fields of the
    segmentation's :class:`~land_trendr_tpu_torch.ops.segment.SegOutputs`.
    ``values`` is the target index in the disturbance-positive convention,
    ``mask`` the target's own validity.  Returns the ``(PX, NY)`` fitted
    trajectory in float64 for float64 values, float32 otherwise.
    """
    _check_batch(years, values, mask)
    px, ny = values.shape
    nv = params.max_vertices
    if vertex_indices.shape != (px, nv) or n_vertices.shape != (px,):
        raise ValueError(
            f"vertex_indices must be ({px}, {nv}) and n_vertices ({px},); got "
            f"{tuple(vertex_indices.shape)} and {tuple(n_vertices.shape)}"
        )
    dev = values.device
    cx = _Ctx(params, result_dtype(values.dtype), dev, ny)
    iota, zero = cx.iota, cx.zero
    s = _compact(cx, years, values, mask)
    n, valid, y = s.n, s.valid, s.raw_c
    n_safe = n.clamp(min=1)
    vi = vertex_indices.to(device=dev, dtype=torch.int64)
    n_verts = n_vertices.to(device=dev, dtype=torch.int64)

    # each vertex -> the compacted position of the nearest valid year at or
    # after it: the count of valid years before it, clipped to the last
    year_of = torch.where(valid, s.order, ny)                    # (P, NY)
    pos = (year_of.unsqueeze(1) < vi.unsqueeze(-1)).sum(-1)      # (P, NV)
    pos = torch.minimum(pos, (n_safe - 1).unsqueeze(-1))
    live = torch.arange(nv, device=dev) < n_verts.unsqueeze(-1)
    vmask = ((pos.unsqueeze(-1) == iota) & live.unsqueeze(-1)).any(1) & valid
    ends = (iota == 0) | (iota == (n - 1).clamp(min=0).unsqueeze(-1))
    vmask = torch.where((vmask.sum(-1) >= 2).unsqueeze(-1), vmask, ends & valid)

    _, _, y_range, _, t_hi = _ranges(cx, s, y)
    fitted, _ = _fit_model(cx, s.t, y, valid, vmask, y_range)
    vpos = _positions(vmask, nv)
    out = _interp_through_vertices(
        cx, s.t_full, _take(s.t, vpos), _take(fitted, vpos), vmask.sum(-1), t_hi
    )
    mean = torch.where(n > 0, _seqsum(torch.where(valid, y, zero)) / n_safe.to(cx.dtype), zero)
    ok = (n_verts >= 2) & (n >= 2)
    return torch.where(ok.unsqueeze(-1), out, mean.unsqueeze(-1))
