"""Pixel-axis data parallelism over local devices (PyTorch).

Counterpart of ``land_trendr_tpu/parallel/mesh.py``.  The workload has
nothing to shard but pixels: every pixel's series is segmented on its own,
so splitting the pixel axis over devices changes no result.

* A **mesh** is an ordered list of ``torch.device`` (:func:`make_mesh`;
  by default every local CUDA device).  Repeated devices are allowed —
  PyTorch has no virtual devices, so the CPU tests use ``[cpu] * N`` and a
  one-card machine can run ``[cuda:0, cuda:0]``.
* A **shard** is a contiguous block of ``PX / len(mesh)`` pixels placed on
  its own device (:func:`shard_pixels`).
* :func:`segment_pixels_sharded` launches the segmentation once per shard,
  on that device's current stream — the CUDA kernel on a CUDA device, the
  plain PyTorch version on the CPU — and gathers the results on the host
  in pixel order.  No tensor crosses devices and no collective runs.
* :func:`summarize_sharded` is the cross-pixel metrics reduction, on the
  gathered host tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.segment import SegOutputs
from land_trendr_tpu_torch.ops.segment_cuda import cuda_segment_pixels

__all__ = [
    "PIXEL_AXIS",
    "make_mesh",
    "pad_to_multiple",
    "shard_pixels",
    "segment_pixels_sharded",
    "summarize_sharded",
]

#: name of the single mesh axis; everything shards along pixels
PIXEL_AXIS = "pixels"


def make_mesh(
    devices: "Sequence[torch.device | str] | None" = None,
) -> list[torch.device]:
    """A 1-D mesh over ``devices`` (default: every local CUDA device).

    With no CUDA device the default raises — a mesh never falls back to
    the CPU; a CPU mesh must be asked for by name (``["cpu"] * 4``).  All
    devices of one mesh share a type; CUDA indices are resolved and
    checked against the local device count.
    """
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh(): no CUDA device (torch.cuda.is_available() is "
                "False); a mesh over the CPU must name its devices"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    types = {d.type for d in mesh}
    if len(types) != 1 or not types <= {"cuda", "cpu"}:
        raise ValueError(
            f"mesh devices {[str(d) for d in mesh]} must all be 'cuda' or all 'cpu'"
        )
    if "cuda" in types:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh was requested but torch.cuda.is_available() is False"
            )
        n = torch.cuda.device_count()
        mesh = [
            torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
            for d in mesh
        ]
        bad = [str(d) for d in mesh if d.index >= n]
        if bad:
            raise ValueError(f"mesh devices {bad} do not exist ({n} local CUDA devices)")
    return mesh


def pad_to_multiple(
    values: torch.Tensor, mask: torch.Tensor, multiple: int
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Pad the pixel axis up to a multiple of ``multiple``.

    Padded rows are fully masked (``mask=False``), which the kernel already
    treats as the insufficient-data path, so they cost compute but never
    produce NaNs or affect real pixels.  Returns ``(values, mask, n_real)``,
    padded on the tensors' own device.
    """
    px = values.shape[0]
    n_pad = (-px) % multiple
    if n_pad == 0:
        return values, mask, px
    pad_v = torch.zeros(
        (n_pad,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device
    )
    pad_m = torch.zeros(
        (n_pad,) + tuple(mask.shape[1:]), dtype=torch.bool, device=mask.device
    )
    return torch.cat([values, pad_v]), torch.cat([mask, pad_m]), px


def _as_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a


def shard_pixels(
    mesh: Sequence[torch.device], values, mask
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(PX, NY)`` values and mask → one contiguous ``(PX / n, NY)`` block
    of each per mesh device, in mesh order.

    The pixel count must already be a multiple of the mesh size (use
    :func:`pad_to_multiple`).
    """
    values, mask = _as_tensor(values), _as_tensor(mask)
    n = len(mesh)
    px = values.shape[0]
    if px % n:
        raise ValueError(
            f"pixel count {px} not divisible by mesh size {n}; use pad_to_multiple first"
        )
    step = px // n
    return [
        (values[k * step : (k + 1) * step].to(dev), mask[k * step : (k + 1) * step].to(dev))
        for k, dev in enumerate(mesh)
    ]


def segment_pixels_sharded(
    years,
    values,
    mask,
    params: LTParams = LTParams(),
    mesh: "Sequence[torch.device] | None" = None,
) -> SegOutputs:
    """The segmentation over a mesh: one launch per shard, results gathered
    on the host in pixel order.

    ``values``/``mask`` are ``(PX, NY)`` with ``PX`` a multiple of the mesh
    size (NumPy arrays or tensors on any device).  Every shard is enqueued
    before any result is read, so shards on different devices overlap.
    The returned :class:`SegOutputs` holds CPU tensors equal, field by
    field, to the unsharded call on the same device type.
    """
    if mesh is None:
        mesh = make_mesh()
    shards = shard_pixels(mesh, values, mask)
    years = _as_tensor(years)
    # the wrapper launches on the current stream of each shard's own device
    outs = [cuda_segment_pixels(years.to(dev), v, m, params)
            for dev, (v, m) in zip(mesh, shards)]
    return SegOutputs(
        *(torch.cat([o[i].cpu() for o in outs]) for i in range(len(SegOutputs._fields)))
    )


def summarize_sharded(out: SegOutputs, n_real: "int | None" = None) -> dict[str, float]:
    """Cross-pixel run metrics: pixel count, fit rate, mean p-of-F of the
    fitted pixels and mean rmse, in float64.

    Pass the ``n_real`` from :func:`pad_to_multiple` so the fully-masked
    padding rows (always no-fit) don't dilute the rates.
    """
    valid = out.model_valid.cpu()
    rmse = out.rmse.cpu().double()
    p_of_f = out.p_of_f.cpu().double()
    if n_real is not None:
        valid, rmse, p_of_f = valid[:n_real], rmse[:n_real], p_of_f[:n_real]
    n = valid.shape[0]
    n_fit = int(valid.sum())
    mean_p = (
        float(torch.where(valid, p_of_f, 0.0).sum()) / n_fit if n_fit > 0 else 1.0
    )
    return {
        "pixels": float(n),
        "fit_rate": float(n_fit / n),
        "no_fit_rate": float(1.0 - n_fit / n),
        "mean_p_of_f": mean_p,
        "mean_rmse": float(rmse.sum()) / n,
    }
