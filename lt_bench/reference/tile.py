"""The reference tile program: DNs in, the products a user receives out.

Plain PyTorch over the frozen copies beside this file, and nothing of
the program: DN scaling, the QA and range masks, the primary index, the
segmentation, FTV fits of the secondary indices and the change
selection, then the host conventions of a landed tile (the natural
orientation of every signed value, ``int32`` years of detection, bools
as bools).  Pixels are independent, so the reference runs on any subset
of a tile's rows, ``chunk`` rows at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lt_bench.reference import indices as idx
from lt_bench.reference.change import ChangeFilter, select_change
from lt_bench.reference.ftv import torch_fit_to_vertices
from lt_bench.reference.params import LTParams
from lt_bench.reference.segment import torch_segment_pixels

__all__ = [
    "RefSpec", "SEG_PRODUCTS", "SIGNED_PRODUCTS", "bands_of", "reference_products",
    "series_per_px", "spec_of",
]

#: the 11 per-pixel segmentation products a run can fetch
SEG_PRODUCTS = (
    "n_vertices", "vertex_indices", "vertex_years", "vertex_src_vals",
    "vertex_fit_vals", "seg_magnitude", "seg_duration", "seg_rate",
    "rmse", "p_of_f", "model_valid",
)

#: value-carrying products that flip with the index's disturbance sign
SIGNED_PRODUCTS = frozenset(
    {"vertex_src_vals", "vertex_fit_vals", "seg_magnitude", "seg_rate"}
)


@dataclasses.dataclass(frozen=True)
class RefSpec:
    """What one cell's tiles compute and which products they hand back."""

    index: str = "nbr"
    params: LTParams = LTParams()
    ftv_indices: tuple[str, ...] = ()
    change_filt: "ChangeFilter | None" = None
    products: tuple[str, ...] = SEG_PRODUCTS
    scale: float = 2.75e-5
    offset: float = -0.2
    reject_bits: int = idx.DEFAULT_QA_REJECT


def spec_of(config: dict, traffic: dict) -> RefSpec:
    """The spec of a cell of ``config`` (a configuration file) under
    ``traffic`` (a mix file)."""
    return RefSpec(
        index=config["index"],
        params=LTParams(**config["params"]),
        ftv_indices=tuple(config["ftv_indices"]),
        change_filt=ChangeFilter(**config["change_filter"]) if traffic["change"] else None,
        products=tuple(traffic["products"]),
        scale=float(config["scale"]),
        offset=float(config["offset"]),
    )


def bands_of(config: dict) -> tuple[str, ...]:
    """The bands the primary index and the FTV indices read."""
    return idx.required_bands(config["index"], tuple(config["ftv_indices"]))


def series_per_px(config: dict) -> int:
    """Series the segmentation fits a pixel: the primary index's alone."""
    return 1


def _rows(
    years: torch.Tensor,
    dn_bands: dict[str, torch.Tensor],
    qa: torch.Tensor,
    spec: RefSpec,
) -> dict[str, torch.Tensor]:
    """Device tensors of every product for one block of rows."""
    sr = {name: idx.scale_sr(dn, spec.scale, spec.offset) for name, dn in dn_bands.items()}
    mask = idx.qa_valid_mask(qa, spec.reject_bits) & idx.sr_valid_mask(sr)
    seg = torch_segment_pixels(years, idx.compute_index(spec.index, sr), mask, spec.params)
    sign = idx.DISTURBANCE_SIGN[spec.index.lower()]
    out: dict[str, torch.Tensor] = {}
    for name in spec.products:
        a = getattr(seg, name)
        out[name] = sign * a if name in SIGNED_PRODUCTS else a
    out["model_valid"] = seg.model_valid
    if spec.change_filt is not None:
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
            filt=spec.change_filt,
        )
        for name, a in change.items():
            out[f"change_{name}"] = a.to(torch.int32) if name == "yod" else a
    for name in spec.ftv_indices:
        fit = torch_fit_to_vertices(
            years, idx.compute_index(name, sr), mask, seg.vertex_indices,
            seg.n_vertices, spec.params,
        )
        out[f"ftv_{name}"] = idx.DISTURBANCE_SIGN[name.lower()] * fit
    return out


def reference_products(
    years: torch.Tensor,
    dn_bands: dict[str, torch.Tensor],
    qa: torch.Tensor,
    spec: RefSpec,
    chunk: int = 262_144,
) -> dict[str, np.ndarray]:
    """Every product of ``spec`` for the ``(PX, NY)`` rows given, as host
    arrays: the segmentation products ``spec.products`` names,
    ``model_valid`` always, ``change_*`` with a change filter and
    ``ftv_<index>`` per secondary index."""
    px = qa.shape[0]
    parts: dict[str, list[np.ndarray]] = {}
    for s in range(0, px, chunk):
        block = _rows(
            years, {k: v[s : s + chunk] for k, v in dn_bands.items()}, qa[s : s + chunk], spec
        )
        for name, a in block.items():
            parts.setdefault(name, []).append(a.cpu().numpy())
    return {name: np.concatenate(a) for name, a in parts.items()}
