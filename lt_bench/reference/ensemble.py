"""The reference of the LandTrendr multispectral ensemble: DNs in, each
index's segmentation products out.

The ensemble (Cohen, Yang, Healey, Kennedy & Gorelick 2018, Remote
Sensing of Environment 205:131-140) runs LandTrendr on its own on each
of several indices of one annual stack.  Plain PyTorch over the frozen
copies beside this file, and nothing of the program or of JAX: DN
scaling and the QA and range masks as ``tile.py`` has them, then every
index segmented separately, one ``torch_segment_pixels`` call each (the
program stacks them into one call; pixels are independent, so the two
must agree bit for bit), then the host conventions of a landed tile (the
natural orientation of every signed value, each index by its own sign).

NBR, NDVI and TCW come from the frozen ``indices.py``; NDMI and tasseled-
cap brightness and greenness are written here, in the program's order of
operations (the same safe ratio; the tasseled-cap sums left to right in
band order).  TCB rises under disturbance (LT-GEE's directions), so its
series is fitted and landed as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lt_bench.reference import indices as idx
from lt_bench.reference.params import LTParams
from lt_bench.reference.segment import torch_segment_pixels
from lt_bench.reference.tile import SEG_PRODUCTS, SIGNED_PRODUCTS

__all__ = [
    "EnsembleSpec", "SIGN", "bands_of", "index_series", "reference_products",
    "series_per_px", "spec_of",
]

#: tasseled-cap brightness and greenness for surface reflectance (Crist
#: 1985, the table ``indices.py``'s wetness comes from), in band order
_TCB_COEFFS = (0.2043, 0.4158, 0.5524, 0.5741, 0.3124, 0.2303)
_TCG_COEFFS = (-0.1603, -0.2819, -0.4934, 0.7940, -0.0002, -0.1446)

#: the sign that makes each index disturbance-positive
SIGN = {**idx.DISTURBANCE_SIGN, "ndmi": -1.0, "tcb": 1.0, "tcg": -1.0}


def _tasseled_cap(coeffs: tuple[float, ...], sr: dict[str, torch.Tensor]) -> torch.Tensor:
    out = coeffs[0] * sr[idx.BANDS[0]]
    for c, b in zip(coeffs[1:], idx.BANDS[1:]):
        out = out + c * sr[b]
    return out


def index_series(name: str, sr: dict[str, torch.Tensor]) -> torch.Tensor:
    """Index ``name`` of the reflectances ``sr``, disturbance-positive."""
    if name == "ndmi":
        value = idx._safe_ratio(sr["nir"] - sr["swir1"], sr["nir"] + sr["swir1"])
    elif name == "tcb":
        value = _tasseled_cap(_TCB_COEFFS, sr)
    elif name == "tcg":
        value = _tasseled_cap(_TCG_COEFFS, sr)
    else:
        value = idx.compute_index(name, sr, disturbance_positive=False)
    return SIGN[name] * value


@dataclasses.dataclass(frozen=True)
class EnsembleSpec:
    """What one ensemble cell's tiles compute and which products they land."""

    index: str = "nbr"
    ensemble: tuple[str, ...] = ()
    params: LTParams = LTParams()
    products: tuple[str, ...] = SEG_PRODUCTS
    scale: float = 2.75e-5
    offset: float = -0.2
    reject_bits: int = idx.DEFAULT_QA_REJECT


def _ensemble(config: dict) -> tuple[str, ...]:
    return tuple(config["run"]["ensemble_indices"])


def spec_of(config: dict, traffic: dict) -> EnsembleSpec:
    """The spec of a cell of ``config`` under ``traffic``; the ensemble
    lands segmentation products only (no FTV, no change map)."""
    if config["ftv_indices"] or traffic["change"]:
        raise ValueError("the ensemble reference lands segmentation products only")
    return EnsembleSpec(
        index=config["index"],
        ensemble=_ensemble(config),
        params=LTParams(**config["params"]),
        products=tuple(traffic["products"]),
        scale=float(config["scale"]),
        offset=float(config["offset"]),
    )


def bands_of(config: dict) -> tuple[str, ...]:
    """All six bands: the tasseled-cap indices read each of them."""
    return idx.BANDS


def series_per_px(config: dict) -> int:
    """Series the segmentation fits a pixel: the primary index's and one
    for each further index."""
    return 1 + len(_ensemble(config))


def _rows(
    years: torch.Tensor,
    dn_bands: dict[str, torch.Tensor],
    qa: torch.Tensor,
    spec: EnsembleSpec,
) -> dict[str, torch.Tensor]:
    """Device tensors of every product for one block of rows."""
    sr = {name: idx.scale_sr(dn, spec.scale, spec.offset) for name, dn in dn_bands.items()}
    mask = idx.qa_valid_mask(qa, spec.reject_bits) & idx.sr_valid_mask(sr)
    out: dict[str, torch.Tensor] = {}
    for name in (spec.index, *spec.ensemble):
        seg = torch_segment_pixels(years, index_series(name, sr), mask, spec.params)
        prefix = "" if name == spec.index else f"ens_{name}_"
        for product in spec.products:
            a = getattr(seg, product)
            out[prefix + product] = SIGN[name] * a if product in SIGNED_PRODUCTS else a
        if name == spec.index:
            out["model_valid"] = seg.model_valid
    return out


def reference_products(
    years: torch.Tensor,
    dn_bands: dict[str, torch.Tensor],
    qa: torch.Tensor,
    spec: EnsembleSpec,
    chunk: int = 262_144,
) -> dict[str, np.ndarray]:
    """Every product of ``spec`` for the ``(PX, NY)`` rows given, as host
    arrays: the primary index's ``spec.products`` and ``model_valid``
    always, then ``ens_<index>_<product>`` for each further index."""
    # float32 stays float32: no TF32 in any matrix product on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    px = qa.shape[0]
    parts: dict[str, list[np.ndarray]] = {}
    for s in range(0, px, chunk):
        block = _rows(
            years, {k: v[s : s + chunk] for k, v in dn_bands.items()}, qa[s : s + chunk], spec
        )
        for name, a in block.items():
            parts.setdefault(name, []).append(a.cpu().numpy())
    return {name: np.concatenate(a) for name, a in parts.items()}
