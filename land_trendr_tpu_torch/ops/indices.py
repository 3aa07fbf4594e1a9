"""Spectral-index math and QA masking for Landsat stacks (PyTorch).

Counterpart of ``land_trendr_tpu/ops/indices.py``: the same names, band
tables and formulas, as elementwise PyTorch ops on tensors of any shape.
Every function keeps its input's device; float results are float32, as in
the JAX package, whatever torch's default dtype is.

Sign convention: LandTrendr fits *disturbance-positive* series.
NBR/NDVI/NDMI/TCG/TCW all *decrease* under disturbance, so
:func:`compute_index` flips their sign by default; TCB *increases* and is
left as it is (LT-GEE's disturbance directions).

NDMI, TCB and TCG are the port's own (the JAX package has no such
indices): the LandTrendr multispectral ensemble segments them beside
NBR, NDVI and TCW.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = [
    "BANDS",
    "INDEX_NAMES",
    "DISTURBANCE_SIGN",
    "INDEX_BANDS",
    "TC_COEFFS",
    "DEFAULT_QA_REJECT",
    "required_bands",
    "nbr",
    "ndvi",
    "ndmi",
    "tcw",
    "compute_index",
    "scale_sr",
    "qa_valid_mask",
    "sr_valid_mask",
    "torch_tile_indices",
]

#: Canonical Landsat surface-reflectance band names (TM/ETM+/OLI
#: harmonised six-band set).
BANDS = ("blue", "green", "red", "nir", "swir1", "swir2")

#: Tasseled-cap wetness coefficients for surface reflectance (Crist 1985),
#: in :data:`BANDS` order.
_TCW_COEFFS = (0.0315, 0.2021, 0.3102, 0.1594, -0.6806, -0.6109)
#: Tasseled-cap brightness and greenness coefficients, the same table
#: (the ensemble's TCB and TCG, computed through :func:`compute_index`).
_TCB_COEFFS = (0.2043, 0.4158, 0.5524, 0.5741, 0.3124, 0.2303)
_TCG_COEFFS = (-0.1603, -0.2819, -0.4934, 0.7940, -0.0002, -0.1446)
#: The tasseled-cap indices: each a sum of its coefficients times the
#: :data:`BANDS`, left to right.
TC_COEFFS = {"tcb": _TCB_COEFFS, "tcg": _TCG_COEFFS, "tcw": _TCW_COEFFS}

#: Sign multiplier that makes each index disturbance-positive.
DISTURBANCE_SIGN = {
    "nbr": -1.0, "ndvi": -1.0, "tcw": -1.0, "ndmi": -1.0, "tcb": 1.0, "tcg": -1.0,
}

INDEX_NAMES = tuple(DISTURBANCE_SIGN)

#: Bands each index actually reads; the driver ships only the union its
#: index selection needs.  An index outside :data:`TC_COEFFS` is the
#: normalized difference of its two bands, (first − second) /
#: (first + second): this table and :data:`TC_COEFFS` define every index,
#: for :func:`compute_index` and the index kernel alike.
INDEX_BANDS = {
    "nbr": ("nir", "swir2"),
    "ndvi": ("nir", "red"),
    "tcw": BANDS,
    "ndmi": ("nir", "swir1"),
    "tcb": BANDS,
    "tcg": BANDS,
}


def required_bands(index: str, ftv_indices: tuple[str, ...] = ()) -> tuple[str, ...]:
    """Union of bands needed by a primary index + FTV indices, BANDS-ordered."""
    need: set[str] = set()
    for name in (index, *ftv_indices):
        key = name.lower()
        if key not in INDEX_BANDS:
            raise ValueError(f"unknown index {name!r}; expected one of {INDEX_NAMES}")
        need.update(INDEX_BANDS[key])
    return tuple(b for b in BANDS if b in need)


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with 0 where ``den`` is 0 (masked pixels stay finite)."""
    ok = den != 0
    one = torch.ones((), dtype=den.dtype, device=den.device)
    zero = torch.zeros((), dtype=num.dtype, device=num.device)
    return torch.where(ok, num / torch.where(ok, den, one), zero)


def nbr(nir: torch.Tensor, swir2: torch.Tensor) -> torch.Tensor:
    """Normalized Burn Ratio: (NIR − SWIR2) / (NIR + SWIR2)."""
    return _safe_ratio(nir - swir2, nir + swir2)


def ndvi(nir: torch.Tensor, red: torch.Tensor) -> torch.Tensor:
    """Normalized Difference Vegetation Index: (NIR − RED) / (NIR + RED)."""
    return _safe_ratio(nir - red, nir + red)


def ndmi(nir: torch.Tensor, swir1: torch.Tensor) -> torch.Tensor:
    """Normalized Difference Moisture Index: (NIR − SWIR1) / (NIR + SWIR1)."""
    return _safe_ratio(nir - swir1, nir + swir1)


def _tasseled_cap(coeffs: tuple[float, ...], bands: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """``Σ c·b`` over :data:`BANDS` order, summed left to right."""
    out = coeffs[0] * bands[0]
    for c, b in zip(coeffs[1:], bands[1:]):
        out = out + c * b
    return out


def tcw(
    blue: torch.Tensor,
    green: torch.Tensor,
    red: torch.Tensor,
    nir: torch.Tensor,
    swir1: torch.Tensor,
    swir2: torch.Tensor,
) -> torch.Tensor:
    """Tasseled-cap wetness (Crist 1985 reflectance coefficients)."""
    return _tasseled_cap(_TCW_COEFFS, (blue, green, red, nir, swir1, swir2))


def compute_index(
    name: str,
    bands: Mapping[str, torch.Tensor],
    disturbance_positive: bool = True,
) -> torch.Tensor:
    """Compute a named spectral index from a band-name → tensor mapping.

    ``name`` is one of :data:`INDEX_NAMES` (case-insensitive);
    ``bands`` holds reflectance-scaled float tensors of one shape.  With
    ``disturbance_positive`` (the default) the sign is flipped so that
    disturbance is an increase.
    """
    key = name.lower()
    if key in TC_COEFFS:
        out = _tasseled_cap(TC_COEFFS[key], tuple(bands[b] for b in BANDS))
    elif key in INDEX_BANDS:
        a, b = (bands[band] for band in INDEX_BANDS[key])
        out = _safe_ratio(a - b, a + b)
    else:
        raise ValueError(f"unknown index {name!r}; expected one of {INDEX_NAMES}")
    if disturbance_positive:
        out = DISTURBANCE_SIGN[key] * out
    return out


def _to_int32(a: torch.Tensor) -> torch.Tensor:
    """Widen integer DNs / QA words to int32, value-preserving.

    uint16 goes through its int16 bit pattern and a 16-bit mask, which
    needs only int16/int32 kernels on every device.
    """
    if a.dtype == torch.uint16:
        return a.view(torch.int16).to(torch.int32) & 0xFFFF
    return a.to(torch.int32)


def scale_sr(
    dn: torch.Tensor, scale: float = 2.75e-5, offset: float = -0.2
) -> torch.Tensor:
    """Scale integer surface-reflectance DNs to float32 reflectance.

    Collection-2 convention by default; Collection-1 style data uses
    ``scale=1e-4, offset=0.0``.  The DNs are widened to float32 first, so
    the result is float32 whatever torch's default dtype is.
    """
    if not dn.dtype.is_floating_point:
        dn = _to_int32(dn)
    return dn.to(torch.float32) * scale + offset


#: QA_PIXEL (CFMask) bit positions, Landsat Collection 2 layout.
_QA_FILL = 1 << 0
_QA_DILATED_CLOUD = 1 << 1
_QA_CIRRUS = 1 << 2
_QA_CLOUD = 1 << 3
_QA_CLOUD_SHADOW = 1 << 4
_QA_SNOW = 1 << 5

#: Default rejection set: fill, cloud (incl. dilated + cirrus), shadow, snow.
DEFAULT_QA_REJECT = (
    _QA_FILL | _QA_DILATED_CLOUD | _QA_CIRRUS | _QA_CLOUD | _QA_CLOUD_SHADOW | _QA_SNOW
)


def qa_valid_mask(
    qa: torch.Tensor, reject_bits: int = DEFAULT_QA_REJECT
) -> torch.Tensor:
    """True where the QA_PIXEL bitfield marks a usable observation.

    The QA word is widened to int32 before the ``&`` (as the JAX package
    does): a uint16 QA band keeps its high flag bits, and no sign bit of a
    16-bit type can leak into the test.
    """
    return (_to_int32(qa) & reject_bits) == 0


def sr_valid_mask(
    bands: Mapping[str, torch.Tensor],
    lo: float = 0.0,
    hi: float = 1.0,
) -> torch.Tensor:
    """True where every reflectance band is finite and inside ``[lo, hi]``."""
    mask = None
    for name in BANDS:
        if name not in bands:
            continue
        b = bands[name]
        ok = torch.isfinite(b) & (b >= lo) & (b <= hi)
        mask = ok if mask is None else (mask & ok)
    if mask is None:
        raise ValueError("sr_valid_mask needs at least one known band")
    return mask


def torch_tile_indices(
    dn_bands: Mapping[str, torch.Tensor],
    qa: torch.Tensor,
    indices: tuple[str, ...],
    ftv_indices: tuple[str, ...] = (),
    scale: float = 2.75e-5,
    offset: float = -0.2,
    reject_bits: int = DEFAULT_QA_REJECT,
) -> tuple[torch.Tensor, torch.Tensor, tuple[torch.Tensor, ...]]:
    """A tile's DNs and QA to its mask and every index it needs (plain).

    ``dn_bands`` maps band name → ``(PX, NY)`` DNs, ``qa`` is the
    ``(PX, NY)`` QA_PIXEL word.  Returns ``(series, mask, ftv)``:
    ``series`` the ``(K·PX, NY)`` float32 rows of the K ``indices``, one
    PX-row block each in their order (the first index alone when K = 1);
    ``mask`` the ``(PX, NY)`` QA test AND every known band's range check;
    ``ftv`` one ``(PX, NY)`` float32 tensor per ``ftv_indices`` name.
    Every index is disturbance-positive.

    The composition of :func:`scale_sr`, :func:`qa_valid_mask`,
    :func:`sr_valid_mask` and :func:`compute_index`, a float32 copy of
    every band: the plain version of the index kernel
    (:func:`~land_trendr_tpu_torch.ops.segment_cuda.cuda_tile_indices`),
    which the tile program takes for CPU tensors.
    """
    sr = {name: scale_sr(dn, scale, offset) for name, dn in dn_bands.items()}
    mask = qa_valid_mask(qa, reject_bits) & sr_valid_mask(sr)
    rows = [compute_index(name, sr) for name in indices]
    series = rows[0] if len(rows) == 1 else torch.cat(rows)
    return series, mask, tuple(compute_index(name, sr) for name in ftv_indices)
