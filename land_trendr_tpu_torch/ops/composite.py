"""Annual medoid compositing: many acquisitions per year → one composite.

Counterpart of ``land_trendr_tpu/ops/composite.py``.  LandTrendr is an
annual-series algorithm, so the loaders take one image per year; real
Collection-2 archives ship every acquisition, and ``composite="medoid"``
collapses each multi-acquisition year to its **medoid**: per pixel, the
clear-sky acquisition whose spectral vector is closest to the per-band
median of the year's clear-sky acquisitions.  The output is an actual
observation (no synthetic mixing of dates).

Plain PyTorch on the loader's device, as the JAX version is plain ``jnp``
(no hand-written kernel on either side): a masked per-band median by sort
along the date axis (invalid dates sort to the top as ``+inf``), one
squared-distance reduction over the bands, and one first-index ``argmin``,
chunked over the pixel axis.  The distance is computed on raw DN floats:
the C2 DN→reflectance transform is affine and identical across a year's
acquisitions, so it scales every distance by the same factor and cannot
change an argmin.  The float32 band sum runs in PyTorch's reduction order,
which may differ from XLA's: where two dates' distances lie within float32
rounding of each other (a near-tie), either package may pick either date.
"""

from __future__ import annotations

import numpy as np
import torch

from land_trendr_tpu_torch.ops import indices as idx

__all__ = ["medoid_indices", "medoid_composite"]


def medoid_indices(
    sr: torch.Tensor,     # (nd, px, nb) float — the year's acquisitions
    valid: torch.Tensor,  # (nd, px) bool — clear-sky & finite per date
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel medoid date index among valid acquisitions.

    Returns ``(choice, any_valid)`` on the inputs' device: ``choice[px]``
    (int32) is the date index of the acquisition minimizing the squared
    distance to the per-band masked median (ties → lowest date index);
    pixels with no valid date return index 0 with ``any_valid`` False.
    """
    valid = valid.to(torch.bool)
    sr = sr.to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=sr.dtype, device=sr.device)

    # masked per-(pixel, band) median: invalid dates sort to the top
    vals = torch.where(valid[:, :, None], sr, inf)
    svals = torch.sort(vals, dim=0).values
    n = valid.sum(dim=0)  # (px,)
    nb = sr.shape[2]
    lo_i = torch.clamp((n - 1) // 2, min=0)[None, :, None].expand(1, n.shape[0], nb)
    hi_i = torch.clamp(n // 2, min=0)[None, :, None].expand(1, n.shape[0], nb)
    lo = torch.gather(svals, 0, lo_i)
    hi = torch.gather(svals, 0, hi_i)
    med = 0.5 * (lo + hi)  # (1, px, nb); +inf where the pixel has no valid date

    dist = ((sr - med) ** 2).sum(dim=-1)  # (nd, px); garbage where invalid
    dist = torch.where(valid, dist, inf)
    choice = torch.argmin(dist, dim=0).to(torch.int32)  # first-index ties
    any_valid = n > 0
    return torch.where(any_valid, choice, 0).to(torch.int32), any_valid


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(no usable CUDA card); pass device 'cpu' only for tests and "
            "debugging"
        )
    return dev


def medoid_composite(
    dn: dict[str, np.ndarray],  # band -> (nd, H, W) int16/uint16 DNs
    qa: np.ndarray,             # (nd, H, W) uint16 QA_PIXEL
    reject_bits: int = idx.DEFAULT_QA_REJECT,
    scale: float = 2.75e-5,
    offset: float = -0.2,
    chunk_px: int = 1 << 21,
    device="cuda",
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """One year's acquisitions → (composite DN bands, composite QA).

    The composite keeps each band's integer dtype and copies the CHOSEN
    acquisition's values verbatim; QA is the chosen date's QA, so
    downstream masking still applies.  A date is selectable only when it
    is both QA-clear (``qa_valid_mask(reject_bits)``) and radiometrically
    valid (``sr_valid_mask`` on the ``scale``/``offset``-scaled
    reflectances) — the two masks the segmentation feed applies.  Pixels
    with no valid acquisition get QA = 1 (the fill bit) and DN 0.  The
    selection runs on ``device`` (``"cuda"`` by default) in chunks of
    ``chunk_px`` pixels; the ragged final chunk is padded with fully
    masked pixels, as in the JAX package, and the gather of the chosen
    values runs on the host.
    """
    dev = _device(device)
    bands = sorted(dn)
    nd, h, w = qa.shape
    px_total = h * w
    qa_flat = qa.reshape(nd, px_total)
    dn_flat = {b: dn[b].reshape(nd, px_total) for b in bands}

    choice = np.empty(px_total, dtype=np.int32)
    ok = np.empty(px_total, dtype=bool)
    for start in range(0, px_total, chunk_px):
        end = min(start + chunk_px, px_total)
        raw = {
            b: torch.from_numpy(np.ascontiguousarray(dn_flat[b][:, start:end])).to(dev)
            for b in bands
        }
        sr = torch.stack([raw[b].to(torch.float32) for b in bands], dim=-1)
        qa_t = torch.from_numpy(np.ascontiguousarray(qa_flat[:, start:end])).to(dev)
        scaled = {b: idx.scale_sr(raw[b], scale, offset) for b in bands}
        valid = idx.qa_valid_mask(qa_t, reject_bits=reject_bits) & idx.sr_valid_mask(scaled)
        n_real = end - start
        if start and n_real < chunk_px:
            pad = chunk_px - n_real
            sr = torch.nn.functional.pad(sr, (0, 0, 0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
        c, o = medoid_indices(sr, valid)
        choice[start:end] = c[:n_real].cpu().numpy()
        ok[start:end] = o[:n_real].cpu().numpy()

    out_dn = {}
    for b in bands:
        picked = np.take_along_axis(dn_flat[b], choice[None, :], axis=0)[0]
        out_dn[b] = np.where(ok, picked, 0).astype(dn[b].dtype).reshape(h, w)
    qa_picked = np.take_along_axis(qa_flat, choice[None, :], axis=0)[0]
    out_qa = np.where(ok, qa_picked, 1).astype(np.uint16).reshape(h, w)
    return out_dn, out_qa
