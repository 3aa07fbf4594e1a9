"""The port's medoid composite against the JAX package's.

``medoid_indices`` picks the same date as the JAX function wherever the
two smallest distances differ by more than float32 rounding.  At a
near-tie (the two smallest float64 distances within ``NEAR_TIE_REL`` of
each other, relative) the float32 band sum — PyTorch's reduction order
against XLA's — may turn the choice either way, so there both packages
must pick one of the tied dates.  ``medoid_composite`` and the C2 loader
with ``composite="medoid"`` are held equal to the JAX package's on the
CPU; the card's equality with the CPU is ``tests/test_torch_cuda.py``'s.
"""

import os

import numpy as np
import pytest
import torch

from land_trendr_tpu.io.geotiff import GeoMeta, write_geotiff
from land_trendr_tpu.ops import composite as jcomposite
from land_trendr_tpu.runtime import load_stack_dir_c2 as jload_c2
from land_trendr_tpu_torch.ops import composite
from land_trendr_tpu_torch.runtime.stack import load_stack_dir, load_stack_dir_c2

torch.set_num_threads(1)

#: relative gap under which the two smallest distances count as a near-tie:
#: a few float32 ulps of the distance sum
NEAR_TIE_REL = 1e-6


def _ref_distances(sr: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(nd, px) float64 squared distances to the masked per-band median,
    +inf at invalid dates — the JAX formula, in float64."""
    vals = np.where(valid[:, :, None], sr.astype(np.float64), np.inf)
    s = np.sort(vals, axis=0)
    n = valid.sum(axis=0)
    lo = np.take_along_axis(s, np.maximum((n - 1) // 2, 0)[None, :, None].repeat(sr.shape[2], 2), 0)
    hi = np.take_along_axis(s, np.maximum(n // 2, 0)[None, :, None].repeat(sr.shape[2], 2), 0)
    med = 0.5 * (lo + hi)
    with np.errstate(invalid="ignore"):
        d = ((sr - med) ** 2).sum(-1)
    return np.where(valid, d, np.inf)


@pytest.mark.parametrize("nd", [2, 3, 5])
@pytest.mark.parametrize("nb", [1, 2, 6])
def test_medoid_indices_match_jax(rng, nd, nb):
    px = 4096
    # small DN ranges make exact and near ties common
    sr = rng.integers(7000, 7060, size=(nd, px, nb)).astype(np.float32)
    sr[:, : px // 2] = rng.integers(7000, 40000, size=(nd, px // 2, nb))
    valid = rng.uniform(size=(nd, px)) > 0.25
    c, ok = composite.medoid_indices(torch.from_numpy(sr), torch.from_numpy(valid))
    jc, jok = jcomposite.medoid_indices(sr, valid)
    c, ok, jc, jok = c.numpy(), ok.numpy(), np.asarray(jc), np.asarray(jok)
    assert c.dtype == np.int32 and np.array_equal(ok, jok)
    d = _ref_distances(sr, valid)
    srt = np.sort(d, axis=0)
    with np.errstate(invalid="ignore"):  # inf - inf where < 2 dates are valid
        gap = srt[1] - srt[0]
    near = ok & np.isfinite(srt[0]) & (gap <= NEAR_TIE_REL * np.maximum(srt[0], 1.0))
    # away from near-ties the choice is the JAX function's exactly
    assert np.array_equal(c[~near], jc[~near])
    # at a near-tie each package picks one of the tied dates
    tied = d <= (srt[0] + NEAR_TIE_REL * np.maximum(srt[0], 1.0))[None, :]
    cols = np.arange(px)
    assert tied[c[near], cols[near]].all() and tied[jc[near], cols[near]].all()
    # and exact ties (equal float64 distances) go to the lowest date in both
    exact = ok & (gap == 0)
    first = np.argmax(d == srt[0][None, :], axis=0)
    assert np.array_equal(c[exact], first[exact])
    assert near.sum() < px  # the near-tie set is a minority


@pytest.mark.parametrize(
    "vals,valid,want",
    [
        ([0.0, 1.0, 10.0], None, (1, True)),
        ([0.0, 2.0, 2.0], None, (1, True)),  # tie → first
        ([0.0, 1.0, 10.0], [True, False, True], (0, True)),
        ([1.0, 2.0, 3.0], [False, False, False], (0, False)),
    ],
    ids=["median", "tie-first", "invalid-excluded", "all-invalid"],
)
def test_medoid_unit_cases(vals, valid, want):
    sr = np.asarray(vals, np.float32)[:, None, None]
    v = np.ones(sr.shape[:2], bool) if valid is None else np.asarray(valid)[:, None]
    c, ok = composite.medoid_indices(torch.from_numpy(sr), torch.from_numpy(v))
    assert (int(c[0]), bool(ok[0])) == want


@pytest.mark.parametrize("chunk_px", [1 << 21, 50])
def test_medoid_composite_matches_jax(rng, chunk_px):
    nd, h, w = 3, 13, 11
    dn = {
        "nir": rng.integers(7300, 43000, (nd, h, w)).astype(np.uint16),
        "swir2": rng.integers(7300, 43000, (nd, h, w)).astype(np.uint16),
    }
    dn["nir"][1, 2, :] = 60000  # QA-clear but saturated: never selectable
    qa = np.where(rng.uniform(size=(nd, h, w)) < 0.3, 1 << 3, 0).astype(np.uint16)
    qa[:, 0, 0] = 1 << 3  # nothing valid: fill QA, DN 0
    ours = composite.medoid_composite(dn, qa, chunk_px=chunk_px, device="cpu")
    theirs = jcomposite.medoid_composite(dn, qa, chunk_px=chunk_px)
    for b in dn:
        assert ours[0][b].dtype == theirs[0][b].dtype == np.uint16
        assert np.array_equal(ours[0][b], theirs[0][b]), b
    assert np.array_equal(ours[1], theirs[1])
    assert ours[1][0, 0] == 1 and ours[0]["nir"][0, 0] == 0


def _write_multidate_archive(d, rng, h=40, w=48, years=(2010, 2011, 2012)):
    """Per year 1–3 acquisitions of one base scene with per-date noise and
    clouds; returns nothing (the loaders read it back)."""
    os.makedirs(d, exist_ok=True)
    geo = GeoMeta(pixel_scale=(30.0, 30.0, 0.0),
                  tiepoint=(0.0, 0.0, 0.0, 500000.0, 5000000.0, 0.0))
    base = {"nir": rng.integers(15000, 25000, (h, w)), "swir2": rng.integers(8000, 12000, (h, w))}
    nums = {"nir": 4, "swir2": 7}
    for i, year in enumerate(years):
        for k, date in enumerate(("0610", "0712", "0830")[: 1 + i]):
            stem = f"LT05_L2SP_045030_{year}{date}_{year}{date}_02_T1"
            for b, n in nums.items():
                a = base[b] + rng.integers(-300, 300, (h, w)) + 200 * k
                write_geotiff(os.path.join(d, f"{stem}_SR_B{n}.TIF"), a.astype(np.uint16), geo=geo)
            qa = np.where(rng.uniform(size=(h, w)) < 0.2, 1 << 3, 0).astype(np.uint16)
            write_geotiff(os.path.join(d, f"{stem}_QA_PIXEL.TIF"), qa, geo=geo)


def test_c2_medoid_load_matches_jax(tmp_path, rng):
    d = str(tmp_path / "arc")
    _write_multidate_archive(d, rng)
    ours = load_stack_dir_c2(d, bands=("nir", "swir2"), composite="medoid", device="cpu")
    theirs = jload_c2(d, bands=("nir", "swir2"), composite="medoid")
    assert np.array_equal(ours.years, theirs.years)
    for b in ("nir", "swir2"):
        assert np.array_equal(ours.dn_bands[b], theirs.dn_bands[b]), b
    assert np.array_equal(ours.qa, theirs.qa)
    # the auto-detecting loader takes the same path
    again = load_stack_dir(d, bands=("nir", "swir2"), composite="medoid", device="cpu")
    assert np.array_equal(again.qa, ours.qa)


def test_composite_defaults_to_the_card(tmp_path, rng):
    d = str(tmp_path / "arc")
    _write_multidate_archive(d, rng, h=8, w=8)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        load_stack_dir_c2(d, bands=("nir", "swir2"), composite="medoid")
    with pytest.raises(ValueError, match="not None"):
        load_stack_dir_c2(d, composite="mean", device="cpu")
    with pytest.raises(ValueError, match="composite"):
        load_stack_dir_c2(d, bands=("nir", "swir2"), device="cpu")
