"""Spectral indices and masks of the port, elementwise against the JAX
package's ``ops/indices.py`` on random DNs and QA words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from land_trendr_tpu.ops import indices as jidx
from land_trendr_tpu_torch.ops import indices as tidx

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)



def _dns(rng, dtype, shape=(64, 40)):
    if dtype == np.int16:
        return rng.integers(-2000, 32767, size=shape).astype(np.int16)
    return rng.integers(0, 65535, size=shape).astype(np.uint16)


@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
def test_scale_sr(rng, dtype):
    dn = _dns(rng, dtype)
    got = tidx.scale_sr(torch.from_numpy(dn)).numpy()
    ref = np.asarray(jidx.scale_sr(jnp.asarray(dn)))
    assert got.dtype == np.float32
    # one float32 rounding step apart at most (XLA may fuse multiply-add)
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=3e-8)


@pytest.mark.parametrize("reject", [jidx.DEFAULT_QA_REJECT, 0x1, 0xFF00, 0x8001])
def test_qa_valid_mask(rng, reject):
    qa = rng.integers(0, 65536, size=(64, 40)).astype(np.uint16)
    got = tidx.qa_valid_mask(torch.from_numpy(qa), reject).numpy()
    ref = np.asarray(jidx.qa_valid_mask(jnp.asarray(qa), reject))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["nbr", "ndvi", "tcw"])
@pytest.mark.parametrize("positive", [True, False])
def test_compute_index(rng, name, positive):
    bands_np = {
        b: (rng.uniform(-0.05, 1.0, size=(64, 40))).astype(np.float32) for b in tidx.BANDS
    }
    bands_np["nir"][0, :3] = 0.0  # zero denominators where nir + red/swir2 may vanish
    bands_np["swir2"][0, :3] = 0.0
    bands_np["red"][0, :3] = 0.0
    got = tidx.compute_index(
        name, {k: torch.from_numpy(v) for k, v in bands_np.items()}, positive
    ).numpy()
    ref = np.asarray(
        jidx.compute_index(name, {k: jnp.asarray(v) for k, v in bands_np.items()}, positive)
    )
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_sr_valid_mask(rng):
    bands_np = {
        b: rng.uniform(-0.3, 1.3, size=(32, 40)).astype(np.float32) for b in ("nir", "swir2")
    }
    bands_np["nir"][1, 1] = np.nan
    bands_np["swir2"][2, 2] = np.inf
    got = tidx.sr_valid_mask({k: torch.from_numpy(v) for k, v in bands_np.items()}).numpy()
    ref = np.asarray(jidx.sr_valid_mask({k: jnp.asarray(v) for k, v in bands_np.items()}))
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tidx.sr_valid_mask({"qa": torch.zeros(2)})


def test_tables_match():
    # the JAX package's three indices as it has them; the port's own three
    # (the ensemble's NDMI, TCB, TCG: the JAX package has none) pinned
    assert tidx.BANDS == jidx.BANDS
    shared = jidx.INDEX_NAMES
    assert shared == ("nbr", "ndvi", "tcw") and tidx.INDEX_NAMES[:3] == shared
    assert {k: tidx.DISTURBANCE_SIGN[k] for k in shared} == jidx.DISTURBANCE_SIGN
    assert tidx.DEFAULT_QA_REJECT == jidx.DEFAULT_QA_REJECT
    assert {k: tidx.INDEX_BANDS[k] for k in shared} == jidx.INDEX_BANDS
    own = {k: v for k, v in tidx.DISTURBANCE_SIGN.items() if k not in shared}
    assert own == {"ndmi": -1.0, "tcb": 1.0, "tcg": -1.0}
    assert {k: tidx.INDEX_BANDS[k] for k in own} == {
        "ndmi": ("nir", "swir1"), "tcb": tidx.BANDS, "tcg": tidx.BANDS}
    for index in ("nbr", "ndvi", "tcw"):
        assert tidx.required_bands(index) == jidx.required_bands(index)
    assert tidx.required_bands("nbr", ("ndvi",)) == jidx.required_bands("nbr", ("ndvi",))
    with pytest.raises(ValueError, match="unknown index"):
        tidx.required_bands("evi")
    with pytest.raises(ValueError, match="unknown index"):
        tidx.compute_index("evi", {})


#: one pixel's reflectances, in BANDS order, and each new index of them
#: computed by hand (Crist 1985's coefficients; NDMI of NIR and SWIR1)
_PIXEL = {"blue": 0.02, "green": 0.04, "red": 0.03, "nir": 0.35, "swir1": 0.15, "swir2": 0.07}
_BY_HAND = {
    # (0.35 - 0.15) / (0.35 + 0.15)
    "ndmi": 0.4,
    # 0.2043*0.02 + 0.4158*0.04 + 0.5524*0.03 + 0.5741*0.35 + 0.3124*0.15 + 0.2303*0.07
    "tcb": 0.004086 + 0.016632 + 0.016572 + 0.200935 + 0.04686 + 0.016121,
    # -0.1603*0.02 - 0.2819*0.04 - 0.4934*0.03 + 0.7940*0.35 - 0.0002*0.15 - 0.1446*0.07
    "tcg": -0.003206 - 0.011276 - 0.014802 + 0.2779 - 0.00003 - 0.010122,
}


@pytest.mark.parametrize("name", sorted(_BY_HAND))
@pytest.mark.parametrize("positive", [True, False])
def test_new_index_by_hand(name, positive):
    bands = {b: torch.tensor([[v]], dtype=torch.float32) for b, v in _PIXEL.items()}
    got = tidx.compute_index(name, bands, positive)
    assert got.dtype == torch.float32 and got.shape == (1, 1)
    sign = tidx.DISTURBANCE_SIGN[name] if positive else 1.0
    assert float(got) == pytest.approx(sign * _BY_HAND[name], rel=1e-6, abs=1e-8)


def test_ndmi_reads_a_zero_denominator_as_zero():
    z = torch.zeros((2, 3))
    assert bool((tidx.ndmi(z, z) == 0).all())
    assert float(tidx.ndmi(torch.tensor(0.35), torch.tensor(0.15))) == pytest.approx(0.4)


def test_tasseled_cap_sums_in_band_order(rng):
    # float32 sums left to right in BANDS order: the same bits as writing
    # the sum out term by term, and TCW unchanged by sharing that sum
    bands = {b: torch.from_numpy(rng.uniform(0, 0.6, size=(64, 40)).astype(np.float32))
             for b in tidx.BANDS}
    coeffs = {"tcb": tidx._TCB_COEFFS, "tcg": tidx._TCG_COEFFS, "tcw": tidx._TCW_COEFFS}
    for name, c in coeffs.items():
        b = [bands[k] for k in tidx.BANDS]
        want = c[0] * b[0] + c[1] * b[1] + c[2] * b[2] + c[3] * b[3] + c[4] * b[4] + c[5] * b[5]
        got = tidx.compute_index(name, bands, disturbance_positive=False)
        assert torch.equal(got, want), name
    ref = np.asarray(jidx.compute_index("tcw", {k: jnp.asarray(v.numpy()) for k, v in bands.items()}))
    np.testing.assert_allclose(tidx.compute_index("tcw", bands).numpy(), ref,
                               rtol=1e-6, atol=1e-7)
