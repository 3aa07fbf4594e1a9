"""Change maps of the port against the JAX package's ``ops/change.py``.

``select_change`` takes the same float32 segment arrays in both packages
(with ties, −0.0, dead slots and zero rmse among them) and must return
the same products bit for bit, for every ``kind`` × ``sort`` and for each
filter on its own.  The host code — 4-connected labelling, the
minimum-mapping-unit sieve, the streaming change-raster writer and the
post-assembly sieve — must give the same arrays and the same GeoTIFF
bytes as the JAX package's on the same segment rasters.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from land_trendr_tpu.ops import change as jchange
from land_trendr_tpu_torch.ops import change
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
from land_trendr_tpu_torch.runtime.driver import RunConfig, assemble_outputs, run_stack
from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

PX, NV, NM = 512, 7, 6


def _segments(seed: int):
    """float32 segment arrays in natural orientation, shaped like the
    assembled rasters the selector reads."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, NV + 1, size=PX)              # live vertices per pixel
    slot = np.arange(NV)[None, :]
    live_v = slot < k[:, None]
    start = rng.integers(1984, 2000, size=(PX, 1))
    steps = rng.integers(1, 7, size=(PX, NV))
    years = np.where(live_v, start + np.cumsum(steps, axis=1) - steps[:, :1], 0)
    fits = np.where(live_v, rng.normal(0.4, 0.3, (PX, NV)), 0.0)
    seg_live = np.arange(NM)[None, :] < (k[:, None] - 1)
    mag = np.where(seg_live, np.diff(fits, axis=1), 0.0)
    mag[rng.uniform(size=(PX, NM)) < 0.05] = -0.0      # −0.0 picks as +0.0
    mag[::7, 1] = mag[::7, 0]                          # ties: first slot wins
    dur = np.where(seg_live, np.diff(years, axis=1), 0.0)
    rate = np.where(dur > 0, mag / np.where(dur > 0, dur, 1.0), 0.0)
    mv = rng.uniform(size=PX) < 0.8
    p = rng.uniform(0.0, 0.2, size=PX)
    rmse = np.where(rng.uniform(size=PX) < 0.1, 0.0, rng.uniform(0.01, 0.1, PX))
    f32 = np.float32
    return (years.astype(f32), fits.astype(f32), mag.astype(f32), dur.astype(f32),
            rate.astype(f32), mv, p.astype(f32), rmse.astype(f32))


def _both(arrays, sign, filt_kwargs):
    got = change.select_change(
        *(torch.from_numpy(a) for a in arrays), sign=sign,
        filt=change.ChangeFilter(**filt_kwargs),
    )
    ref = jchange.select_change(*arrays, sign=sign, filt=jchange.ChangeFilter(**filt_kwargs))
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in ref.items()}


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref) == sorted(change.CHANGE_PRODUCTS)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("kind", ["disturbance", "recovery"])
@pytest.mark.parametrize("sort", ["greatest", "newest", "oldest"])
def test_select_change_kind_sort(kind, sort):
    got, ref = _both(_segments(1), -1.0, {"kind": kind, "sort": sort})
    _assert_same(got, ref)
    assert 0 < got["mask"].sum() < PX


@pytest.mark.parametrize(
    "filt",
    [
        {"min_mag": 0.2},
        {"min_dur": 3.0},
        {"max_dur": 4.0},
        {"min_preval": 0.3},
        {"max_p": 0.05},
        {"year_min": 1995.0},
        {"year_max": 2001.0},
    ],
    ids=lambda f: next(iter(f)),
)
def test_select_change_filters(filt):
    arrays = _segments(2)
    got, ref = _both(arrays, -1.0, filt)
    _assert_same(got, ref)
    base, _ = _both(arrays, -1.0, {})
    assert got["mask"].sum() < base["mask"].sum()   # the filter removed something


def test_select_change_positive_sign():
    got, ref = _both(_segments(3), 1.0, {"sort": "newest", "max_dur": 5.0})
    _assert_same(got, ref)


def test_change_filter_rejects():
    with pytest.raises(ValueError, match="kind"):
        change.ChangeFilter(kind="fire")
    with pytest.raises(ValueError, match="sort"):
        change.ChangeFilter(sort="largest")
    # the fields the run fingerprint hashes are the JAX package's
    assert dataclasses.asdict(change.ChangeFilter(max_dur=4.0)) == dataclasses.asdict(
        jchange.ChangeFilter(max_dur=4.0)
    )


def _random_mask(seed, shape, density):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=shape) < density


@pytest.mark.parametrize(
    "shape,density", [((1, 1), 1.0), ((37, 53), 0.3), ((64, 200), 0.55), ((120, 90), 0.7)]
)
def test_label4_matches_jax(shape, density):
    m = _random_mask(sum(shape), shape, density)
    lab, n = change.label4(m)
    jlab, jn = jchange.label4(m)
    assert n == jn and lab.dtype == jlab.dtype
    np.testing.assert_array_equal(lab, jlab)


@pytest.mark.parametrize("mmu", [1, 2, 5, 20])
def test_mmu_sieve_matches_jax(mmu):
    m = _random_mask(mmu, (80, 111), 0.45)
    np.testing.assert_array_equal(change.mmu_sieve(m, mmu), jchange.mmu_sieve(m, mmu))


def test_label4_empty():
    lab, n = change.label4(np.zeros((5, 6), bool))
    assert n == 0 and (lab == 0).all()
    assert not change.mmu_sieve(np.zeros((5, 6), bool), 3).any()


@pytest.fixture(scope="module")
def seg_rasters(tmp_path_factory):
    """Segment rasters of a small synthetic stack (the port, on the CPU)."""
    root = tmp_path_factory.mktemp("seg")
    stack = stack_from_synthetic(make_stack(SceneSpec(height=80, width=72, seed=3)))
    cfg = RunConfig(tile_size=48, workdir=str(root / "w"), out_dir=str(root / "o"))
    run_stack(stack, cfg, device="cpu")
    assemble_outputs(stack, cfg)
    return cfg.out_dir


def _same_files(a_dir, b_dir, names):
    for name in names:
        with open(os.path.join(a_dir, name), "rb") as fa, open(os.path.join(b_dir, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize(
    "filt,mmu",
    [({}, 1), ({"max_dur": 4.0}, 4), ({"kind": "recovery", "sort": "oldest"}, 2)],
    ids=["default", "fast_mmu4", "recovery_mmu2"],
)
def test_write_change_maps_byte_equal(seg_rasters, tmp_path, filt, mmu):
    # small bands: several windows, ragged edge chunks
    ours = change.write_change_maps(
        seg_rasters, str(tmp_path / "ours"), filt=change.ChangeFilter(**filt), mmu=mmu,
        band_px=1000, device="cpu",
    )
    theirs = jchange.write_change_maps(
        seg_rasters, str(tmp_path / "theirs"), filt=jchange.ChangeFilter(**filt), mmu=mmu,
        band_px=1000,
    )
    assert sorted(ours) == sorted(theirs) == sorted(change.CHANGE_PRODUCTS)
    _same_files(str(tmp_path / "ours"), str(tmp_path / "theirs"),
                [os.path.basename(p) for p in ours.values()])


def test_write_change_maps_needs_segment_rasters(tmp_path):
    with pytest.raises(FileNotFoundError, match="run `segment`"):
        change.write_change_maps(str(tmp_path), str(tmp_path / "d"), device="cpu")


@pytest.mark.parametrize("mmu", [1, 3, 9])
def test_sieve_change_rasters_byte_equal(seg_rasters, tmp_path, mmu):
    for side in ("ours", "theirs"):
        change.write_change_maps(seg_rasters, str(tmp_path / side), device="cpu")
    change.sieve_change_rasters(str(tmp_path / "ours"), mmu, band_px=1000)
    jchange.sieve_change_rasters(str(tmp_path / "theirs"), mmu, band_px=1000)
    _same_files(str(tmp_path / "ours"), str(tmp_path / "theirs"),
                [f"change_{k}.tif" for k in change.CHANGE_PRODUCTS])
