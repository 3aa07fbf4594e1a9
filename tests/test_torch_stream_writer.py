"""The port's ``GeoTiffStreamWriter`` (``land_trendr_tpu_torch/io/geotiff.py``):
the counterpart of each case of ``tests/test_stream_writer.py``, and its
bytes against the JAX package's writer.

Incremental tiled writes decode identically to the one-shot writer, in
any window order; streamed overviews equal the one-shot nearest pyramid;
incomplete coverage and overlapping windows are refused; BigTIFF is picked
when the worst case cannot fit 32-bit offsets, or when forced; the
compression level trades size, not content.  And a file streamed by the
port is byte for byte the file the JAX writer streams from the same
windows, for every compression, with and without overviews.
"""

import numpy as np
import pytest

from land_trendr_tpu.io import geotiff as jax_geotiff
from land_trendr_tpu_torch.io import geotiff as port_geotiff
from land_trendr_tpu_torch.io.geotiff import (
    GeoMeta,
    GeoTiffStreamWriter,
    read_geotiff,
    write_geotiff,
)

from test_geotiff import _walk_pages

GEO = dict(pixel_scale=(30.0, 30.0, 0.0), tiepoint=(0, 0, 0, 5e5, 4e6, 0))


def _windows(h, w, th, tw):
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            yield y0, x0, min(th, h - y0), min(tw, w - x0)


@pytest.mark.parametrize("compress", ["deflate", "lzw", "none"])
def test_roundtrip_matches_oneshot(tmp_path, rng, compress):
    """Aligned and unaligned window grids both reproduce the array bit for
    bit, and decode equal to a write_geotiff file of the same data."""
    a = rng.integers(0, 4000, size=(3, 300, 517)).astype(np.uint16)
    geo = GeoMeta(**GEO)
    for name, th, tw in [("aligned", 256, 256), ("ragged", 96, 120)]:
        p = tmp_path / f"stream_{name}.tif"
        with GeoTiffStreamWriter(str(p), 300, 517, 3, np.uint16, geo=geo,
                                 compress=compress) as wr:
            for y0, x0, h, w in _windows(300, 517, th, tw):
                wr.write(y0, x0, np.moveaxis(a[:, y0:y0 + h, x0:x0 + w], 0, -1))
        got, ggeo, info = read_geotiff(str(p))
        np.testing.assert_array_equal(got, a)
        assert ggeo.pixel_scale == geo.pixel_scale
        assert info.tiled and not info.big
    ref = tmp_path / "oneshot.tif"
    write_geotiff(str(ref), a, geo=geo, compress=compress)
    ref_arr, _, _ = read_geotiff(str(ref))
    np.testing.assert_array_equal(ref_arr, a)


def test_out_of_order_windows_and_2d(tmp_path, rng):
    a = rng.normal(size=(130, 97)).astype(np.float32)
    p = tmp_path / "ooo.tif"
    wins = list(_windows(130, 97, 64, 64))
    rng.shuffle(wins)
    with GeoTiffStreamWriter(str(p), 130, 97, 1, np.float32, tile=64) as wr:
        for y0, x0, h, w in wins:
            wr.write(y0, x0, a[y0:y0 + h, x0:x0 + w])
    got, _, _ = read_geotiff(str(p))
    np.testing.assert_array_equal(got, a)


def test_streaming_overviews_match_oneshot_nearest(tmp_path, rng):
    """The decimation cascade reproduces write_geotiff's nearest pyramid
    page for page, even from unaligned windows."""
    a = rng.integers(0, 255, size=(1, 130, 97)).astype(np.uint8)
    ps = tmp_path / "stream.tif"
    with GeoTiffStreamWriter(str(ps), 130, 97, 1, np.uint8, tile=64, overviews=2) as wr:
        for y0, x0, h, w in _windows(130, 97, 48, 80):  # unaligned on purpose
            wr.write(y0, x0, np.moveaxis(a[:, y0:y0 + h, x0:x0 + w], 0, -1))
    po = tmp_path / "oneshot.tif"
    write_geotiff(str(po), a, overviews=2, tile=64, resampling="nearest")
    assert _walk_pages(str(ps)) == _walk_pages(str(po)) == [
        (130, 97, 0), (65, 49, 1), (33, 25, 1)]
    s_arr, _, _ = read_geotiff(str(ps))
    o_arr, _, _ = read_geotiff(str(po))
    np.testing.assert_array_equal(s_arr, o_arr)
    np.testing.assert_array_equal(s_arr, a[0])


def test_incomplete_coverage_raises_and_allow_partial(tmp_path, rng):
    a = rng.integers(0, 255, size=(64, 64)).astype(np.uint8)
    wr = GeoTiffStreamWriter(str(tmp_path / "partial.tif"), 128, 128, 1, np.uint8, tile=64)
    wr.write(0, 0, a)
    with pytest.raises(ValueError, match="not fully covered"):
        wr.close()
    p2 = tmp_path / "partial_ok.tif"
    with GeoTiffStreamWriter(str(p2), 128, 128, 1, np.uint8, tile=64,
                             allow_partial=True) as wr:
        wr.write(0, 0, a)
        wr.write(64, 64, a)  # diagonal: two blocks zero-filled
    got, _, _ = read_geotiff(str(p2))
    np.testing.assert_array_equal(got[:64, :64], a)
    np.testing.assert_array_equal(got[64:, 64:], a)
    assert (got[:64, 64:] == 0).all() and (got[64:, :64] == 0).all()


def test_overlapping_windows_rejected(tmp_path, rng):
    a = rng.integers(0, 255, size=(64, 64)).astype(np.uint8)
    wr = GeoTiffStreamWriter(str(tmp_path / "ovl.tif"), 64, 128, 1, np.uint8, tile=64)
    wr.write(0, 0, a)
    with pytest.raises(ValueError, match="written twice"):
        wr.write(0, 32, a[:, :32])


def test_bigtiff_auto_bound_and_force(tmp_path, rng):
    """Forced BigTIFF round-trips; the auto bound stays classic for small
    files and switches when the worst-case encoded size cannot fit u32."""
    from land_trendr_tpu_torch.io.geotiff import _resolve_compress, _StreamLevel

    a = rng.integers(0, 255, size=(40, 40)).astype(np.uint8)
    p = tmp_path / "big.tif"
    with GeoTiffStreamWriter(str(p), 40, 40, 1, np.uint8, tile=32, bigtiff=True) as wr:
        wr.write(0, 0, a)
    got, _, info = read_geotiff(str(p))
    assert info.big
    np.testing.assert_array_equal(got, a)
    # _pick_layout sees only shape fields: a CONUS-scale float32 writer and
    # a scene-scale one, fabricated without touching disk
    probe = GeoTiffStreamWriter.__new__(GeoTiffStreamWriter)
    for h, w, expect_big in [(2048, 2048, False), (100_000, 100_000, True)]:
        probe.spp = 1
        probe.dtype = np.dtype("<f4")
        probe.tile = 256
        probe.comp_id = _resolve_compress("deflate")
        probe.levels = [_StreamLevel(h, w, 256)]
        assert probe._pick_layout("auto") is expect_big, (h, w)


def test_compress_level_trades_size_not_content(tmp_path):
    """compress_level=1 decodes identically to level 6."""
    img = np.random.default_rng(0).integers(7000, 44000, (300, 400)).astype(np.uint16)
    paths = {}
    for lvl in (1, 6):
        p = tmp_path / f"l{lvl}.tif"
        w = GeoTiffStreamWriter(str(p), 300, 400, 1, np.uint16, compress="deflate",
                                tile=128, compress_level=lvl)
        w.write(0, 0, img[..., None])
        w.close()
        paths[lvl] = p
    a, _, _ = read_geotiff(str(paths[1]))
    b, _, _ = read_geotiff(str(paths[6]))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, img)
    assert paths[1].stat().st_size != paths[6].stat().st_size


@pytest.mark.parametrize("overviews", [0, 2])
@pytest.mark.parametrize("compress", ["deflate", "lzw", "none"])
def test_bytes_equal_the_jax_writer(tmp_path, rng, compress, overviews):
    """The same windows, in the same order, through both writers: the
    files are equal byte for byte (header, tags, block tables, payloads,
    overview pages)."""
    a = rng.integers(0, 4000, size=(130, 197, 3)).astype(np.uint16)
    wins = list(_windows(130, 197, 48, 80))
    rng.shuffle(wins)
    files = []
    for name, mod in (("jax", jax_geotiff), ("port", port_geotiff)):
        p = tmp_path / f"{name}.tif"
        with mod.GeoTiffStreamWriter(str(p), 130, 197, 3, np.uint16, geo=mod.GeoMeta(**GEO),
                                     compress=compress, tile=64, overviews=overviews) as wr:
            for y0, x0, h, w in wins:
                wr.write(y0, x0, a[y0:y0 + h, x0:x0 + w])
        files.append(p.read_bytes())
    assert files[0] == files[1]
    got, _, _ = read_geotiff(str(tmp_path / "port.tif"))
    np.testing.assert_array_equal(got, np.moveaxis(a, -1, 0))
