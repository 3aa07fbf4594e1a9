"""Property-based fuzz of the port's GeoTIFF codec
(``land_trendr_tpu_torch/io/geotiff.py``): the counterpart of
``tests/test_geotiff_property.py``, with its strategies and example
counts, plus a cross-read with the JAX package's codec in both directions.

Any array the writer accepts round-trips bit-exactly through every
(dtype, compression, predictor, layout); the LZW codec round-trips; the
reader fails only with ``ValueError`` on garbage and on corrupted valid
files; any exhaustive partition of a raster streamed in any order decodes
as the one-shot file, overview pages included.  A file the port writes is
read by the JAX ``read_geotiff`` and a file the JAX package writes by the
port's, bit-equal arrays and equal ``GeoMeta`` both ways.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="hypothesis not installed in this environment")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from land_trendr_tpu.io import geotiff as jax_geotiff  # noqa: E402
from land_trendr_tpu_torch.io import geotiff as port_geotiff  # noqa: E402
from land_trendr_tpu_torch.io.geotiff import read_geotiff, write_geotiff  # noqa: E402

DTYPES = ("u1", "u2", "i2", "i4", "f4", "f8")


@st.composite
def rasters(draw):
    dtype = np.dtype(draw(st.sampled_from(DTYPES)))
    bands = draw(st.integers(1, 4))
    h = draw(st.integers(1, 70))
    w = draw(st.integers(1, 70))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    if dtype.kind == "f":
        return rng.normal(size=(bands, h, w)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=(bands, h, w), endpoint=True).astype(dtype)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    arr=rasters(),
    compress=st.sampled_from(["deflate", "lzw", "none"]),
    predictor=st.booleans(),
    tile=st.sampled_from([None, 16, 64]),
)
def test_roundtrip_property(tmp_path_factory, arr, compress, predictor, tile):
    p = str(tmp_path_factory.mktemp("prop") / "x.tif")
    write_geotiff(p, arr, compress=compress, predictor=predictor, tile=tile)
    got, _, info = read_geotiff(p)
    if arr.shape[0] == 1:
        arr = arr[0]
    np.testing.assert_array_equal(got, arr)
    assert info.bands == (1 if arr.ndim == 2 else arr.shape[0])


@settings(max_examples=25, deadline=None)
@given(data=st.binary(min_size=0, max_size=4096))
def test_lzw_codec_roundtrip_property(data):
    from land_trendr_tpu_torch.io.geotiff import _lzw_decode, _lzw_encode

    assert _lzw_decode(_lzw_encode(data)) == data


@settings(max_examples=60, deadline=None)
@given(
    prefix=st.sampled_from([b"", b"II*\x00", b"MM\x00*", b"II+\x00\x08\x00\x00\x00"]),
    blob=st.binary(min_size=0, max_size=256),
)
def test_reader_never_crashes_unhandled(tmp_path_factory, prefix, blob):
    """Garbage, bare or behind a valid classic/BigTIFF magic so the IFD
    parser is reached, decodes or fails with ValueError — never
    struct.error, KeyError, MemoryError or OverflowError."""
    p = str(tmp_path_factory.mktemp("junk") / "junk.tif")
    with open(p, "wb") as f:
        f.write(prefix + blob)
    try:
        read_geotiff(p)
    except ValueError:
        pass


@st.composite
def corruptions(draw):
    """(offset, replacement bytes) mutations of a valid file."""
    return [(draw(st.integers(0, 700)), draw(st.binary(min_size=1, max_size=8)))
            for _ in range(draw(st.integers(1, 6)))]


@settings(max_examples=80, deadline=None)
@given(
    muts=corruptions(),
    compress=st.sampled_from(["deflate", "lzw", "none"]),
    seed=st.integers(0, 2**31 - 1),
)
def test_structured_corruption_never_crashes_unhandled(tmp_path_factory, muts, compress, seed):
    """Mutated valid files reach the IFD entries, counts, block tables and
    compressed payloads; every outcome is a clean decode or a ValueError."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 65535, size=(2, 9, 11), endpoint=True).astype(np.uint16)
    d = tmp_path_factory.mktemp("mut")
    p = str(d / "good.tif")
    write_geotiff(p, arr, compress=compress, tile=None)
    blob = bytearray(open(p, "rb").read())
    for off, val in muts:
        off %= max(1, len(blob))
        blob[off:off + len(val)] = val
    q = str(d / "mut.tif")
    with open(q, "wb") as f:
        f.write(bytes(blob))
    try:
        read_geotiff(q)
    except ValueError:
        pass


@st.composite
def window_partitions(draw):
    """A raster and a random rectangular partition of it: random column
    cuts per row band, so windows are ragged, unaligned and exhaustive."""
    h = draw(st.integers(1, 80))
    w = draw(st.integers(1, 80))
    bands = draw(st.integers(1, 3))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    arr = rng.integers(0, 256, size=(h, w, bands)).astype(np.uint8)

    def cuts(n, lo=1, hi=40):
        out, pos = [0], 0
        while pos < n:
            pos = min(n, pos + int(rng.integers(lo, hi + 1)))
            out.append(pos)
        return out

    wins = []
    ys = cuts(h)
    for y0, y1 in zip(ys, ys[1:]):
        xs = cuts(w)
        for x0, x1 in zip(xs, xs[1:]):
            wins.append((y0, x0, y1 - y0, x1 - x0))
    return arr, [wins[i] for i in rng.permutation(len(wins))]


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    data=window_partitions(),
    compress=st.sampled_from(["deflate", "none"]),
    tile=st.sampled_from([16, 64]),
    overviews=st.sampled_from([0, 2]),
)
def test_stream_writer_partition_property(tmp_path_factory, data, compress, tile, overviews):
    """Any exhaustive rectangular partition, pushed in any order, decodes
    as the one-shot writer's file, overview pages included (the page
    walker: read_geotiff skips them)."""
    from land_trendr_tpu_torch.io.geotiff import GeoTiffStreamWriter

    from test_geotiff import _walk_pages

    arr, wins = data
    h, w, bands = arr.shape
    d = tmp_path_factory.mktemp("sprop")
    ps, po = str(d / "s.tif"), str(d / "o.tif")
    with GeoTiffStreamWriter(ps, h, w, bands, np.uint8, compress=compress, tile=tile,
                             overviews=overviews) as wr:
        for y0, x0, wh, ww in wins:
            wr.write(y0, x0, arr[y0:y0 + wh, x0:x0 + ww])
    write_geotiff(po, np.moveaxis(arr, -1, 0), compress=compress, tile=tile,
                  overviews=overviews, resampling="nearest")
    got_s, _, _ = read_geotiff(ps)
    got_o, _, _ = read_geotiff(po)
    np.testing.assert_array_equal(got_s, got_o)
    assert _walk_pages(ps) == _walk_pages(po)


@st.composite
def geometas(draw):
    """Georeferencing to carry, or none: pixel scale, tiepoint and nodata."""
    if not draw(st.booleans()):
        return None
    fin = st.floats(-1e7, 1e7, allow_nan=False)
    sx = draw(st.floats(0.5, 1000.0))
    return dict(pixel_scale=(sx, sx, 0.0),
                tiepoint=(0.0, 0.0, 0.0, draw(fin), draw(fin), 0.0),
                nodata=draw(st.one_of(st.none(), st.floats(-1e4, 1e4))))


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    arr=rasters(),
    geo=geometas(),
    compress=st.sampled_from(["deflate", "lzw", "none"]),
    predictor=st.booleans(),
    tile=st.sampled_from([None, 16, 64]),
    writer=st.sampled_from(["port", "jax"]),
)
def test_cross_read_with_the_jax_codec(tmp_path_factory, arr, geo, compress, predictor, tile,
                                       writer):
    """A file one package writes, the other reads: arrays bit-equal and the
    GeoMeta equal field for field to what the writer's own reader reads."""
    wmod, rmod = ((port_geotiff, jax_geotiff) if writer == "port"
                  else (jax_geotiff, port_geotiff))
    p = str(tmp_path_factory.mktemp("cross") / "x.tif")
    wmod.write_geotiff(p, arr, geo=None if geo is None else wmod.GeoMeta(**geo),
                       compress=compress, predictor=predictor, tile=tile)
    got, gmeta, _ = rmod.read_geotiff(p)
    own, ometa, _ = wmod.read_geotiff(p)
    want = arr[0] if arr.shape[0] == 1 else arr
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert own.tobytes() == got.tobytes()
    assert dataclasses.asdict(gmeta) == dataclasses.asdict(ometa)
    if geo is not None:
        assert gmeta.pixel_scale == geo["pixel_scale"] and gmeta.tiepoint == geo["tiepoint"]
        # both packages write nodata as GDAL's text tag, "%g" (six digits)
        want_nodata = None if geo["nodata"] is None else float("%g" % geo["nodata"])
        assert gmeta.nodata == want_nodata
