"""The port's GeoTIFF window reads against the JAX package's, on files of
every layout the writer makes, through the native decoder and without it."""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from land_trendr_tpu.io.geotiff import read_geotiff_window as jax_read_window
from land_trendr_tpu_torch.io import native
from land_trendr_tpu_torch.io.geotiff import read_geotiff, read_geotiff_window, write_geotiff

WINDOWS = [(0, 0, 50, 37), (3, 5, 20, 17), (31, 16, 19, 21), (49, 36, 1, 1)]
NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "lt_native.cc"


@pytest.fixture(scope="session")
def native_lib(tmp_path_factory):
    """This file's own build of the native codec: compiled with
    ``native/Makefile``'s flags into a private directory (so it never races
    another test's ``make`` of ``native/liblt_native.so``), then loaded
    through the ``LT_NATIVE_LIB`` candidate."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native codec cannot be built here")
    lib = tmp_path_factory.mktemp("native") / "liblt_native.so"
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-o", str(lib),
         str(NATIVE_SRC), "-lz", "-pthread"],
        check=True, capture_output=True,
    )
    old = os.environ.get("LT_NATIVE_LIB")
    os.environ["LT_NATIVE_LIB"] = str(lib)
    try:
        native._LIB, native._LIB_PATH = native._load()
        assert native.lib_path() == str(lib), native.lib_path()
        yield lib
    finally:
        if old is None:
            os.environ.pop("LT_NATIVE_LIB", None)
        else:
            os.environ["LT_NATIVE_LIB"] = old


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def decoder(request, monkeypatch):
    if request.param:
        request.getfixturevalue("native_lib")
        assert native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("compress", ["deflate", "lzw", "none"])
@pytest.mark.parametrize("tile", [16, None], ids=["tiled", "striped"])
@pytest.mark.parametrize("bands", [1, 3])
def test_window_reads_match_jax(tmp_path, decoder, compress, tile, bands):
    rng = np.random.default_rng(7)
    arr = rng.integers(-3000, 12000, size=(bands, 50, 37)).astype(np.int16)
    path = str(tmp_path / "r.tif")
    write_geotiff(path, arr if bands > 1 else arr[0], compress=compress, tile=tile)
    full = read_geotiff(path)[0]
    assert np.array_equal(full if bands > 1 else full[None], arr)
    for y0, x0, h, w in WINDOWS:
        got = read_geotiff_window(path, y0, x0, h, w)
        ref = jax_read_window(path, y0, x0, h, w)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        want = arr[:, y0 : y0 + h, x0 : x0 + w]
        assert np.array_equal(got if bands > 1 else got[None], want)


def test_window_outside_raster_raises(tmp_path):
    path = str(tmp_path / "r.tif")
    write_geotiff(path, np.zeros((8, 8), np.uint16))
    with pytest.raises(ValueError, match="outside raster"):
        read_geotiff_window(path, 4, 4, 8, 8)
