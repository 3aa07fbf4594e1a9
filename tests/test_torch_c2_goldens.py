"""The port's Collection-2 ingest held to the independent spec-level writer.

``tests/test_c2_goldens.py`` builds Landsat Collection-2 Level-2
lookalikes with ``_RawTiffWriter`` — written from the TIFF 6.0 / GeoTIFF
specs with ``struct``, sharing no code with either package's codec.  That
file is loaded here by path (it stays unchanged) and its ``_write_scene``
writes every variant: both endiannesses, stripped and tiled, deflate with
the horizontal predictor, each series switching from LT05 to LC08 band
numbering mid-way.  The port's ``load_stack_dir_c2`` and
``open_stack_dir_c2_lazy`` must decode each to cubes byte-equal to the JAX
package's loaders on the same files.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from land_trendr_tpu.runtime.stack import load_stack_dir_c2 as jax_load_c2
from land_trendr_tpu.runtime.stack import open_stack_dir_c2_lazy as jax_open_lazy
from land_trendr_tpu_torch.runtime.stack import load_stack_dir_c2, open_stack_dir_c2_lazy

_SPEC = importlib.util.spec_from_file_location(
    "c2_goldens_writer", Path(__file__).resolve().parent / "test_c2_goldens.py")
ref = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ref)

VARIANTS = sorted(ref._VARIANTS)


@pytest.fixture(scope="module")
def golden_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_c2_goldens")
    for name, writer in ref._VARIANTS.items():
        ref._write_scene(root / name, writer)
    return root


def test_the_variants_cover_the_spec():
    kinds = {(w.bo, w.layout[0], w.compression) for w in ref._VARIANTS.values()}
    assert {bo for bo, _, _ in kinds} == {"<", ">"}
    assert {lay for _, lay, _ in kinds} == {"strips", "tiles"}
    assert 8 in {c for _, _, c in kinds}  # deflate (+ predictor)
    # the series switches sensor generation: LT05 names, then LC08 names
    names = [ref._c2_name(y, "nir") for y in ref.YEARS]
    assert names[0].startswith("LT05") and names[-1].startswith("LC08")


def _assert_same(mine, theirs, ctx: str) -> None:
    assert mine.years.tolist() == theirs.years.tolist(), ctx
    assert mine.shape == theirs.shape, ctx
    assert set(mine.dn_bands) == set(theirs.dn_bands), ctx
    for b in theirs.dn_bands:
        a, t = np.asarray(mine.dn_bands[b][:, :, :]), np.asarray(theirs.dn_bands[b][:, :, :])
        assert a.dtype == t.dtype and a.shape == t.shape, f"{ctx}:{b}"
        assert a.tobytes() == t.tobytes(), f"{ctx}:{b}"
    qa_m, qa_t = np.asarray(mine.qa[:, :, :]), np.asarray(theirs.qa[:, :, :])
    assert qa_m.dtype == qa_t.dtype and qa_m.tobytes() == qa_t.tobytes(), f"{ctx}:qa"


@pytest.mark.parametrize("variant", VARIANTS)
def test_eager_c2_loader_matches_the_jax_package(golden_root, variant):
    src = str(golden_root / variant)
    _assert_same(load_stack_dir_c2(src), jax_load_c2(src), f"eager {variant}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_lazy_c2_loader_matches_the_jax_package(golden_root, variant):
    src = str(golden_root / variant)
    mine, theirs = open_stack_dir_c2_lazy(src), jax_open_lazy(src)
    _assert_same(mine, theirs, f"lazy {variant}")
    # edge windows decode the same bytes too
    for (r0, c0, h, w) in [(0, 0, 5, 7), (17, 25, 4, 8)]:
        for b in ("nir", "swir2"):
            a = mine.dn_bands[b][:, r0:r0 + h, c0:c0 + w]
            t = theirs.dn_bands[b][:, r0:r0 + h, c0:c0 + w]
            assert np.asarray(a).tobytes() == np.asarray(t).tobytes(), (variant, b, r0, c0)
