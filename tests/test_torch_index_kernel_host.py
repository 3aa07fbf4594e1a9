"""The index kernel's source, compiled for the host, against its plain
version on the CPU, bit for bit.

``tile_index_kernel`` (``csrc/segment_fused.cu``) is built with g++
through ``tests/_cuda_host_shim.h`` as the segmentation kernels are
(:func:`test_torch_kernel_host.build_host_library`) and launched through
the wrapper's own launch (``ops/segment_cuda.py:_index_launch``) on CPU
tensors, at a grid of a few blocks, so its grid-stride loop takes several
trips.  Its mask and every output row equal
:func:`~land_trendr_tpu_torch.ops.indices.torch_tile_indices` exactly:
every index alone and as an ensemble or FTV list, int16 and uint16 DNs
and QA (their extremes, QA words with high bits set, rejected bits past
the word's 16, which only a sign-widened int16 word has), a shipped band no
index reads and one outside ``BANDS``, both scale conventions (with
Collection-1's, DNs of 0 make an exact zero denominator), and the three
ways through the kernel: eight elements a thread with a ragged tail (of
four, or of one for a single output), one element a thread where a
plane's size leaves the second output off 16-byte alignment, and one
where the bands themselves start off it.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.ops import segment_cuda as sc
from test_torch_kernel_host import host_lib  # noqa: F401  (the library built for the host)

torch.set_num_threads(1)

ALL = idx.BANDS
#: (series indices, FTV indices, shipped bands)
SETS = {
    "nbr": (("nbr",), (), ("red", "nir", "swir2")),          # red: shipped, not read
    "ndvi": (("ndvi",), (), ("red", "nir", "swir1")),
    "ndmi": (("ndmi",), (), ("nir", "swir1", "swir2")),
    "tcb": (("tcb",), (), ALL),
    "tcg": (("tcg",), (), ALL),
    "tcw": (("tcw",), (), ALL),
    "ensemble": (("nbr", "ndvi", "ndmi", "tcb", "tcg", "tcw"), (), ALL),
    "ftv": (("nbr",), ("ndvi", "tcw"), ALL),
    "both": (("tcw", "ndmi", "nbr"), ("tcb", "ndvi", "tcg"), (*ALL, "thermal")),
}
#: (DN dtype, QA dtype, scale, offset, QA bits rejected): a bit past the
#: 16-bit word reads set only where an int16 word is negative (widened
#: with its sign, as the plain version widens it)
TYPES = {
    "i16-u16-c2": (np.int16, np.uint16, 2.75e-5, -0.2, idx.DEFAULT_QA_REJECT),
    "u16-u16-c1": (np.uint16, np.uint16, 1e-4, 0.0, idx.DEFAULT_QA_REJECT | 1 << 20),
    "i16-i16-c1": (np.int16, np.int16, 1e-4, 0.0, idx.DEFAULT_QA_REJECT | 1 << 20),
    "u16-i16-c2": (np.uint16, np.int16, 2.75e-5, -0.2, idx.DEFAULT_QA_REJECT | 1 << 15),
}
#: (PX, NY, bands off alignment, the kernel's expected vec; None: eight
#: elements a thread only where one output leaves no second row block)
LAYOUTS = {
    "tail": (1037, 36, False, 1),       # 37,332 elements: 4,666 groups of 8 and a tail of 4
    "ragged": (1037, 37, False, None),  # 38,369 elements: a second row block starts off 16 B
    "offset": (64, 40, True, 0),        # the bands one element past a 16-byte boundary
}
#: QA words: clear, a rejected bit, an unrejected bit, high bits, all bits
QA_WORDS = np.array([0, 0, 0, 1 << 3, 1 << 6, 1 << 15, 0xFF00, 0xFFFF, 1 << 1], np.uint16)


def _dn(rng, dtype, shape, scale, offset):
    """DNs mostly inside the convention's reflectance range [0, 1], with
    the type's extremes, zeros (Collection-2's reflectance of -0.2) and
    whole rows of zeros (an exact zero denominator under Collection-1
    scaling)."""
    info = np.iinfo(dtype)
    lo = max(info.min, int(np.ceil(-offset / scale)))
    hi = min(info.max, int((1.0 - offset) / scale))
    a = rng.integers(lo, hi, shape, endpoint=True)
    edge = rng.choice([info.min, 0, info.max, 1], size=shape)
    a = np.where(rng.uniform(size=shape) < 0.02, edge, a).astype(dtype)
    a[:5] = 0
    return a


def _tensor(a: np.ndarray, offset: bool) -> torch.Tensor:
    """``a`` as a tensor, starting one element past a 16-byte boundary
    where ``offset``."""
    t = torch.from_numpy(a.view(np.int16)).view(torch.uint16 if a.dtype == np.uint16
                                                else torch.int16)
    if not offset:
        return t.clone()
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("types", sorted(TYPES))
@pytest.mark.parametrize("case", list(SETS))
def test_index_kernel_on_the_host_matches_plain(host_lib, monkeypatch, case, types,  # noqa: F811
                                                layout):
    series_idx, ftv_idx, shipped = SETS[case]
    dn_t, qa_t, scale, offset, reject = TYPES[types]
    px, ny, off, want_vec = LAYOUTS[layout]
    if want_vec is None:
        want_vec = int(len(series_idx) + len(ftv_idx) == 1)
    rng = np.random.default_rng(zlib.crc32(f"{case} {types} {layout}".encode()))
    dn = {b: _tensor(_dn(rng, dn_t, (px, ny), scale, offset), off) for b in shipped}
    qa = _tensor(rng.choice(QA_WORDS, size=(px, ny)).astype(qa_t), off)
    seen = []
    real = host_lib.lt_tile_indices

    def spy(*a):
        seen.append(a[14])  # vec
        return real(*a)

    monkeypatch.setattr(host_lib, "lt_tile_indices", spy)
    known = {b: dn[b] for b in idx.BANDS if b in dn}
    before = sc.INDEX_LAUNCHES
    series, mask, ftv = sc._index_launch(
        known, qa, len(series_idx), sc._index_outputs((*series_idx, *ftv_idx), known),
        scale, offset, reject, 3)
    assert sc.INDEX_LAUNCHES - before == 1 and seen == [want_vec]
    ref_series, ref_mask, ref_ftv = idx.torch_tile_indices(
        dn, qa, series_idx, ftv_idx, scale, offset, reject)
    assert series.shape == (len(series_idx) * px, ny) and series.dtype == torch.float32
    assert torch.equal(mask, ref_mask)
    for k, name in enumerate(series_idx):
        rows = slice(k * px, (k + 1) * px)
        assert torch.equal(series[rows].view(torch.int32), ref_series[rows].view(torch.int32)), name
    assert len(ftv) == len(ref_ftv) == len(ftv_idx)
    for name, a, b in zip(ftv_idx, ftv, ref_ftv):
        assert a.shape == (px, ny) and torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    # the data reach every branch: valid and masked elements, drawn index
    # values, and under Collection-1 scaling exact zero denominators
    assert 0.2 < float(mask.float().mean()) < 0.9
    if reject >> 16:  # words the high bit rejects: negative int16 ones only
        assert bool(mask.any()) and bool(mask[qa.view(torch.int16) < 0].any()) == (
            qa.dtype == torch.uint16)
    assert int(series[:px].unique().numel()) > px
    if scale == 1e-4 and series_idx[0] in ("nbr", "ndvi", "ndmi"):
        assert bool((series[:5] == 0).all())
