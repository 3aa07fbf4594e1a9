"""Minimal self-contained GeoTIFF codec (NumPy + zlib; no GDAL).

The reference's raster layer reads Landsat GeoTIFF stacks and writes segment
rasters through GDAL's Python bindings (SURVEY.md §2 layer L1, provenance
``[B]`` behaviour / ``[K]`` library).  GDAL is not available in this
environment (SURVEY.md §7 hard-part 5), so the framework vendors the small
slice of TIFF 6.0 + GeoTIFF it actually needs:

* classic TIFF **and BigTIFF**, little- or big-endian, **read**: stripped
  or tiled layout, uncompressed / Deflate (zlib) / raw-deflate / LZW,
  horizontal-differencing predictor, chunky or planar multi-band,
  u/int 8/16/32, float32/64;
* **write**: tiled (default) or stripped, Deflate, LZW, or uncompressed,
  optional horizontal predictor, any of the dtypes above, chunky band
  layout;
  classic by default, switching to BigTIFF automatically when the encoded
  file would overflow 4 GB addressing (CONUS ARD mosaic products,
  SURVEY.md §7 hard-part 5);
* GeoTIFF georeferencing carried as an opaque-but-typed :class:`GeoMeta`
  (pixel scale + tiepoint + the raw GeoKey directory blocks), round-tripped
  losslessly so outputs inherit the input grid.

This is host-side I/O: arrays land in NumPy and are fed to the device pipeline
by the runtime driver.
"""

from __future__ import annotations

import dataclasses
import mmap
import struct
import time
import zlib
from typing import BinaryIO, Mapping

import numpy as np

from land_trendr_tpu_torch.io import blockcache, native

__all__ = ["GeoMeta", "TiffInfo", "read_geotiff", "write_geotiff"]

# -- TIFF tag ids -----------------------------------------------------------
_T_NEW_SUBFILE_TYPE = 254
_T_IMAGE_WIDTH = 256
_T_IMAGE_LENGTH = 257
_T_BITS_PER_SAMPLE = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_STRIP_OFFSETS = 273
_T_SAMPLES_PER_PIXEL = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_BYTE_COUNTS = 279
_T_PLANAR_CONFIG = 284
_T_PREDICTOR = 317
_T_TILE_WIDTH = 322
_T_TILE_LENGTH = 323
_T_TILE_OFFSETS = 324
_T_TILE_BYTE_COUNTS = 325
_T_SAMPLE_FORMAT = 339
_T_MODEL_PIXEL_SCALE = 33550
_T_MODEL_TIEPOINT = 33922
_T_GEO_KEY_DIRECTORY = 34735
_T_GEO_DOUBLE_PARAMS = 34736
_T_GEO_ASCII_PARAMS = 34737
_T_GDAL_NODATA = 42113

_COMP_NONE = 1
_COMP_LZW = 5
_COMP_DEFLATE_ADOBE = 8
_COMP_DEFLATE_OLD = 32946

# TIFF field types → (struct char, byte size)
_FIELD_TYPES = {
    1: ("B", 1),   # BYTE
    2: ("s", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    5: ("II", 8),  # RATIONAL (2×LONG)
    6: ("b", 1),   # SBYTE
    8: ("h", 2),   # SSHORT
    9: ("i", 4),   # SLONG
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
    13: ("I", 4),  # IFD
    16: ("Q", 8),  # LONG8 (BigTIFF)
    17: ("q", 8),  # SLONG8 (BigTIFF)
}

# (sample_format, bits) → numpy dtype char
_DTYPES = {
    (1, 8): "u1", (1, 16): "u2", (1, 32): "u4",
    (2, 8): "i1", (2, 16): "i2", (2, 32): "i4",
    (3, 32): "f4", (3, 64): "f8",
}
_DTYPE_TO_FORMAT = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass(frozen=True)
class GeoMeta:
    """Georeferencing sidecar, round-tripped verbatim between files.

    ``pixel_scale`` is the GeoTIFF ModelPixelScale ``(sx, sy, sz)``;
    ``tiepoint`` the first ModelTiepoint ``(i, j, k, x, y, z)``; the three
    ``geo_*`` fields carry the GeoKey directory blocks untouched (the
    framework never interprets projection parameters — it only preserves
    them, which is all the segment-raster writer needs).
    """

    pixel_scale: tuple[float, ...] | None = None
    tiepoint: tuple[float, ...] | None = None
    geo_key_directory: tuple[int, ...] | None = None
    geo_double_params: tuple[float, ...] | None = None
    geo_ascii_params: str | None = None
    nodata: float | None = None

    def geotransform(self) -> tuple[float, float, float, float, float, float] | None:
        """GDAL-style (x0, dx, 0, y0, 0, -dy) affine, when defined."""
        if not self.pixel_scale or not self.tiepoint:
            return None
        sx, sy = self.pixel_scale[0], self.pixel_scale[1]
        i, j, _k, x, y, _z = self.tiepoint[:6]
        return (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)


@dataclasses.dataclass(frozen=True)
class TiffInfo:
    """Shape/layout facts about a decoded file (useful for tests/tools)."""

    width: int
    height: int
    bands: int
    dtype: np.dtype
    tiled: bool
    compression: int
    big: bool = False
    #: block geometry (TileLength/TileWidth, or RowsPerStrip/width) — the
    #: natural window-read granularity; set by read_geotiff_info
    block_rows: int | None = None
    block_cols: int | None = None
    #: reduced-resolution (overview/mask) pages in the IFD chain; set by
    #: read_geotiff_info so rewriting tools can reproduce the pyramid
    overview_pages: int = 0

    def compression_name(self) -> str:
        return {1: "none", 5: "lzw", 8: "deflate", 32946: "deflate"}.get(
            self.compression, "deflate"
        )


def _read_ifd(
    f: BinaryIO, bo: str, off: int, big: bool = False
) -> tuple[dict[int, tuple], int]:
    """Parse one IFD; ``big`` selects BigTIFF layout (u64 entry count,
    20-byte entries with 8-byte inline values, u64 value offsets).

    Returns ``(tags, next_ifd_offset)`` — 0 when this is the last IFD, so
    multi-page files (e.g. pre-stacked per-year series written one band
    per page) can be walked instead of silently truncated to page 1.
    """
    f.seek(0, 2)
    file_size = f.tell()
    if not (0 <= off < file_size):
        raise ValueError(
            f"corrupt TIFF: IFD offset {off} outside file (size {file_size})"
        )
    f.seek(off)

    def read_exact(n: int) -> bytes:
        buf = f.read(n)
        if len(buf) != n:
            raise ValueError(
                f"corrupt TIFF: truncated at offset {f.tell()} "
                f"(wanted {n} bytes, got {len(buf)})"
            )
        return buf

    if big:
        (n,) = struct.unpack(bo + "Q", read_exact(8))
        # the on-disk u64 count is untrusted: a truncated/corrupt file must
        # fail parsing, not attempt an exabyte read (classic TIFF's u16
        # field caps itself; mirror that bound here)
        if n > 0xFFFF:
            raise ValueError(f"corrupt BigTIFF IFD: implausible entry count {n}")
        esz, inline, ptr_fmt = 20, 8, "Q"
        head_fmt = bo + "HHQ"
    else:
        (n,) = struct.unpack(bo + "H", read_exact(2))
        esz, inline, ptr_fmt = 12, 4, "I"
        head_fmt = bo + "HHI"
    entries: dict[int, tuple] = {}
    raw = read_exact(n * esz)
    for k in range(n):
        tag, ftype, count = struct.unpack(head_fmt, raw[k * esz : k * esz + esz - inline])
        if ftype not in _FIELD_TYPES:
            continue
        ch, sz = _FIELD_TYPES[ftype]  # sz already totals both LONGs for RATIONAL
        total = sz * count
        # the on-disk count is untrusted: an out-of-line payload can never be
        # larger than the file itself, so a corrupt huge count must fail
        # parsing here, not drive f.read() into a multi-TB allocation
        if total > file_size:
            raise ValueError(
                f"corrupt TIFF IFD: tag {tag} payload {total} bytes exceeds "
                f"file size {file_size}"
            )
        val_off = k * esz + (esz - inline)
        if total <= inline:
            payload = raw[val_off : val_off + total]
        else:
            (ptr,) = struct.unpack(bo + ptr_fmt, raw[val_off : val_off + inline])
            if ptr + total > file_size:
                raise ValueError(
                    f"corrupt TIFF: tag {tag} payload at {ptr} runs past "
                    f"file size {file_size}"
                )
            here = f.tell()
            f.seek(ptr)
            payload = read_exact(total)
            f.seek(here)
        if ftype == 2:
            entries[tag] = (payload.rstrip(b"\0").decode("ascii", "replace"),)
        elif ftype == 5:
            vals = struct.unpack(bo + "I" * (2 * count), payload)
            entries[tag] = tuple(
                vals[i] / vals[i + 1] if vals[i + 1] else 0.0
                for i in range(0, 2 * count, 2)
            )
        else:
            entries[tag] = struct.unpack(bo + ch * count, payload)
    f.seek(off + (8 if big else 2) + n * esz)
    ptr_sz = 8 if big else 4
    raw_next = f.read(ptr_sz)
    next_off = (
        struct.unpack(bo + ("Q" if big else "I"), raw_next)[0]
        if len(raw_next) == ptr_sz
        else 0
    )
    # untrusted trailer: a garbage pointer must fail the codec's ValueError
    # taxonomy here, not as a struct.error/KeyError while parsing junk
    if next_off and not (8 <= next_off < file_size):
        raise ValueError(
            f"corrupt TIFF: next-IFD offset {next_off} outside file "
            f"(size {file_size})"
        )
    return entries, next_off


def _lzw_decode(data: bytes) -> bytes:
    """TIFF 6.0 LZW (compression 5): MSB-first bit packing, ClearCode=256,
    EOI=257, 9→12-bit codes with the spec's "early change" width bumps.

    Pure-Python behavioural reference for ``lt_native.cc::lzw_decode`` (the
    threaded fast path); real Landsat C2 distribution files commonly ship
    LZW-compressed, which GDAL handled for the reference for free
    (SURVEY.md §2 L1).
    """
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list[bytes] = []
    code_bits = 9
    next_code = 258
    prev: bytes | None = None
    bitpos = 0
    total_bits = len(data) * 8

    def read_code() -> int:
        nonlocal bitpos
        if bitpos + code_bits > total_bits:
            return EOI
        byte0 = bitpos >> 3
        chunk = int.from_bytes(data[byte0 : byte0 + 4].ljust(4, b"\0"), "big")
        val = (chunk >> (32 - code_bits - (bitpos & 7))) & ((1 << code_bits) - 1)
        bitpos += code_bits
        return val

    while True:
        code = read_code()
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            code_bits = 9
            next_code = 258
            code = read_code()
            while code == CLEAR:  # libtiff tolerates consecutive Clear codes
                code = read_code()
            if code == EOI:
                break
            if code >= 256:
                raise ValueError("corrupt LZW: literal must follow clear")
            entry = table[code]
            out += entry
            prev = entry
            continue
        if prev is None or next_code >= 4096:
            raise ValueError("corrupt LZW: missing clear code")
        if code < next_code:
            entry = table[code]
        elif code == next_code:
            entry = prev + prev[:1]  # KwKwK
        else:
            raise ValueError("corrupt LZW: code beyond table")
        out += entry
        table.append(prev + entry[:1])
        next_code += 1
        if next_code == (1 << code_bits) - 1 and code_bits < 12:
            code_bits += 1
        prev = entry
    return bytes(out)


def _lzw_encode(data: bytes) -> bytes:
    """TIFF 6.0 LZW encoder: MSB-first packing, ClearCode first, 9→12-bit
    codes with the spec's "early change" width bumps, Clear + reset when
    the table fills (code 4094, libtiff's limit).

    Inverse of :func:`_lzw_decode`; outputs are validated round-trip
    against both our decoder and Pillow's (tests/test_geotiff.py), which
    pins the width-bump timing empirically.  The dictionary is
    ``(prefix_code << 8 | byte) → code`` so each input byte is one dict
    probe — O(n) overall.
    """
    CLEAR, EOI = 256, 257
    out = bytearray()
    buf = 0
    nbits = 0
    code_bits = 9

    def emit(code: int) -> None:
        nonlocal buf, nbits
        buf = (buf << code_bits) | code
        nbits += code_bits
        while nbits >= 8:
            nbits -= 8
            out.append((buf >> nbits) & 0xFF)
        buf &= (1 << nbits) - 1  # drop drained bits: keep buf a small int

    table: dict[int, int] = {}
    next_code = 258
    emit(CLEAR)
    prev = -1
    for b in data:
        if prev < 0:
            prev = b
            continue
        key = (prev << 8) | b
        code = table.get(key)
        if code is not None:
            prev = code
            continue
        emit(prev)
        table[key] = next_code
        next_code += 1
        prev = b
        # the decoder's table lags one add behind the encoder's, and its
        # "early change" bump fires at (1<<bits)-1 — so the encoder bumps
        # at (1<<bits): both sides widen before the same emitted code
        if next_code == (1 << code_bits) and code_bits < 12:
            code_bits += 1
        elif next_code >= 4094:  # table full: clear and restart
            emit(CLEAR)
            table.clear()
            next_code = 258
            code_bits = 9
    if prev >= 0:
        emit(prev)
        # the decoder's add for this final code catches its count up to
        # ours and can trigger its early-change bump — EOI must be written
        # at the width the decoder will read it with
        if next_code == (1 << code_bits) - 1 and code_bits < 12:
            code_bits += 1
    emit(EOI)
    if nbits:
        out.append((buf << (8 - nbits)) & 0xFF)
    return bytes(out)


def _decompress(buf: bytes, compression: int) -> bytes:
    if compression == _COMP_NONE:
        return buf
    if compression in (_COMP_DEFLATE_ADOBE, _COMP_DEFLATE_OLD):
        try:
            return zlib.decompress(buf)
        except zlib.error:
            try:
                return zlib.decompress(buf, -15)  # raw deflate stream
            except zlib.error as e:
                # keep the corrupt-file ValueError taxonomy — zlib.error
                # must not escape to callers
                raise ValueError(f"corrupt deflate block: {e}") from e
    if compression == _COMP_LZW:
        return _lzw_decode(buf)
    raise ValueError(f"unsupported TIFF compression {compression}")


def _tag1(path: str, tags: dict[int, tuple], tag: int, default=None):
    """First value of a tag; missing → ``default`` (or ValueError when
    required), present-but-empty (count=0) → ValueError."""
    vals = tags.get(tag)
    if vals is None:
        if default is None:
            raise ValueError(f"{path}: corrupt TIFF IFD (missing tag {tag})")
        return default
    if not vals:
        raise ValueError(f"{path}: corrupt TIFF IFD (empty tag {tag})")
    return vals[0]


def _unpredict(block: np.ndarray, predictor: int) -> np.ndarray:
    """Undo horizontal differencing in place along the row axis."""
    if predictor == 2:
        np.cumsum(block, axis=-2, dtype=block.dtype, out=block)
    return block


def _walk_full_pages(
    f: BinaryIO, path: str
) -> tuple[str, bool, list[dict[int, tuple]]]:
    """Parse the header and walk the IFD chain (tags only — no block data);
    returns ``(byte_order, big, full_resolution_page_tags)``.  Overview and
    mask pages (NewSubfileType reduced/mask bits) are skipped, as COGs and
    gdaladdo expect."""
    hdr = f.read(16)
    if len(hdr) < 8:
        raise ValueError(f"{path}: not a TIFF (truncated header)")
    if hdr[:2] == b"II":
        bo = "<"
    elif hdr[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF (bad byte-order mark)")
    (magic,) = struct.unpack(bo + "H", hdr[2:4])
    if magic == 42:
        big = False
        (ifd_off,) = struct.unpack(bo + "I", hdr[4:8])
    elif magic == 43:
        big = True
        if len(hdr) < 16:
            raise ValueError(f"{path}: not a BigTIFF (truncated header)")
        offsize, pad = struct.unpack(bo + "HH", hdr[4:8])
        if offsize != 8 or pad != 0:
            raise ValueError(
                f"{path}: BigTIFF with offset size {offsize} (only 8 supported)"
            )
        (ifd_off,) = struct.unpack(bo + "Q", hdr[8:16])
    else:
        raise ValueError(f"{path}: not a TIFF (magic={magic})")

    page_tags: list[dict[int, tuple]] = []
    seen: set[int] = set()
    n_reduced = 0
    off = ifd_off
    while off:
        if off in seen:
            raise ValueError(f"{path}: cyclic IFD chain at offset {off}")
        seen.add(off)
        tags, off = _read_ifd(f, bo, off, big)
        subtype = _tag1(path, tags, _T_NEW_SUBFILE_TYPE, 0)
        if subtype & 0x5:  # reduced-resolution overview (1) / mask (4)
            n_reduced += 1
            continue
        page_tags.append(tags)
    if not page_tags:
        raise ValueError(f"{path}: no full-resolution pages in IFD chain")
    return bo, big, page_tags, n_reduced


def _pages_geometry(
    path: str, page_tags: list[dict[int, tuple]]
) -> tuple[int, int, tuple, int]:
    """Validate the full-resolution pages agree in size/format (stacking
    mismatched pages would silently cast/truncate) and that each carries a
    complete block layout; returns ``(width, height, dtype_key,
    total_samples_per_pixel)``."""

    def geometry(tags):
        w = _tag1(path, tags, _T_IMAGE_WIDTH)
        h = _tag1(path, tags, _T_IMAGE_LENGTH)
        if _T_TILE_OFFSETS in tags:
            # tiled layout needs its companion tags too
            for req in (_T_TILE_WIDTH, _T_TILE_LENGTH, _T_TILE_BYTE_COUNTS):
                _tag1(path, tags, req)
        elif _T_STRIP_OFFSETS in tags:
            _tag1(path, tags, _T_STRIP_BYTE_COUNTS)
        else:
            raise ValueError(
                f"{path}: corrupt TIFF IFD (no strip or tile offsets)"
            )
        spp = _tag1(path, tags, _T_SAMPLES_PER_PIXEL, 1)
        if spp < 1:
            raise ValueError(f"{path}: corrupt TIFF IFD (SamplesPerPixel={spp})")
        bits = _tag1(path, tags, _T_BITS_PER_SAMPLE, 1)
        fmt = _tag1(path, tags, _T_SAMPLE_FORMAT, 1)
        return w, h, spp, (fmt, bits)

    w0, h0, _, key0 = geometry(page_tags[0])
    total_spp = 0
    for k, tags in enumerate(page_tags):
        w, h, spp, key = geometry(tags)
        if (w, h, key) != (w0, h0, key0):
            raise ValueError(
                f"{path}: page {k} is {h}×{w}/format{key}, page 0 is "
                f"{h0}×{w0}/format{key0} — refusing to stack "
                "mismatched pages"
            )
        total_spp += spp
    if key0 not in _DTYPES:
        raise ValueError(f"{path}: unsupported sample format/bits {key0}")
    return w0, h0, key0, total_spp


def read_geotiff(path: str) -> tuple[np.ndarray, GeoMeta, TiffInfo]:
    """Decode a GeoTIFF into ``(array, geo, info)``.

    ``array`` is ``(height, width)`` for single-band files and
    ``(bands, height, width)`` otherwise, in the file's native dtype.

    Multi-page files (an IFD chain) are read page by page into ONE
    allocation and stacked along the band axis — the layout some
    pre-stacked per-year products use (one band per page).  Overview and
    mask pages (NewSubfileType reduced-resolution/mask bits — what COGs
    and gdaladdo produce) are skipped, so Cloud-Optimized GeoTIFFs read
    as their full-resolution image.  Full-resolution pages must agree in
    size and dtype; a mismatch raises instead of silently truncating to
    page 1.
    """
    with open(path, "rb") as f:
        bo, big, page_tags, _ = _walk_full_pages(f, path)
        w0, h0, key0, total_spp = _pages_geometry(path, page_tags)
        # untrusted dimensions: deflate/LZW top out near ~1032:1, so a
        # decoded size beyond file_size × 64Ki (or an absolute 1 TiB) can
        # only come from corrupt width/height tags — fail before np.zeros
        # attempts a garbage-driven multi-TB allocation
        f.seek(0, 2)
        fsize = f.tell()
        decoded = total_spp * h0 * w0 * np.dtype(_DTYPES[key0]).itemsize
        if decoded > min((fsize + 4096) * 65536, 2**40):
            raise ValueError(
                f"{path}: corrupt TIFF dimensions {total_spp}×{h0}×{w0} "
                f"({decoded} decoded bytes from a {fsize}-byte file)"
            )
        out = np.zeros((total_spp, h0, w0), dtype=np.dtype(_DTYPES[key0]))

        geo: GeoMeta | None = None
        info: TiffInfo | None = None
        band0 = 0
        for tags in page_tags:
            spp = _tag1(path, tags, _T_SAMPLES_PER_PIXEL, 1)
            g, inf = _decode_ifd(f, path, bo, big, tags, out[band0 : band0 + spp])
            band0 += spp
            if geo is None:
                geo, info = g, inf
        assert info is not None
        info = dataclasses.replace(info, bands=total_spp)
        arr = out[0] if total_spp == 1 else out
        return arr, geo, info


def read_geotiff_info(path: str) -> tuple[GeoMeta, TiffInfo]:
    """Header-only inspection (the ``gdalinfo`` seam): geo + shape/layout
    facts from the IFD chain alone.  No block data is read or decoded, so
    this is O(tags) even on a multi-GB mosaic — the cheap first step of
    any windowed-read workflow."""
    with open(path, "rb") as f:
        bo, big, page_tags, n_reduced = _walk_full_pages(f, path)
        width, height, key, total_spp = _pages_geometry(path, page_tags)
        tags = page_tags[0]
        tiled = _T_TILE_OFFSETS in tags
        if tiled:
            block_rows = _tag1(path, tags, _T_TILE_LENGTH)
            block_cols = _tag1(path, tags, _T_TILE_WIDTH)
        else:
            block_rows = min(
                _tag1(path, tags, _T_ROWS_PER_STRIP, height), height
            )
            block_cols = width
        info = TiffInfo(
            width=width,
            height=height,
            bands=total_spp,
            dtype=np.dtype(_DTYPES[key]),
            tiled=tiled,
            compression=_tag1(path, tags, _T_COMPRESSION, _COMP_NONE),
            big=big,
            block_rows=block_rows,
            block_cols=block_cols,
            overview_pages=n_reduced,
        )
        return _page_geo(tags), info


def read_geotiff_window(
    path: str, y0: int, x0: int, h: int, w: int
) -> np.ndarray:
    """Random-access window read: decode ONLY the blocks intersecting
    ``(y0, x0, h, w)`` of every full-resolution page — I/O and decode cost
    scale with the window, not the raster (GDAL's ReadAsArray-with-window
    seam; the piece that lets change maps and inspection tooling run over
    CONUS-scale mosaics in bounded memory).

    Returns ``(h, w)`` for single-band files, ``(bands, h, w)`` otherwise
    (multi-page band stacking as in :func:`read_geotiff`).  Georeferencing
    is the FULL raster's — offset by ``(y0, x0)`` pixels when a window
    transform is needed (``GeoMeta.geotransform``)."""
    # fault seam "feed.decode" (runtime.faults): the windowed feed path's
    # decode errors — a transient NFS read, a torn block — surface here
    blockcache.fault_check("feed.decode")
    with open(path, "rb") as f:
        bo, big, page_tags, _ = _walk_full_pages(f, path)
        width, height, key, total_spp = _pages_geometry(path, page_tags)
        # bounds BEFORE allocation: a typo'd window must fail with this
        # error, not a garbage-driven MemoryError from np.zeros
        if y0 < 0 or x0 < 0 or h < 1 or w < 1 or y0 + h > height or x0 + w > width:
            raise ValueError(
                f"{path}: window {(y0, x0, h, w)} outside raster "
                f"{(height, width)}"
            )
        spps = [_tag1(path, t, _T_SAMPLES_PER_PIXEL, 1) for t in page_tags]
        out = np.zeros((total_spp, h, w), dtype=np.dtype(_DTYPES[key]))
        # decoded-block cache identity (None = caching off): window reads
        # are the revisit-heavy path — tile edges, LazyBandCube re-reads,
        # resume passes — so only they populate/consult the cache
        fkey = blockcache.file_key(f, path) if blockcache.cache_enabled() else None
        band0 = 0
        for page, (tags, spp) in enumerate(zip(page_tags, spps)):
            _decode_ifd(
                f, path, bo, big, tags, out[band0 : band0 + spp],
                window=(y0, x0, h, w), page=page, fkey=fkey,
            )
            band0 += spp
    return out[0] if total_spp == 1 else out


def _decode_ifd(
    f: BinaryIO,
    path: str,
    bo: str,
    big: bool,
    tags: dict[int, tuple],
    out: np.ndarray,
    window: tuple[int, int, int, int] | None = None,
    page: int = 0,
    fkey: tuple | None = None,
) -> tuple[GeoMeta, TiffInfo]:
    """Decode one IFD's raster into the preallocated ``(spp, H, W)`` view
    ``out`` (native byte order); returns the page's geo/info.

    ``window=(y0, x0, h, w)`` decodes ONLY the blocks intersecting that
    region into an ``(spp, h, w)`` view — the random-access read path
    (GDAL ReadAsArray-with-window equivalent): I/O and decode cost scale
    with the window, not the raster.

    ``fkey`` (a :func:`blockcache.file_key` identity) + ``page`` enable
    the decoded-block cache for this page's blocks; ``None`` decodes
    uncached.  Cached and uncached reads are byte-identical."""
    width = _tag1(path, tags, _T_IMAGE_WIDTH)
    height = _tag1(path, tags, _T_IMAGE_LENGTH)
    spp = _tag1(path, tags, _T_SAMPLES_PER_PIXEL, 1)
    bits = tags.get(_T_BITS_PER_SAMPLE, (1,) * spp)
    if len(set(bits)) != 1:
        raise ValueError(f"{path}: mixed BitsPerSample {bits}")
    fmt = _tag1(path, tags, _T_SAMPLE_FORMAT, 1)
    key = (fmt, bits[0])
    if key not in _DTYPES:
        raise ValueError(f"{path}: unsupported sample format/bits {key}")
    dtype = np.dtype(bo + _DTYPES[key])
    compression = _tag1(path, tags, _T_COMPRESSION, _COMP_NONE)
    predictor = _tag1(path, tags, _T_PREDICTOR, 1)
    planar = _tag1(path, tags, _T_PLANAR_CONFIG, 1)
    tiled = _T_TILE_OFFSETS in tags

    planes = spp if planar == 2 else 1
    chunk_spp = 1 if planar == 2 else spp
    if window is None:
        window = (0, 0, height, width)
    wy, wx, wh, ww = window
    if wy < 0 or wx < 0 or wh < 1 or ww < 1 or wy + wh > height or wx + ww > width:
        raise ValueError(
            f"{path}: window {window} outside raster {(height, width)}"
        )
    if out.shape != (spp, wh, ww):
        raise ValueError(
            f"{path}: output view {out.shape} != window shape {(spp, wh, ww)}"
        )
    if tiled:
        tw = _tag1(path, tags, _T_TILE_WIDTH)
        th = _tag1(path, tags, _T_TILE_LENGTH)
        if tw < 1 or th < 1:
            raise ValueError(f"{path}: corrupt tile size {th}×{tw}")
        offsets = tags[_T_TILE_OFFSETS]
        counts = tags[_T_TILE_BYTE_COUNTS]
        blk_rows, blk_w = th, tw
        tiles_x = (width + tw - 1) // tw
        tiles_y = (height + th - 1) // th
        n_blocks = planes * tiles_x * tiles_y
        # blocks intersecting the window, with their grid coordinates —
        # the unit the decode below pays for
        coords: list[tuple] = [
            (p, ty, tx)
            for p in range(planes)
            for ty in range(wy // th, (wy + wh - 1) // th + 1)
            for tx in range(wx // tw, (wx + ww - 1) // tw + 1)
        ]
        sel = [p * tiles_y * tiles_x + ty * tiles_x + tx for p, ty, tx in coords]
    else:
        rps = _tag1(path, tags, _T_ROWS_PER_STRIP, height)
        if rps < 1:
            raise ValueError(f"{path}: corrupt RowsPerStrip {rps}")
        offsets = tags[_T_STRIP_OFFSETS]
        counts = tags[_T_STRIP_BYTE_COUNTS]
        # clamp: RowsPerStrip may legally exceed height (e.g. 2^32-1 =
        # "everything in one strip"); the buffer needs only real rows
        blk_rows, blk_w = min(rps, height), width
        strips = (height + rps - 1) // rps
        n_blocks = planes * strips
        coords = [
            (p, s)
            for p in range(planes)
            for s in range(wy // rps, (wy + wh - 1) // rps + 1)
        ]
        sel = [p * strips + s for p, s in coords]

    # untrusted block tables AND block geometry: the layout dictates how
    # many blocks the decode loops index, every selected block must lie
    # inside the file, and the block SLOT allocation (len(sel) × blk_rows
    # × blk_w — which corrupt TileWidth/TileLength tags can inflate far
    # beyond the image size) must pass the same plausibility budget as the
    # page — otherwise the native fast path np.zeros's from garbage
    # dimensions and dies with MemoryError instead of a clean parse error
    f.seek(0, 2)
    fsize = f.tell()
    if len(offsets) < n_blocks or len(counts) < n_blocks:
        raise ValueError(
            f"{path}: corrupt block table ({len(offsets)} offsets / "
            f"{len(counts)} counts for {n_blocks} blocks)"
        )
    sel_offsets = [offsets[i] for i in sel]
    sel_counts = [counts[i] for i in sel]
    slot_bytes = (
        len(sel) * blk_rows * blk_w * chunk_spp * dtype.itemsize
    )
    if slot_bytes > min((fsize + 4096) * 65536, 2**40):
        raise ValueError(
            f"{path}: corrupt block geometry ({len(sel)} blocks × "
            f"{blk_rows}×{blk_w}×{chunk_spp} = {slot_bytes} decoded bytes "
            f"from a {fsize}-byte file)"
        )
    for o, c in zip(sel_offsets, sel_counts):
        if o < 0 or c < 0 or o + c > fsize:
            raise ValueError(
                f"{path}: corrupt block table entry ({o}+{c} vs file "
                f"size {fsize})"
            )

    # Block decode, in three layers (land_trendr_tpu_torch.io.blockcache):
    # (1) the decoded-block cache resolves revisited blocks instantly;
    # (2) cache misses run the native fast path when eligible — fused
    # inflate+unpredict across the missing blocks, threaded in C++
    # (native/lt_native.cc) under the shared decode_workers knob; (3) any
    # remainder (native absent, unsupported layout, or a NativeCodecError
    # fallback) decodes on the NumPy reference path, fanned over the
    # shared thread pool (zlib releases the GIL).  All three produce
    # byte-identical blocks — cache and pool are acceleration only.
    if tiled:
        rows_of = [blk_rows] * len(sel)  # file tiles are full-size
    else:
        # a legally-short last strip decodes only its real rows
        rows_of = [min(rps, height - s * rps) for _, s in coords]
    use_cache = fkey is not None and blockcache.cache_enabled()

    def _decode_one(pos: int, raw: bytes) -> np.ndarray:
        data = _decompress(raw, compression)
        b = np.frombuffer(
            data, dtype=dtype, count=rows_of[pos] * blk_w * chunk_spp
        )
        b = b.reshape(rows_of[pos], blk_w, chunk_spp).astype(
            dtype.newbyteorder("="), copy=True
        )
        return _unpredict(b, predictor)

    def _decode_at(pos: int) -> np.ndarray:
        """Serial reference path, one block straight from the file — the
        placement loop calls this lazily so a full-file read without the
        native lib holds ONE compressed + one decoded block beyond the
        output array, exactly as before the cache existed."""
        t0 = time.perf_counter()
        f.seek(sel_offsets[pos])
        b = _decode_one(pos, f.read(sel_counts[pos]))
        blockcache.note_decode_seconds(time.perf_counter() - t0)
        if use_cache:
            blockcache.cache_put((*fkey, page, sel[pos]), b)
        return b

    blocks: list[np.ndarray | None] = [None] * len(sel)
    if use_cache:
        native_dt = dtype.newbyteorder("=")
        for pos, bidx in enumerate(sel):
            b = blockcache.cache_get((*fkey, page, bidx))
            if b is not None:
                # fault seam "cache.corrupt" + the validation that makes a
                # poisoned entry survivable: a cached block that no longer
                # matches its slot's shape/dtype (bit rot, a corrupting
                # bug, an injected fault) is invalidated and re-decoded
                # from the file instead of failing the tile
                b = blockcache.fault_corrupt("cache.corrupt", b)
                if (
                    b.shape != (rows_of[pos], blk_w, chunk_spp)
                    or b.dtype != native_dt
                ):
                    blockcache.drop_corrupt((*fkey, page, bidx))
                    b = None
            blocks[pos] = b
    miss = [pos for pos, b in enumerate(blocks) if b is None]

    t_dec = time.perf_counter()
    if (
        miss
        and native.available()
        and bo == "<"
        # predictor 2 is integer differencing; float files tagged with
        # it (nonstandard) must keep NumPy's float-cumsum semantics
        and (predictor == 1 or (predictor == 2 and dtype.kind in "iu"))
    ):
        # mmap keeps peak host memory at the decoded array, not whole-file
        # bytes + decoded array, for scene-scale rasters
        try:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file / non-mmappable stream
            f.seek(0)
            buf = f.read()
        try:
            nat_blocks = native.decode_blocks(
                buf,
                np.asarray([sel_offsets[p] for p in miss], dtype=np.uint64),
                np.asarray([sel_counts[p] for p in miss], dtype=np.uint64),
                compression=compression,
                predictor=predictor,
                rows=blk_rows,
                width=blk_w,
                spp=chunk_spp,
                dtype=dtype.newbyteorder("="),
                block_rows=np.asarray(
                    [rows_of[p] for p in miss], dtype=np.uint64
                ),
            )
        except native.NativeCodecError:
            nat_blocks = None
        finally:
            if isinstance(buf, mmap.mmap):
                try:
                    buf.close()
                except BufferError:
                    # a propagating exception's traceback can still pin
                    # the frombuffer view; don't mask it — the mmap is
                    # freed with the object
                    pass
        if nat_blocks is not None:
            for j, pos in enumerate(miss):
                b = nat_blocks[j][: rows_of[pos]]
                if use_cache:
                    # a copy, not the slice: caching the view would pin
                    # the whole (n_miss, rows, w, spp) batch in memory
                    b = b.copy()
                    blockcache.cache_put((*fkey, page, sel[pos]), b)
                blocks[pos] = b
            miss = []

    if miss:
        pool = blockcache.decode_pool() if len(miss) > 1 else None
        if pool is not None:
            # NumPy parallel path: raw bytes read serially up front (one
            # shared file handle), decompress+unpredict fanned over the
            # shared pool — transient memory is the misses' compressed
            # bytes, which a window read bounds to the window
            raws = []
            for pos in miss:
                f.seek(sel_offsets[pos])
                raws.append(f.read(sel_counts[pos]))
            for pos, b in zip(miss, pool.map(_decode_one, miss, raws)):
                if use_cache:
                    blockcache.cache_put((*fkey, page, sel[pos]), b)
                blocks[pos] = b
        # else: remaining misses stay None and decode lazily, one at a
        # time, inside the placement loop (_decode_at) — the pre-cache
        # serial memory profile
    blockcache.note_decode_seconds(time.perf_counter() - t_dec)

    for pos, coord in enumerate(coords):
        block = blocks[pos]
        if block is None:
            block = _decode_at(pos)
        if tiled:
            p, ty, tx = coord
            by, bx = ty * th, tx * tw
            bh = min(th, height - by)
            bw = min(tw, width - bx)
        else:
            p, s = coord
            by, bx = s * rps, 0
            bh = min(rps, height - by)
            bw = width
        # block ∩ window, placed window-relative (full reads: the whole block)
        ys, xs = max(wy, by), max(wx, bx)
        ye, xe = min(wy + wh, by + bh), min(wx + ww, bx + bw)
        sub = block[ys - by : ye - by, xs - bx : xe - bx]
        if planar == 2:
            out[p, ys - wy : ye - wy, xs - wx : xe - wx] = sub[..., 0]
        else:
            out[:, ys - wy : ye - wy, xs - wx : xe - wx] = np.moveaxis(
                sub, -1, 0
            )

    return _page_geo(tags), TiffInfo(
        width=width,
        height=height,
        bands=spp,
        dtype=np.dtype(_DTYPES[key]),
        tiled=tiled,
        compression=compression,
        big=big,
    )


def _page_geo(tags: dict[int, tuple]) -> GeoMeta:
    nodata = None
    if _T_GDAL_NODATA in tags:
        try:
            nodata = float(tags[_T_GDAL_NODATA][0])
        except (TypeError, ValueError):
            nodata = None
    return GeoMeta(
        pixel_scale=tags.get(_T_MODEL_PIXEL_SCALE),
        tiepoint=tags.get(_T_MODEL_TIEPOINT),
        geo_key_directory=tags.get(_T_GEO_KEY_DIRECTORY),
        geo_double_params=tags.get(_T_GEO_DOUBLE_PARAMS),
        geo_ascii_params=tags.get(_T_GEO_ASCII_PARAMS, (None,))[0],
        nodata=nodata,
    )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class _ClassicOverflow(Exception):
    """Encoded file does not fit classic TIFF's u32 addressing."""


def _resolve_compress(compress: str | None) -> int:
    if compress == "deflate":
        return _COMP_DEFLATE_ADOBE
    if compress == "lzw":
        return _COMP_LZW
    if compress in (None, "none"):
        return _COMP_NONE
    raise ValueError(f"unsupported compression {compress!r}")


def _predict(block: np.ndarray) -> np.ndarray:
    """Apply horizontal differencing along the row axis (predictor 2)."""
    out = block.copy()
    out[..., 1:, :] = block[..., 1:, :] - block[..., :-1, :]
    return out


class _IfdBuilder:
    """Accumulates IFD entries + out-of-line payloads for a little-endian
    file; ``big=True`` emits the BigTIFF layout (u64 count, 20-byte entries,
    8-byte inline values, u64 offsets)."""

    def __init__(self, big: bool = False) -> None:
        self.big = big
        self.entries: list[tuple[int, int, int, bytes]] = []  # tag,type,count,payload

    def add(self, tag: int, ftype: int, values) -> None:
        ch, sz = _FIELD_TYPES[ftype]
        if ftype == 2:
            payload = values.encode("ascii") + b"\0"
            count = len(payload)
        else:
            vals = tuple(values)
            count = len(vals)
            try:
                payload = struct.pack("<" + ch * count, *vals)
            except struct.error as e:
                raise ValueError(
                    f"TIFF tag {tag}: value out of range for field type "
                    f"{ftype}: {e}"
                ) from e
        self.entries.append((tag, ftype, count, payload))

    def serialize(self, ifd_offset: int, next_off: int = 0) -> bytes:
        """Serialized IFD at ``ifd_offset`` whose next-IFD pointer is
        ``next_off`` (0 = end of chain).  The output LENGTH depends only on
        the entries, never on the offsets — multi-page layout relies on
        measuring with dummy offsets first."""
        self.entries.sort(key=lambda e: e[0])
        n = len(self.entries)
        if self.big:
            esz, inline, ptr_fmt = 20, 8, "Q"
            body = struct.pack("<Q", n)
            head_fmt = "<HHQ"
        else:
            esz, inline, ptr_fmt = 12, 4, "I"
            body = struct.pack("<H", n)
            head_fmt = "<HHI"
        overflow_off = ifd_offset + len(body) + n * esz + struct.calcsize("<" + ptr_fmt)
        overflow = b""
        for tag, ftype, count, payload in self.entries:
            body += struct.pack(head_fmt, tag, ftype, count)
            if len(payload) <= inline:
                body += payload.ljust(inline, b"\0")
            else:
                body += struct.pack("<" + ptr_fmt, overflow_off + len(overflow))
                # TIFF 6.0: value offsets must be even — pad odd payloads
                overflow += payload + b"\0" * (len(payload) & 1)
        body += struct.pack("<" + ptr_fmt, next_off)
        return body + overflow


def _page_ifd(
    big: bool,
    is_overview: bool,
    pw: int,
    ph: int,
    spp: int,
    bits: int,
    fmt: int,
    comp_id: int,
    use_pred: bool,
    tile: int | None,
    offsets,
    counts,
    geo: "GeoMeta | None",
    extra_ascii_tags: Mapping[int, str] | None,
    ifd_off: int,
    next_off: int,
) -> bytes:
    """Serialize one page's IFD (shared by the one-shot and streaming
    writers).  Geo/extra tags belong to the full-resolution page only —
    pass ``geo=None`` / ``extra_ascii_tags=None`` for overview pages.
    Raises :class:`_ClassicOverflow` when a classic-layout pointer
    overflows u32 (a 4 GB problem, not a tag-value problem)."""
    ifd = _IfdBuilder(big)
    if is_overview:
        ifd.add(_T_NEW_SUBFILE_TYPE, 4, (1,))  # reduced-resolution page
    ifd.add(_T_IMAGE_WIDTH, 4, (pw,))
    ifd.add(_T_IMAGE_LENGTH, 4, (ph,))
    ifd.add(_T_BITS_PER_SAMPLE, 3, (bits,) * spp)
    ifd.add(_T_COMPRESSION, 3, (comp_id,))
    ifd.add(_T_PHOTOMETRIC, 3, (1,))  # BlackIsZero
    ifd.add(_T_SAMPLES_PER_PIXEL, 3, (spp,))
    ifd.add(_T_PLANAR_CONFIG, 3, (1,))
    ifd.add(_T_SAMPLE_FORMAT, 3, (fmt,) * spp)
    if use_pred:
        ifd.add(_T_PREDICTOR, 3, (2,))
    off_type = 16 if big else 4  # LONG8 under BigTIFF
    if tile:
        ifd.add(_T_TILE_WIDTH, 3, (int(tile),))
        ifd.add(_T_TILE_LENGTH, 3, (int(tile),))
        ifd.add(_T_TILE_OFFSETS, off_type, offsets)
        ifd.add(_T_TILE_BYTE_COUNTS, off_type, counts)
    else:
        ifd.add(_T_ROWS_PER_STRIP, 3, (64,))
        ifd.add(_T_STRIP_OFFSETS, off_type, offsets)
        ifd.add(_T_STRIP_BYTE_COUNTS, off_type, counts)
    if geo is not None:
        if geo.pixel_scale:
            ifd.add(_T_MODEL_PIXEL_SCALE, 12, geo.pixel_scale)
        if geo.tiepoint:
            ifd.add(_T_MODEL_TIEPOINT, 12, geo.tiepoint)
        if geo.geo_key_directory:
            ifd.add(_T_GEO_KEY_DIRECTORY, 3, geo.geo_key_directory)
        if geo.geo_double_params:
            ifd.add(_T_GEO_DOUBLE_PARAMS, 12, geo.geo_double_params)
        if geo.geo_ascii_params:
            ifd.add(_T_GEO_ASCII_PARAMS, 2, geo.geo_ascii_params)
        if geo.nodata is not None:
            ifd.add(_T_GDAL_NODATA, 2, ("%g" % geo.nodata))
    for tag, text in (extra_ascii_tags or {}).items():
        ifd.add(tag, 2, text)
    try:
        return ifd.serialize(ifd_off, next_off)
    except struct.error as e:
        if big:
            raise  # not a 4 GB problem: bad tag values
        # an out-of-line payload pointer overflowed classic's u32
        raise _ClassicOverflow(str(e)) from e


def _overview_pyramid(
    chunky: np.ndarray, levels: int, resampling: str
) -> list[np.ndarray]:
    """2×-decimated ``(H, W, S)`` reductions of ``chunky``, each level
    built from the previous one.  ``"nearest"`` subsamples (safe for
    categorical products — year-of-detection, counts, masks — and GDAL's
    own default); ``"average"`` box-means 2×2 (odd edges replicate),
    rounding back into integer dtypes."""
    if resampling not in ("nearest", "average"):
        raise ValueError(f"resampling={resampling!r} not 'nearest'|'average'")
    out: list[np.ndarray] = []
    cur = chunky
    for _ in range(levels):
        h, w = cur.shape[:2]
        if min(h, w) < 2:
            break
        if resampling == "nearest":
            cur = np.ascontiguousarray(cur[::2, ::2])
        else:
            if h & 1:
                cur = np.concatenate([cur, cur[-1:]], axis=0)
            if w & 1:
                cur = np.concatenate([cur, cur[:, -1:]], axis=1)
            acc = (
                cur[0::2, 0::2].astype(np.float64)
                + cur[1::2, 0::2]
                + cur[0::2, 1::2]
                + cur[1::2, 1::2]
            ) / 4.0
            if chunky.dtype.kind in "iu":
                acc = np.rint(acc)
            cur = np.ascontiguousarray(acc.astype(chunky.dtype))
        out.append(cur)
    return out


def write_geotiff(
    path: str,
    array: np.ndarray,
    geo: GeoMeta | None = None,
    compress: str = "deflate",
    tile: int | None = 256,
    predictor: bool = True,
    extra_ascii_tags: Mapping[int, str] | None = None,
    bigtiff: bool | str = "auto",
    overviews: int | str = 0,
    resampling: str = "nearest",
) -> None:
    """Encode ``array`` (``(H, W)`` or ``(bands, H, W)``) as a GeoTIFF.

    Always little-endian, chunky band layout; ``tile=None`` writes one strip
    per 64 rows instead of tiles.  ``compress`` is ``"deflate"`` (default),
    ``"lzw"``, or ``"none"``.  ``predictor`` enables horizontal
    differencing for integer dtypes under deflate/LZW (better compression
    on smooth rasters; ignored for floats and uncompressed files).

    ``bigtiff``: ``"auto"`` (default) switches to the BigTIFF layout (u64
    offsets) exactly when the encoded file would overflow classic TIFF's
    4 GB addressing — e.g. the CONUS ARD mosaic products of the scale-out
    config (SURVEY.md §7 hard-part 5); ``True``/``False`` force the choice
    (forcing ``False`` on an oversized file raises).

    ``overviews`` appends that many 2×-decimated reduced-resolution pages
    (``"auto"``: until the smaller dimension drops under 256) to the IFD
    chain, each tagged ``NewSubfileType=1`` — the ``gdaladdo``-style
    pyramid GIS viewers expect on large rasters.  ``resampling`` picks the
    decimation (``"nearest"`` default — safe for categorical products;
    ``"average"`` for continuous ones).  :func:`read_geotiff` skips
    overview pages, so round-trips are unaffected.
    """
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"array must be (H, W) or (bands, H, W); got {arr.shape}")
    if arr.dtype.newbyteorder("=") not in _DTYPE_TO_FORMAT:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    spp, height, width = arr.shape
    fmt, bits = _DTYPE_TO_FORMAT[arr.dtype.newbyteorder("=")]
    comp_id = _resolve_compress(compress)
    use_pred = bool(predictor) and comp_id != _COMP_NONE and fmt in (1, 2)

    chunky = np.moveaxis(arr, 0, -1)  # (H, W, S)

    if overviews == "auto":
        # halve any level whose smaller dimension is still >= 256, so the
        # last overview's smaller dimension drops under 256
        n_levels = 0
        d = min(height, width)
        while d >= 256:
            n_levels += 1
            d //= 2
    else:
        n_levels = int(overviews)
        if n_levels < 0:
            raise ValueError(f"overviews={overviews!r} must be >= 0 or 'auto'")
    pages = [chunky] + (
        _overview_pyramid(chunky, n_levels, resampling) if n_levels else []
    )
    page_shapes = [p.shape[:2] for p in pages]

    def gen_blocks(page: np.ndarray):
        ph, pw = page.shape[:2]
        if tile:
            tw = th = int(tile)
            for ty in range((ph + th - 1) // th):
                for tx in range((pw + tw - 1) // tw):
                    full = np.zeros((th, tw, spp), dtype=arr.dtype)
                    y0, x0 = ty * th, tx * tw
                    h = min(th, ph - y0)
                    w = min(tw, pw - x0)
                    full[:h, :w] = page[y0 : y0 + h, x0 : x0 + w]
                    yield full
        else:
            for y0 in range(0, ph, 64):
                yield np.ascontiguousarray(page[y0 : y0 + 64])

    page_blocks = [_encode_all(gen_blocks(p), comp_id, use_pred) for p in pages]
    # only shapes are needed past this point — drop the raw overview arrays
    # so a CONUS-scale 'auto' write doesn't hold ~1/3 extra uncompressed
    # raster through layout() and the write loop
    del pages

    def _build_ifd(
        big: bool, page_i: int, ifd_off: int, next_off: int, offsets, counts
    ) -> bytes:
        ph, pw = page_shapes[page_i]
        return _page_ifd(
            big,
            page_i > 0,
            pw,
            ph,
            spp,
            bits,
            fmt,
            comp_id,
            use_pred,
            tile,
            offsets,
            counts,
            geo if page_i == 0 else None,  # georeferencing: full page only
            extra_ascii_tags if page_i == 0 else None,
            ifd_off,
            next_off,
        )

    def layout(big: bool):
        """Exact file layout for one format choice: per-page block
        offsets/counts and the serialized IFD chain (all out-of-line
        payloads included), so the 4 GB decision below is based on real
        sizes, not a heuristic bound.  IFD blob LENGTHS are offset-
        independent (_IfdBuilder.serialize), so pass 1 measures with dummy
        offsets and pass 2 re-serializes at the true positions."""
        data_off = 16 if big else 8  # blocks start right after the header
        pos = data_off
        page_offs = []
        for blocks in page_blocks:
            offsets: list[int] = []
            counts: list[int] = []
            for b in blocks:
                offsets.append(pos)
                counts.append(len(b))
                pos += len(b) + (len(b) & 1)  # keep offsets word-aligned
            page_offs.append((offsets, counts))
        # classic-u32 bounds are checked EXPLICITLY here and at serialize
        # time only — a struct.error from tag *values* (e.g. an out-of-range
        # geo key SHORT) is a genuine input error in both layouts and
        # propagates as-is instead of masquerading as "file too big"
        if not big and pos > 2**32 - 1:
            raise _ClassicOverflow(f"block data ends at {pos} bytes")
        sizes = [
            len(_build_ifd(big, i, 0, 0, *page_offs[i]))
            for i in range(len(page_shapes))
        ]
        ifd_positions = []
        cur = pos
        for s in sizes:
            ifd_positions.append(cur)
            cur += s
        if not big and cur > 2**32 - 1:
            raise _ClassicOverflow(f"file ends at {cur} bytes")
        ifd_blobs = []
        for i in range(len(page_shapes)):
            nxt = ifd_positions[i + 1] if i + 1 < len(page_shapes) else 0
            blob = _build_ifd(big, i, ifd_positions[i], nxt, *page_offs[i])
            assert len(blob) == sizes[i]
            ifd_blobs.append(blob)
        return ifd_positions[0], ifd_blobs

    if bigtiff == "auto":
        try:
            big = False
            ifd0_off, ifd_blobs = layout(False)
        except _ClassicOverflow:
            big = True
            ifd0_off, ifd_blobs = layout(True)
    else:
        big = bool(bigtiff)
        try:
            ifd0_off, ifd_blobs = layout(big)
        except _ClassicOverflow as e:
            raise ValueError(
                f"{path}: encoded size exceeds classic TIFF's 4 GB addressing "
                f"({e}); use bigtiff=True (or the default bigtiff='auto')"
            ) from e

    with open(path, "wb") as f:
        if big:
            f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, ifd0_off))
        else:
            f.write(struct.pack("<2sHI", b"II", 42, ifd0_off))
        for blocks in page_blocks:
            for b in blocks:
                f.write(b)
                if len(b) & 1:
                    f.write(b"\0")
        for blob in ifd_blobs:
            f.write(blob)


class _StreamLevel:
    """Per-page bookkeeping for :class:`GeoTiffStreamWriter`: grid shape,
    partially-filled block buffers, and the offset/count tables the IFD
    needs at close."""

    __slots__ = ("ph", "pw", "nby", "nbx", "partial", "filled", "offsets", "counts")

    def __init__(self, ph: int, pw: int, tile: int) -> None:
        self.ph, self.pw = ph, pw
        self.nby = (ph + tile - 1) // tile
        self.nbx = (pw + tile - 1) // tile
        self.partial: dict[int, np.ndarray] = {}  # block idx -> (t, t, spp) buf
        self.filled: dict[int, int] = {}  # block idx -> real pixels covered
        self.offsets: list[int] = [0] * (self.nby * self.nbx)
        self.counts: list[int] = [0] * (self.nby * self.nbx)

    def real_area(self, idx: int, tile: int) -> int:
        ty, tx = divmod(idx, self.nbx)
        return min(tile, self.ph - ty * tile) * min(tile, self.pw - tx * tile)


class GeoTiffStreamWriter:
    """Incremental tiled GeoTIFF writer: windows in, blocks out, IFD at close.

    The one-shot :func:`write_geotiff` needs the whole ``(bands, H, W)``
    mosaic in host memory — fine at WRS-2 scene scale, impossible at the
    CONUS ARD mosaic scale of BASELINE configs[4] (one float32 band at
    ~9e9 px is ~36 GB).  This writer bounds host memory by O(open blocks):
    callers push non-overlapping ``(h, w, bands)`` windows in any order;
    every 256×256 block whose real coverage completes is compressed and
    appended to the file immediately (native-batched), and ``close()``
    writes the IFD chain at EOF and patches the header's first-IFD
    pointer — a layout every TIFF reader follows (offsets are explicit;
    nothing requires IFDs to precede data).

    Overviews build incrementally: each window cascades a nearest-
    decimated copy (global-parity aligned, so the result is pixel-
    identical to :func:`write_geotiff`'s ``resampling="nearest"`` pyramid)
    into the next level's block grid.  ``"average"`` resampling would need
    neighbor rows across window boundaries, so it stays a one-shot-writer
    feature.

    Memory: completed blocks leave immediately; a partial block lives
    until its real area is covered.  Row-major windows whose size is a
    multiple of 256 complete every block they touch on arrival (zero
    buffering); unaligned windows buffer at most one block-row per level.

    BigTIFF choice: the exact-layout probe of the one-shot writer needs
    every block encoded up front, which streaming exists to avoid — so
    ``bigtiff="auto"`` here picks classic only when a *worst-case* encoded
    bound (incompressible data through the chosen codec, plus IFD tables)
    fits u32 addressing with margin.  The bound errs toward BigTIFF; both
    layouts round-trip through :func:`read_geotiff`.
    """

    def __init__(
        self,
        path: str,
        height: int,
        width: int,
        bands: int,
        dtype,
        geo: GeoMeta | None = None,
        compress: str = "deflate",
        tile: int = 256,
        predictor: bool = True,
        extra_ascii_tags: Mapping[int, str] | None = None,
        bigtiff: bool | str = "auto",
        overviews: int | str = 0,
        resampling: str = "nearest",
        allow_partial: bool = False,
        compress_level: int = 6,
    ) -> None:
        dt = np.dtype(dtype)
        if dt.newbyteorder("=") not in _DTYPE_TO_FORMAT:
            raise ValueError(f"unsupported dtype {dt}")
        if not tile or int(tile) <= 0:
            raise ValueError("GeoTiffStreamWriter is tiled-only (tile >= 1)")
        if resampling != "nearest":
            raise ValueError(
                "streaming overviews are nearest-only (average needs "
                "cross-window neighbor rows); use write_geotiff for average"
            )
        if not -1 <= int(compress_level) <= 9:
            # eager like every other constructor check: zlib rejects
            # out-of-range levels only at the first flush, after a partial
            # file is already on disk
            raise ValueError(f"compress_level={compress_level} not in [-1, 9]")
        self.path = path
        self.height, self.width, self.spp = int(height), int(width), int(bands)
        self.dtype = dt.newbyteorder("<")
        self.fmt, self.bits = _DTYPE_TO_FORMAT[dt.newbyteorder("=")]
        self.comp_id = _resolve_compress(compress)
        #: zlib effort for deflate output (GDAL's ZLEVEL equivalent): 1 is
        #: ~3-4x faster for ~15% larger files — the right trade when the
        #: writer is the pipeline's CPU bottleneck (e.g. scene synthesis
        #: or manifest-heavy gigapixel runs).  Ignored for none/LZW.
        self.compress_level = int(compress_level)
        self.tile = int(tile)
        self.use_pred = bool(predictor) and self.comp_id != _COMP_NONE and self.fmt in (1, 2)
        self.geo = geo
        self.extra_ascii_tags = extra_ascii_tags
        self.allow_partial = allow_partial

        if overviews == "auto":
            n_levels, d = 0, min(self.height, self.width)
            while d >= 256:
                n_levels += 1
                d //= 2
        else:
            n_levels = int(overviews)
            if n_levels < 0:
                raise ValueError(f"overviews={overviews!r} must be >= 0 or 'auto'")
        self.levels: list[_StreamLevel] = [
            _StreamLevel(self.height, self.width, self.tile)
        ]
        ph, pw = self.height, self.width
        for _ in range(n_levels):
            if min(ph, pw) < 2:  # matches _overview_pyramid's stop rule
                break
            ph, pw = (ph + 1) // 2, (pw + 1) // 2
            self.levels.append(_StreamLevel(ph, pw, self.tile))

        self.big = self._pick_layout(bigtiff)
        self._pending: list[tuple[int, int, np.ndarray]] = []  # (level, idx, buf)
        self._closed = False
        self._f: BinaryIO = open(path, "wb")
        if self.big:
            self._f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 0))
            self._pos = 16
        else:
            self._f.write(struct.pack("<2sHI", b"II", 42, 0))
            self._pos = 8

    # -- layout ------------------------------------------------------------

    def _pick_layout(self, bigtiff: bool | str) -> bool:
        if bigtiff != "auto":
            return bool(bigtiff)
        t = self.tile
        n_blocks = sum(lv.nby * lv.nbx for lv in self.levels)
        raw_block = t * t * self.spp * self.dtype.itemsize
        if self.comp_id == _COMP_DEFLATE_ADOBE:
            # zlib worst case: stored blocks, ~5 bytes / 16 KB + header
            worst_block = raw_block + raw_block // 1000 + 64
        elif self.comp_id == _COMP_LZW:
            # 12-bit codes for 8-bit-novel data: 1.5x + table resets
            worst_block = raw_block * 3 // 2 + 64
        else:
            worst_block = raw_block + 1  # odd-length pad
        ifd_bound = 4096 + 16 * n_blocks + 2 * len(self.levels) * 512
        end = 16 + n_blocks * worst_block + ifd_bound
        return end > 2**32 - 2**20

    # -- write path --------------------------------------------------------

    def write(self, y0: int, x0: int, window: np.ndarray) -> None:
        """Scatter one non-overlapping ``(h, w)`` / ``(h, w, bands)`` window
        (top-left at ``(y0, x0)``) into the block grids of every level."""
        if self._closed:
            raise ValueError("writer is closed")
        win = np.asarray(window)
        if win.ndim == 2:
            win = win[..., None]
        if win.ndim != 3 or win.shape[2] != self.spp:
            raise ValueError(
                f"window must be (h, w) or (h, w, {self.spp}); got {win.shape}"
            )
        win = win.astype(self.dtype, copy=False)
        for lvl_i, lvl in enumerate(self.levels):
            h, w = win.shape[:2]
            if h == 0 or w == 0:
                break
            if y0 + h > lvl.ph or x0 + w > lvl.pw or y0 < 0 or x0 < 0:
                raise ValueError(
                    f"window {win.shape} at ({y0},{x0}) exceeds level {lvl_i} "
                    f"extent ({lvl.ph},{lvl.pw})"
                )
            self._scatter(lvl_i, y0, x0, win)
            if lvl_i + 1 == len(self.levels):
                break
            # nearest cascade, global-parity aligned: level L+1 row r is
            # global level-L row 2r, so keep local rows where (y0+i) is even
            sy, sx = y0 & 1, x0 & 1
            win = win[sy::2, sx::2]
            y0, x0 = (y0 + sy) // 2, (x0 + sx) // 2
        self._flush_pending()

    def _scatter(self, lvl_i: int, y0: int, x0: int, win: np.ndarray) -> None:
        lvl = self.levels[lvl_i]
        t = self.tile
        h, w = win.shape[:2]
        for ty in range(y0 // t, (y0 + h - 1) // t + 1):
            for tx in range(x0 // t, (x0 + w - 1) // t + 1):
                idx = ty * lvl.nbx + tx
                by, bx = ty * t, tx * t
                ys, xs = max(y0, by), max(x0, bx)
                ye, xe = min(y0 + h, by + t), min(x0 + w, bx + t)
                buf = lvl.partial.get(idx)
                if buf is None:
                    if lvl.counts[idx] or lvl.filled.get(idx):
                        raise ValueError(
                            f"level {lvl_i} block {idx} written twice "
                            "(windows must not overlap)"
                        )
                    buf = np.zeros((t, t, self.spp), dtype=self.dtype)
                    lvl.partial[idx] = buf
                buf[ys - by : ye - by, xs - bx : xe - bx] = win[
                    ys - y0 : ye - y0, xs - x0 : xe - x0
                ]
                filled = lvl.filled.get(idx, 0) + (ye - ys) * (xe - xs)
                lvl.filled[idx] = filled
                if filled == lvl.real_area(idx, t):
                    self._pending.append((lvl_i, idx, buf))
                    del lvl.partial[idx]

    def _flush_pending(self, force: bool = False) -> None:
        if not self._pending or (len(self._pending) < _ENCODE_CHUNK and not force):
            return
        blobs = _encode_all(
            (buf for _, _, buf in self._pending), self.comp_id, self.use_pred,
            self.compress_level,
        )
        for (lvl_i, idx, _), blob in zip(self._pending, blobs):
            lvl = self.levels[lvl_i]
            lvl.offsets[idx] = self._pos
            lvl.counts[idx] = len(blob)
            self._f.write(blob)
            self._pos += len(blob)
            if len(blob) & 1:  # keep offsets word-aligned
                self._f.write(b"\0")
                self._pos += 1
        self._pending.clear()

    # -- close -------------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        try:
            # incomplete = partially-touched AND never-touched blocks alike
            incomplete = [
                (i, idx)
                for i, lvl in enumerate(self.levels)
                for idx in range(lvl.nby * lvl.nbx)
                if lvl.filled.get(idx, 0) != lvl.real_area(idx, self.tile)
            ]
            if incomplete and not self.allow_partial:
                raise ValueError(
                    f"{len(incomplete)} block(s) not fully covered at close "
                    f"(first few: {incomplete[:5]}); pass allow_partial=True "
                    "to zero-fill"
                )
            for lvl_i, idx in incomplete:
                lvl = self.levels[lvl_i]
                buf = lvl.partial.pop(
                    idx, None
                )  # never-touched blocks become all-zero
                if buf is None:
                    buf = np.zeros((self.tile, self.tile, self.spp), self.dtype)
                self._pending.append((lvl_i, idx, buf))
            self._flush_pending(force=True)

            def build(ifd_positions: list[int]) -> list[bytes]:
                blobs = []
                for i, lvl in enumerate(self.levels):
                    nxt = (
                        ifd_positions[i + 1] if i + 1 < len(self.levels) else 0
                    )
                    blobs.append(
                        _page_ifd(
                            self.big,
                            i > 0,
                            lvl.pw,
                            lvl.ph,
                            self.spp,
                            self.bits,
                            self.fmt,
                            self.comp_id,
                            self.use_pred,
                            self.tile,
                            lvl.offsets,
                            lvl.counts,
                            self.geo if i == 0 else None,
                            self.extra_ascii_tags if i == 0 else None,
                            ifd_positions[i],
                            nxt,
                        )
                    )
                return blobs

            # IFD blob lengths are offset-independent: measure, place, re-emit
            sizes = [len(b) for b in build([0] * len(self.levels))]
            positions, cur = [], self._pos
            for s in sizes:
                positions.append(cur)
                cur += s
            if not self.big and cur > 2**32 - 1:
                raise ValueError(
                    f"{self.path}: streamed file ends at {cur} bytes, past "
                    "classic TIFF addressing — the bigtiff='auto' bound "
                    "should have chosen BigTIFF; force bigtiff=True"
                )
            for blob in build(positions):
                self._f.write(blob)
            self._f.seek(8 if self.big else 4)
            ptr = struct.pack("<Q" if self.big else "<I", positions[0])
            self._f.write(ptr)
        finally:
            self._closed = True
            self._f.close()

    def abort(self) -> None:
        """Release the file handle WITHOUT completeness checks or IFD
        emission — for error paths that must not mask an in-flight
        exception (the half-written file is left for the caller to
        unlink)."""
        if not self._closed:
            self._closed = True
            self._f.close()

    def __enter__(self) -> "GeoTiffStreamWriter":
        return self

    def __exit__(self, exc_type, *_) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


def _encode_block(
    block: np.ndarray, comp_id: int, use_pred: bool, level: int = 6
) -> bytes:
    if use_pred:
        block = _predict(block)
    raw = block.tobytes()
    if comp_id == _COMP_NONE:
        return raw
    if comp_id == _COMP_LZW:
        return _lzw_encode(raw)
    return zlib.compress(raw, level)


#: blocks per native-encode batch: bounds transient memory to CHUNK blocks
#: (e.g. 16 × 256²×spp samples) while amortising the ctypes call + thread
#: spawn over enough independent work to keep the pool busy.
_ENCODE_CHUNK = 16


def _encode_all(
    block_iter, comp_id: int, use_pred: bool, level: int = 6
) -> list[bytes]:
    """Encode a stream of blocks, in chunks through the native library when
    possible, else per-block NumPy.

    Blocks are consumed lazily — peak transient memory is one chunk, not
    the whole raster.  Equal-shape runs batch together (always true for the
    tiled layout; the strip layout's short last strip flushes a chunk).
    Both paths produce byte-identical output: same zlib level, same
    predictor arithmetic, same LZW code stream — the native path is
    acceleration only.
    """
    if not (native.available() and comp_id in (_COMP_DEFLATE_ADOBE, _COMP_LZW)):
        return [_encode_block(b, comp_id, use_pred, level) for b in block_iter]

    out: list[bytes] = []
    chunk: list[np.ndarray] = []

    def flush() -> None:
        if not chunk:
            return
        if use_pred and chunk[0].dtype.itemsize == 8:
            out.extend(_encode_block(b, comp_id, use_pred, level) for b in chunk)
        else:
            try:
                out.extend(
                    native.encode_blocks(
                        np.stack(chunk),  # fresh stack → safe to mutate
                        predictor=2 if use_pred else 1,
                        compression=comp_id,
                        level=level,
                        in_place=True,
                    )
                )
            except native.NativeCodecError:
                out.extend(
                    _encode_block(b, comp_id, use_pred, level) for b in chunk
                )
        chunk.clear()

    for b in block_iter:
        if chunk and b.shape != chunk[0].shape:
            flush()
        chunk.append(b)
        if len(chunk) >= _ENCODE_CHUNK:
            flush()
    flush()
    return out
