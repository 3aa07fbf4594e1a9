"""Host-side Landsat stack handling for the runtime driver.

Replaces the reference driver's GDAL stack-enumeration step (SURVEY.md §2
layer L1 / §4 call stack (1): "read Landsat stack, compute index, mask" in
the driver process).  Unlike the reference, the loaded representation stays
in the *narrow* on-disk dtype — int16 surface-reflectance DNs + uint16 QA —
because index math and masking run fused on device
(:mod:`land_trendr_tpu_torch.ops.tile`); the host never materialises float32
bands for the whole scene.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from land_trendr_tpu_torch.io.geotiff import GeoMeta, read_geotiff
from land_trendr_tpu_torch.io.synthetic import SyntheticStack
from land_trendr_tpu_torch.ops.indices import BANDS

__all__ = [
    "LazyBandCube",
    "RasterStack",
    "load_stack_dir",
    "load_stack_dir_c2",
    "open_stack_dir_c2_lazy",
    "stack_from_synthetic",
]

# A plausible acquisition year, not any 4-digit run: Landsat product ids put
# path/row digits ("045030") before the date, so take the LAST match of a
# standalone (19|20)xx group.
_YEAR_RE = re.compile(r"(?<!\d)((?:19|20)\d{2})(?!\d)")

# Landsat Collection-2 Level-2 per-band file name, e.g.
# ``LC08_L2SP_045030_20200715_20200912_02_T1_SR_B5.TIF`` — the layout the
# USGS distributes (one file per band + QA_PIXEL), which the GDAL-based
# reference ingests through its stack enumeration (SURVEY.md §2 L1).
_C2_RE = re.compile(
    r"^(?P<sensor>L[COTEM]\d{2})_[A-Z0-9]{4}_(?P<pathrow>\d{6})_"
    r"(?P<date>\d{8})_\d{8}_\d{2}_(?:T1|T2|RT)_"
    r"(?P<prod>SR_B\d|QA_PIXEL)\.tiff?$",
    re.IGNORECASE,
)

#: SR band number → canonical band name, by sensor generation:
#: TM/ETM+ (LT04/LT05/LE07) vs OLI (LC08/LC09, numbering shifted by one).
_C2_TM_BANDS = {1: "blue", 2: "green", 3: "red", 4: "nir", 5: "swir1", 7: "swir2"}
_C2_OLI_BANDS = {2: "blue", 3: "green", 4: "red", 5: "nir", 6: "swir1", 7: "swir2"}


def _c2_band_name(sensor: str, prod: str) -> str | None:
    """Canonical band name for an ``SR_B<n>``/``QA_PIXEL`` product, or None
    for bands the pipeline does not use (e.g. OLI's coastal B1)."""
    if prod.upper() == "QA_PIXEL":
        return "qa"
    n = int(prod[-1])
    table = _C2_OLI_BANDS if sensor.upper() in ("LC08", "LC09") else _C2_TM_BANDS
    return table.get(n)


@dataclasses.dataclass
class RasterStack:
    """An annual Landsat stack in device-feed layout.

    ``dn_bands[name]`` is ``(NY, H, W)`` int16 or uint16 (real C2 SR files
    are uint16 — DNs up to 43636 — and keep that dtype; the device-side
    ``scale_sr`` conversion is dtype-agnostic); ``qa`` is ``(NY, H, W)``
    uint16; ``years`` is ``(NY,)`` int32 ascending.  ``geo`` carries the
    grid so output rasters inherit it (SURVEY.md §2: outputs are written on
    the input grid).
    """

    years: np.ndarray
    dn_bands: dict[str, np.ndarray]
    qa: np.ndarray
    geo: GeoMeta | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.qa.shape[1], self.qa.shape[2]

    @property
    def n_years(self) -> int:
        return int(self.years.shape[0])


def _check_year_dtype(name: str, cube: np.ndarray, img: np.ndarray) -> None:
    """Dtype-uniformity guard: a mixed int16/uint16 archive would either
    silently promote (np.stack → int32, double the documented ~6
    B/pixel-year feed) or silently wrap on assignment into a preallocated
    cube — both outside RasterStack's 16-bit contract."""
    if img.dtype != cube.dtype:
        dtypes = sorted({str(cube.dtype), str(img.dtype)})
        raise ValueError(
            f"band {name!r}: mixed DN dtypes across years {dtypes} — "
            "re-export the archive with one dtype"
        )


def _use_bands(bands) -> tuple[str, ...]:
    """Validate a band-subset request against the canonical band list."""
    if bands is None:
        return BANDS
    use = tuple(bands)
    if not use:
        raise ValueError("bands subset must not be empty (pass None for all)")
    bad = [b for b in use if b not in BANDS]
    if bad:
        raise ValueError(f"unknown band(s) {bad}; choose from {BANDS}")
    return use


def _check_qa_dtype(fp: str, dtype: np.dtype) -> None:
    """The ONE QA_PIXEL whitelist both C2 loaders share.

    C2 defines QA_PIXEL as uint16 with flags through bit 15: a wider file
    would be silently truncated by a blind uint16 cast, and a narrower one
    cannot carry the full flag set — either way the file is not a valid C2
    QA band, so reject it loudly (ADVICE round 5).  Kept as one helper so
    the eager and lazy loaders cannot diverge."""
    if dtype != np.dtype(np.uint16):
        raise ValueError(
            f"{fp}: QA_PIXEL dtype {dtype} unsupported "
            "(expected uint16 bit flags)"
        )


def load_stack_dir(
    path: str,
    pattern: str = r"\.tif$",
    bands=None,
    composite: str | None = None,
    reject_bits: int | None = None,
    scale: float = 2.75e-5,
    offset: float = -0.2,
    device="cuda",
) -> RasterStack:
    """Load a directory of Landsat rasters, auto-detecting the layout.

    Two layouts are understood:

    * **pre-stacked**: one multi-band file per year whose name contains the
      4-digit year (the layout :func:`land_trendr_tpu_torch.io.synthetic.
      write_stack` produces, and the common convention for annual
      composites), bands ordered ``blue, green, red, nir, swir1, swir2,
      QA_PIXEL``;
    * **Collection-2 per-band**: the USGS distribution layout — one file
      per band per acquisition (``*_SR_B2..B7.TIF`` + ``*_QA_PIXEL.TIF``)
      — detected by product-id file names and delegated to
      :func:`load_stack_dir_c2`.

    ``bands`` (optional iterable of canonical band names) loads only that
    subset plus QA — for an NBR run that is 3 cubes instead of 7 (~2.3×
    less host memory at scene scale; the CLI passes
    :func:`~land_trendr_tpu_torch.ops.indices.required_bands` automatically).
    The per-band C2 layout additionally skips reading the unused files.
    ``composite`` ("medoid") applies to the C2 layout only, where multiple
    acquisitions per year can occur — see :func:`load_stack_dir_c2`, which
    also takes ``device``.
    """
    names = sorted(
        n for n in os.listdir(path) if re.search(pattern, n, re.IGNORECASE)
    )
    if not names:
        raise FileNotFoundError(f"no rasters matching {pattern!r} in {path}")
    if any(_C2_RE.match(n) for n in names):
        return load_stack_dir_c2(
            path,
            pattern=pattern,
            bands=bands,
            composite=composite,
            reject_bits=reject_bits,
            scale=scale,
            offset=offset,
            device=device,
        )
    if composite is not None:
        raise ValueError(
            "composite applies to the Collection-2 per-band layout; the "
            "pre-stacked layout is one image per year by construction"
        )
    use = _use_bands(bands)
    entries = []
    for n in names:
        ms = _YEAR_RE.findall(n)
        if not ms:
            raise ValueError(f"cannot parse a plausible 4-digit year from {n!r}")
        entries.append((int(ms[-1]), os.path.join(path, n)))
    entries.sort()
    years = np.array([y for y, _ in entries], dtype=np.int32)
    if len(np.unique(years)) != len(years):
        raise ValueError(f"duplicate years in {path}: {years.tolist()}")

    # Cubes are PREALLOCATED and filled year by year so peak host memory is
    # one stack plus one year file.  (Accumulating per-year band views and
    # np.stack-ing at the end kept every year's full multi-band image alive
    # through the views PLUS the stacked copy — measured ~28 GB peak for a
    # 6 GB 5000²×40yr working set, SCENE_r03.json peak_rss_mib.)
    dn_cubes: dict[str, np.ndarray] = {}
    qa_cube: np.ndarray | None = None
    geo = None
    shape = None
    for k, (year, fp) in enumerate(entries):
        img, g, _info = read_geotiff(fp)
        if img.ndim == 2:
            img = img[None]
        if img.shape[0] < len(BANDS) + 1:
            raise ValueError(
                f"{fp}: expected {len(BANDS) + 1} bands "
                f"({', '.join(BANDS)}, QA_PIXEL); got {img.shape[0]}"
            )
        if img.dtype not in (np.dtype(np.int16), np.dtype(np.uint16)):
            # whitelist, not best-effort casting: float reflectance would
            # zero out, and wider integers (int32 DN exports) would wrap
            # bright pixels negative — both silently
            raise ValueError(
                f"{fp}: dtype {img.dtype} — the stack loaders take "
                "Collection-2 scaled 16-bit DNs (int16/uint16); re-export "
                "as DNs (reflectance = DN * 2.75e-5 - 0.2)"
            )
        if qa_cube is None:
            shape, geo = img.shape[1:], g
            dn_cubes = {
                b: np.empty((len(entries), *shape), img.dtype) for b in use
            }
            qa_cube = np.empty((len(entries), *shape), np.uint16)
        elif img.shape[1:] != shape:
            raise ValueError(f"{fp}: raster size {img.shape[1:]} != {shape}")
        else:
            _check_year_dtype(use[0], dn_cubes[use[0]], img)
        for b in use:
            # band position in the pre-stacked file follows BANDS order
            dn_cubes[b][k] = img[BANDS.index(b)]  # keeps the stored dtype
        qa_cube[k] = img[len(BANDS)].astype(np.uint16, copy=False)

    return RasterStack(
        years=years,
        dn_bands=dn_cubes,
        qa=qa_cube,
        geo=geo,
    )


def load_stack_dir_c2(
    path: str,
    pattern: str | None = None,
    bands=None,
    composite: str | None = None,
    reject_bits: int | None = None,
    scale: float = 2.75e-5,
    offset: float = -0.2,
    device="cuda",
) -> RasterStack:
    """Load a directory of Landsat Collection-2 Level-2 per-band files.

    The real USGS distribution layout (SURVEY.md §2 L1 — the reference's
    GDAL ingest reads it file by file): per acquisition, one GeoTIFF per
    surface-reflectance band (``*_SR_B2..B7.TIF``; TM/ETM+ numbering
    ``B1..B5,B7``) plus ``*_QA_PIXEL.TIF``.  Files group by acquisition
    YEAR; the band mapping follows each file's own sensor prefix, so a
    time series that switches from LT05 to LC08 mid-archive loads
    correctly.  SR DNs keep their on-disk integer dtype — real C2 SR is
    **uint16** (valid DN 7273–43636) and must not be narrowed to int16.

    LandTrendr is an annual-series algorithm, so each year must collapse
    to one image.  By default (``composite=None``) exactly one
    acquisition per year is required and multiple dates raise with the
    offending values listed; ``composite="medoid"`` instead builds the
    per-pixel QA-masked medoid composite of each multi-acquisition year
    on device (:func:`land_trendr_tpu_torch.ops.composite.medoid_composite` —
    an extension beyond the reference, which tells users to composite
    first).  ``reject_bits``/``scale``/``offset`` feed the composite's
    validity masks and should match the run's ``RunConfig`` values so
    selection and segmentation mask identically (None → the C2
    defaults).  ``device`` is where the composite runs: ``"cuda"`` (the
    default, like every entry point; raises without a card) or ``"cpu"``
    — read only when a year needs compositing.  One WRS-2 path/row is required either way; ``pattern``
    (regex on file names, the same argument :func:`load_stack_dir`
    takes) pre-filters the directory, e.g. to select one path/row.
    """
    if composite not in (None, "medoid"):
        raise ValueError(f"composite={composite!r} not None|'medoid'")
    # year -> date -> band -> path
    groups: dict[int, dict[str, dict[str, str]]] = {}
    pathrows: set[str] = set()
    for n in sorted(os.listdir(path)):
        if pattern is not None and not re.search(pattern, n, re.IGNORECASE):
            continue
        m = _C2_RE.match(n)
        if not m:
            continue
        band = _c2_band_name(m["sensor"], m["prod"])
        if band is None:
            continue  # e.g. OLI coastal B1 — unused
        pathrows.add(m["pathrow"])
        year = int(m["date"][:4])
        groups.setdefault(year, {}).setdefault(m["date"], {})[band] = os.path.join(
            path, n
        )
    if not groups:
        raise FileNotFoundError(f"no Collection-2 per-band rasters in {path}")
    if len(pathrows) > 1:
        raise ValueError(
            f"{path}: multiple WRS-2 path/rows {sorted(pathrows)} in one "
            "stack — pass pattern=... to select one scene"
        )
    multi = {y: sorted(d) for y, d in groups.items() if len(d) > 1}
    if multi and composite is None:
        raise ValueError(
            f"{path}: multiple acquisitions per year {multi} — LandTrendr "
            "takes one image per year; pre-composite, prune, or pass "
            "composite='medoid'"
        )

    years = np.array(sorted(groups), dtype=np.int32)
    needed = (*_use_bands(bands), "qa")  # unused bands' files never read
    # preallocated cubes, filled per (year, band): peak memory is one stack
    # plus one year's acquisitions (see load_stack_dir's note)
    dn_cubes: dict[str, np.ndarray] = {}
    qa_cube: np.ndarray | None = None
    geo = None
    shape = None

    def read_band(fp: str, b: str) -> np.ndarray:
        nonlocal shape, geo
        img, gmeta, _info = read_geotiff(fp)
        if img.ndim != 2:
            raise ValueError(
                f"{fp}: expected a single-band raster; got {img.shape}"
            )
        if shape is None:
            shape, geo = img.shape, gmeta
        elif img.shape != shape:
            raise ValueError(f"{fp}: raster size {img.shape} != {shape}")
        if b == "qa":
            _check_qa_dtype(fp, img.dtype)
            return img
        if img.dtype not in (np.dtype(np.int16), np.dtype(np.uint16)):
            # keep the on-disk dtype: real C2 SR is uint16 with valid DNs
            # up to 43636 — an int16 cast would wrap bright pixels (snow,
            # cloud edge) negative with no error
            raise ValueError(
                f"{fp}: SR band dtype {img.dtype} unsupported "
                "(expected int16 or uint16 DNs)"
            )
        return img

    for k, year in enumerate(years.tolist()):
        by_date = groups[year]
        for date in sorted(by_date):
            missing = [b for b in needed if b not in by_date[date]]
            if missing:
                raise ValueError(
                    f"{path}: acquisition {date} is missing bands {missing} "
                    f"(have {sorted(by_date[date])})"
                )
        dates = sorted(by_date)
        if len(dates) == 1:
            per_band = {b: read_band(by_date[dates[0]][b], b) for b in needed}
        else:
            # stack the year's acquisitions and medoid-composite on device
            from land_trendr_tpu_torch.ops.composite import medoid_composite
            from land_trendr_tpu_torch.ops.indices import DEFAULT_QA_REJECT

            stacks = {}
            for b in needed:
                imgs = [read_band(by_date[d][b], b) for d in dates]
                # within-year uniformity: np.stack would silently promote
                # a mixed int16/uint16 year to int32 (same hazard
                # _check_year_dtype blocks across years)
                dtypes = sorted({str(a.dtype) for a in imgs})
                if b != "qa" and len(dtypes) > 1:
                    raise ValueError(
                        f"band {b!r}: mixed DN dtypes across year {year}'s "
                        f"acquisitions {dtypes} — re-export the archive "
                        "with one dtype"
                    )
                stacks[b] = np.stack(imgs)
            comp_dn, comp_qa = medoid_composite(
                {b: stacks[b] for b in needed if b != "qa"},
                stacks["qa"],
                reject_bits=(
                    DEFAULT_QA_REJECT if reject_bits is None else reject_bits
                ),
                scale=scale,
                offset=offset,
                device=device,
            )
            per_band = {**comp_dn, "qa": comp_qa}
        for b in needed:
            img = per_band[b]
            if b == "qa":
                if qa_cube is None:
                    qa_cube = np.empty((len(years), *shape), np.uint16)
                qa_cube[k] = img
            else:
                if b not in dn_cubes:
                    dn_cubes[b] = np.empty((len(years), *shape), img.dtype)
                else:
                    _check_year_dtype(b, dn_cubes[b], img)
                dn_cubes[b][k] = img

    assert qa_cube is not None  # needed bands are enforced per year
    return RasterStack(
        years=years,
        dn_bands=dn_cubes,
        qa=qa_cube,
        geo=geo,
    )


def stack_from_synthetic(stack: SyntheticStack, geo: GeoMeta | None = None) -> RasterStack:
    """Adapt an in-memory synthetic stack (tests / benchmarks) to the
    driver's feed layout without a disk round-trip."""
    return RasterStack(
        years=stack.years.astype(np.int32),
        dn_bands={b: stack.dn(b) for b in BANDS},
        qa=stack.qa.astype(np.uint16),
        geo=geo,
    )


class LazyBandCube:
    """``(NY, H, W)``-shaped lazy cube: one single-band raster per year.

    Holds no pixel data — ``__getitem__`` window-reads only the blocks a
    tile needs (:func:`~land_trendr_tpu_torch.io.geotiff.read_geotiff_window`).
    This is the CONUS-scale ingest seam (BASELINE configs[4], SURVEY.md
    §2 L1): a gigapixel mosaic's input cubes cannot live in host RAM, so
    the reference reads GDAL windows on demand; this duck-types exactly
    the slicing the driver feed performs (``a[:, y0:y1, x0:x1]``) over
    per-year files instead.  Use :func:`open_stack_dir_c2_lazy` to build
    a :class:`RasterStack` of these.
    """

    def __init__(self, paths: list[str], shape: tuple[int, int], dtype):
        self.paths = list(paths)
        self.shape = (len(self.paths), *shape)
        self.dtype = np.dtype(dtype)
        self.ndim = 3

    def prefetch_window(self, y0: int, x0: int, h: int, w: int) -> int:
        """Readahead hint: decode the blocks of this window (every year)
        into the process-wide decoded-block cache off-thread, so a later
        ``self[:, y0:y0+h, x0:x0+w]`` is served from cache — the driver
        feed pool hints the NEXT planned tile while the current one waits
        on the device.  Fire-and-forget; returns the number of per-file
        hints actually queued (0 when the cache/readahead is off or the
        decode pool is saturated — the read then just decodes on demand).
        """
        from land_trendr_tpu_torch.io import blockcache

        queued = 0
        for p in self.paths:
            if blockcache.prefetch_window(p, y0, x0, h, w):
                queued += 1
        return queued

    def __getitem__(self, key) -> np.ndarray:
        from land_trendr_tpu_torch.io.geotiff import read_geotiff_window

        if not (isinstance(key, tuple) and len(key) == 3):
            raise TypeError(
                f"LazyBandCube supports [years, y, x] window slicing; got {key!r}"
            )
        ys, rows, cols = key
        ny, h_full, w_full = self.shape

        def norm_int(k: int, dim: int, axis: str) -> int:
            # ndarray index semantics: negatives count from the end; out of
            # range raises.  Without this, a negative int became a negative
            # window offset handed straight to read_geotiff_window
            # (ADVICE round 5).
            j = int(k)
            if j < 0:
                j += dim
            if not 0 <= j < dim:
                raise IndexError(
                    f"index {k} out of bounds for LazyBandCube {axis} axis "
                    f"of size {dim}"
                )
            return j

        yr_idx = (
            range(ny)[ys] if isinstance(ys, slice)
            else [norm_int(ys, ny, "year")]
        )
        r0, r1, rstep = (
            rows.indices(h_full) if isinstance(rows, slice)
            else ((r := norm_int(rows, h_full, "row")), r + 1, 1)
        )
        c0, c1, cstep = (
            cols.indices(w_full) if isinstance(cols, slice)
            else ((c := norm_int(cols, w_full, "col")), c + 1, 1)
        )
        if rstep != 1 or cstep != 1:
            raise ValueError("LazyBandCube windows must be contiguous (step 1)")
        h, w = r1 - r0, c1 - c0
        out = np.empty((len(yr_idx), h, w), self.dtype)
        for i, k in enumerate(yr_idx):
            win = read_geotiff_window(self.paths[k], r0, c0, h, w)
            if win.ndim != 2:
                raise ValueError(
                    f"{self.paths[k]}: expected a single-band raster for a "
                    f"lazy cube; got shape {win.shape}"
                )
            out[i] = win
        return out


def open_stack_dir_c2_lazy(
    path: str, pattern: str | None = None, bands=None
) -> RasterStack:
    """Open a Collection-2 per-band directory WITHOUT reading pixel data.

    Same layout rules as :func:`load_stack_dir_c2` (one acquisition per
    year — compositing requires the eager loader; one WRS-2 path/row),
    but each band becomes a :class:`LazyBandCube` whose windows are read
    on demand by the driver's tile feed.  Header-only validation up
    front: every needed file must exist, agree on raster size, and carry
    a 16-bit sample format.  Peak host memory for a run over the result
    is O(tile), not O(scene) — the configs[4] requirement.
    """
    from land_trendr_tpu_torch.io.geotiff import read_geotiff_info

    groups: dict[int, dict[str, dict[str, str]]] = {}
    pathrows: set[str] = set()
    for n in sorted(os.listdir(path)):
        if pattern is not None and not re.search(pattern, n, re.IGNORECASE):
            continue
        m = _C2_RE.match(n)
        if not m:
            continue
        band = _c2_band_name(m["sensor"], m["prod"])
        if band is None:
            continue
        pathrows.add(m["pathrow"])
        year = int(m["date"][:4])
        groups.setdefault(year, {}).setdefault(m["date"], {})[band] = os.path.join(
            path, n
        )
    if not groups:
        raise FileNotFoundError(f"no Collection-2 per-band rasters in {path}")
    if len(pathrows) > 1:
        raise ValueError(
            f"{path}: multiple WRS-2 path/rows {sorted(pathrows)} in one "
            "stack — pass pattern=... to select one scene"
        )
    multi = {y: sorted(d) for y, d in groups.items() if len(d) > 1}
    if multi:
        raise ValueError(
            f"{path}: multiple acquisitions per year {multi} — the lazy "
            "opener takes one image per year (compositing needs the eager "
            "loader: load_stack_dir_c2(..., composite='medoid'))"
        )
    years = np.array(sorted(groups), dtype=np.int32)
    needed = (*_use_bands(bands), "qa")
    per_band_paths: dict[str, list[str]] = {b: [] for b in needed}
    for year in years.tolist():
        (date,) = groups[year]
        missing = [b for b in needed if b not in groups[year][date]]
        if missing:
            raise ValueError(
                f"{path}: acquisition {date} is missing bands {missing} "
                f"(have {sorted(groups[year][date])})"
            )
        for b in needed:
            per_band_paths[b].append(groups[year][date][b])

    shape = None
    geo = None
    dtypes: dict[str, str] = {}
    for b in needed:
        for fp in per_band_paths[b]:
            gmeta, info = read_geotiff_info(fp)
            if shape is None:
                shape, geo = (info.height, info.width), gmeta
            elif (info.height, info.width) != shape:
                raise ValueError(
                    f"{fp}: raster size {(info.height, info.width)} != {shape}"
                )
            if b == "qa":
                # the lazy feed casts windows to uint16 blindly, so the
                # header dtype must pass the shared whitelist up front
                _check_qa_dtype(fp, info.dtype)
            elif info.dtype not in (
                np.dtype(np.int16), np.dtype(np.uint16)
            ):
                # same whitelist as the eager loader's read_band: f16 has
                # itemsize 2 but rounds DNs above its 2048 integer-exact
                # range — reject, don't silently corrupt radiometry
                raise ValueError(
                    f"{fp}: SR band dtype {info.dtype} unsupported "
                    "(expected int16 or uint16 DNs)"
                )
            prev = dtypes.setdefault(b, str(info.dtype))
            if b != "qa" and prev != str(info.dtype):
                raise ValueError(
                    f"band {b!r}: mixed DN dtypes across years "
                    f"{sorted({prev, str(info.dtype)})} — re-export the "
                    "archive with one dtype"
                )
    dn = {
        b: LazyBandCube(per_band_paths[b], shape, np.dtype(dtypes[b]))
        for b in needed if b != "qa"
    }
    qa = LazyBandCube(per_band_paths["qa"], shape, np.uint16)
    return RasterStack(years=years, dn_bands=dn, qa=qa, geo=geo)
