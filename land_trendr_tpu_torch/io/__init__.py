"""io subpackage: host-side raster I/O (GeoTIFF codec, synthetic stacks,
decoded-block cache + shared decode pool for the feed path, the persistent
ingest store).  Copies of the JAX package's modules of the same names,
which hold no JAX code."""

from land_trendr_tpu_torch.io import blockcache
from land_trendr_tpu_torch.io.geotiff import (
    GeoMeta,
    GeoTiffStreamWriter,
    TiffInfo,
    read_geotiff,
    read_geotiff_info,
    read_geotiff_window,
    write_geotiff,
)
from land_trendr_tpu_torch.io.synthetic import (
    SceneSpec,
    SyntheticStack,
    make_stack,
    write_stack,
)

__all__ = [
    "blockcache",
    "GeoMeta",
    "GeoTiffStreamWriter",
    "TiffInfo",
    "read_geotiff",
    "read_geotiff_info",
    "read_geotiff_window",
    "write_geotiff",
    "SceneSpec",
    "SyntheticStack",
    "make_stack",
    "write_stack",
]
