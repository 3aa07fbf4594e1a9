"""Device-resident synthetic WRS-2 scenes, made from a seed on the card.

The statistics of the port's scene generator (``land_trendr_tpu_torch/
io/synthetic.py:make_stack``): a forest scene with patchy stand-clearing
disturbances (a smoothed noise field thresholded at its quantile, one
disturbance year per patch), exponential regrowth, per-observation cloud
with the Collection-2 cloud bit, sensor noise, and per-year fill strips
at the left and right edges with the fill bit.  The draws come from one
``torch.Generator`` on the scene's device, so the same seed gives the
same scene, and nothing of the scene crosses the host.

The scene is laid out as the driver's feed hands tiles to the tile
program (``runtime/driver.py:_feed_tile``): for every tile of the
row-major grid, each band is a contiguous ``(tile_px, NY)`` block of
int16 DNs (row ``iy * w + ix`` of the tile window), and the QA band a
uint16 block; an edge tile's rows past ``h * w`` are padding, DN 0 with
the QA fill bit.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Scene", "SceneStats", "TileWindow", "make_scene", "plan_tiles"]

#: mean healthy-forest surface reflectance per band
_FOREST_SR = {
    "blue": 0.015, "green": 0.035, "red": 0.020,
    "nir": 0.380, "swir1": 0.130, "swir2": 0.060,
}
#: reflectance immediately after a stand-clearing disturbance
_DISTURBED_SR = {
    "blue": 0.045, "green": 0.070, "red": 0.085,
    "nir": 0.180, "swir1": 0.280, "swir2": 0.230,
}
_C2_SCALE = 2.75e-5
_C2_OFFSET = -0.2
_QA_FILL = 1 << 0
_QA_CLOUD = 1 << 3


@dataclasses.dataclass(frozen=True)
class SceneStats:
    """The scene statistics (the port generator's ``SceneSpec`` defaults)."""

    disturbance_fraction: float = 0.3
    patch_scale: int = 16
    recovery_rate: float = 0.08
    cloud_fraction: float = 0.08
    noise: float = 0.006


@dataclasses.dataclass(frozen=True)
class TileWindow:
    """One tile's window in the scene grid."""

    y0: int
    x0: int
    h: int
    w: int

    @property
    def px(self) -> int:
        return self.h * self.w


def plan_tiles(height: int, width: int, tile: int) -> list[TileWindow]:
    """The row-major fixed grid the driver plans; edge tiles are smaller."""
    return [
        TileWindow(y0, x0, min(tile, height - y0), min(tile, width - x0))
        for y0 in range(0, height, tile)
        for x0 in range(0, width, tile)
    ]


@dataclasses.dataclass
class Scene:
    """A scene in tile layout: ``dn[band][k]`` and ``qa[k]`` are tile
    ``k``'s ``(tile_px, NY)`` blocks."""

    years: torch.Tensor            # (NY,) int32
    tiles: list[TileWindow]
    tile_px: int
    dn: dict[str, torch.Tensor]    # band -> (n_tiles, tile_px, NY) int16
    qa: torch.Tensor               # (n_tiles, tile_px, NY) uint16
    disturbed_share: float
    cloud_share: float

    def tile_inputs(self, k: int) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        return {b: a[k] for b, a in self.dn.items()}, self.qa[k]


def _upsample(field: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear upsample of a coarse ``(gh, gw)`` field to ``(h, w)``."""
    gh, gw = field.shape
    dev = field.device
    yi = torch.linspace(0, gh - 1, h, dtype=torch.float64, device=dev)
    xi = torch.linspace(0, gw - 1, w, dtype=torch.float64, device=dev)
    y0 = yi.floor().long()
    x0 = xi.floor().long()
    y1 = (y0 + 1).clamp(max=gh - 1)
    x1 = (x0 + 1).clamp(max=gw - 1)
    fy = (yi - y0)[:, None]
    fx = (xi - x0)[None, :]
    return (
        field[y0][:, x0] * (1 - fy) * (1 - fx)
        + field[y1][:, x0] * fy * (1 - fx)
        + field[y0][:, x1] * (1 - fy) * fx
        + field[y1][:, x1] * fy * fx
    )


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``numpy.quantile``'s linear rule (``torch.quantile`` caps its input
    size far below a scene's)."""
    s = torch.sort(x.reshape(-1)).values
    pos = (s.numel() - 1) * q
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def make_scene(
    width: int,
    height: int,
    year_start: int,
    year_end: int,
    tile: int,
    bands: tuple[str, ...],
    stats: SceneStats,
    seed: int,
    device: "torch.device | str",
) -> Scene:
    """Generate a ``height x width`` scene of ``bands`` for the years
    ``year_start..year_end`` on ``device``, cut into ``tile``-sided tiles."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed % (1 << 63))
    years = torch.arange(year_start, year_end + 1, dtype=torch.int32, device=dev)
    ny = years.numel()
    h, w = height, width

    # patchy disturbance map: thresholded smooth noise, one year per patch
    gh, gw = max(2, h // stats.patch_scale), max(2, w // stats.patch_scale)
    field = torch.randn(gh, gw, generator=g, device=dev, dtype=torch.float64)
    smooth = _upsample(field, h, w)
    disturbed = smooth > _quantile(smooth, 1.0 - stats.disturbance_fraction)
    del smooth
    lo = min(year_start + 5, year_end)
    hi = max(year_end - 5, lo + 1)
    d_year_grid = torch.randint(lo, hi, (gh, gw), generator=g, device=dev, dtype=torch.int32)
    ry = torch.linspace(0, gh - 1, h, dtype=torch.float64, device=dev).round().long()
    rx = torch.linspace(0, gw - 1, w, dtype=torch.float64, device=dev).round().long()
    truth_year = torch.where(disturbed, d_year_grid[ry][:, rx], -1)
    severity = torch.rand(h, w, generator=g, device=dev) * 0.5 + 0.5
    severity = torch.where(disturbed, severity, 0.0)
    margin = torch.randint(0, max(2, w // 32), (ny,), generator=g, device=dev)

    tiles = plan_tiles(h, w, tile)
    tile_px = tile * tile
    n = len(tiles)
    dn = {b: torch.empty((n, tile_px, ny), dtype=torch.int16, device=dev) for b in bands}
    qa = torch.empty((n, tile_px, ny), dtype=torch.int16, device=dev)
    t = years.to(torch.float32)
    n_cloudy = torch.zeros((), dtype=torch.int64, device=dev)
    for k, tw in enumerate(tiles):
        px = tw.px
        ty = truth_year[tw.y0 : tw.y0 + tw.h, tw.x0 : tw.x0 + tw.w].reshape(px, 1)
        sev = severity[tw.y0 : tw.y0 + tw.h, tw.x0 : tw.x0 + tw.w].reshape(px, 1)
        cols = (tw.x0 + torch.arange(px, device=dev) % tw.w).unsqueeze(1)
        since = (t - ty).clamp(min=0.0)
        active = (ty >= 0) & (t >= ty)
        blend = torch.where(active, sev * torch.exp(-stats.recovery_rate * since), 0.0)
        cloudy = torch.rand(px, ny, generator=g, device=dev) < stats.cloud_fraction
        fill = (cols < margin) | (cols >= w - margin)
        n_cloudy += cloudy.sum()
        for b in bands:
            base, post = _FOREST_SR[b], _DISTURBED_SR[b]
            sr = base + (post - base) * blend
            sr = sr + torch.randn(px, ny, generator=g, device=dev) * stats.noise
            sr = torch.where(cloudy, torch.rand(px, ny, generator=g, device=dev) * 0.5 + 0.4, sr)
            sr = torch.where(fill, _C2_OFFSET, sr)
            d = torch.round((sr - _C2_OFFSET) / _C2_SCALE).clamp(-32768, 32767)
            dn[b][k, :px] = d.to(torch.int16)
            dn[b][k, px:] = 0
        qa[k, :px] = (
            torch.where(cloudy, _QA_CLOUD, 0) | torch.where(fill, _QA_FILL, 0)
        ).to(torch.int16)
        qa[k, px:] = _QA_FILL
    return Scene(
        years=years,
        tiles=tiles,
        tile_px=tile_px,
        dn=dn,
        qa=qa.view(torch.uint16),
        disturbed_share=float(disturbed.float().mean()),
        cloud_share=int(n_cloudy) / (h * w * ny),
    )
