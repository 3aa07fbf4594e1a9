"""One run of one cell: set-up, the measured window, the check, the metrics.

The window drives the per-tile step of the port's driver
(``land_trendr_tpu_torch/runtime/driver.py:Run._dispatch``): the tile
program ``ops/tile.py:process_tile_dn`` on a tile's device-resident DNs,
then ``runtime/fetch.py:TileFetcher.start`` (the packed copy into pinned
host memory on a side stream), then the handle's ``wait()``.  Tiles are
taken in raster order, scene after scene, and ``fetch_depth`` of them
stay in flight as the driver keeps them: after each dispatch the oldest
is awaited until no more than that remain.  The window runs for the
seconds asked and on to the end of the scene pass under way.  A tile is
done when its ``wait()`` returns, its products landed; unpacking and
writing them are the writer's work and stay out of the window.

The check draws a sample of the window's tiles (one edge tile always
among them) and of their rows from the seed, unpacks those tiles through
the port's own handle once the window has closed, and holds every
landed product against the plain reference (the configuration's module
under ``lt_bench/reference``), recomputed from the same DNs after the
program's state is freed.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
import time
from collections import deque
from typing import Callable

import numpy as np

from lt_bench.spec import Cell, load_reference

__all__ = ["DERIVED", "FORBIDDEN", "Run", "TileRecord", "forbidden_modules", "run_cell",
           "tile_program_args"]

#: top-level module names no run may have loaded once its window closes:
#: JAX and the JAX package (the port's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "land_trendr_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class TileRecord:
    """One tile of the window, by the host's clock (``perf_counter``)."""

    k: int                 # the tile's index in the scene
    px: int                # its real pixels
    t_call: float          # before ``process_tile_dn``
    t_dispatched: float    # ``process_tile_dn`` returned
    t_started: float       # ``TileFetcher.start`` returned
    t_landed: float = 0.0  # ``wait()`` returned


@dataclasses.dataclass
class Run:
    """What the metric readers see of one run."""

    cell: Cell
    device_kind: str
    setup_s: float
    window_s: float
    tiles: list[TileRecord]
    launches: int          # the kernel's launches in the window (its counter)
    trace: object = None   # lt_bench.trace.TraceDigest of a traced run


@dataclasses.dataclass
class _Sampler:
    """Seeded reservoir of the window's tiles: ``size - 1`` slots over all
    tiles and one over the edge tiles, each with rows drawn to check."""

    rng: np.random.Generator
    size: int
    n_all: int = 0
    n_edge: int = 0
    picked: list = dataclasses.field(default_factory=list)
    edge: "tuple | None" = None

    def offer(self, ordinal: int, tw, k: int, handle, edge: bool) -> None:
        item = (ordinal, k, tw, handle)
        if edge:
            self.n_edge += 1
            if self.rng.random() * self.n_edge < 1.0:
                self.edge = item
        self.n_all += 1
        if len(self.picked) < self.size - 1:
            self.picked.append(item)
        else:
            j = int(self.rng.integers(self.n_all))
            if j < self.size - 1:
                self.picked[j] = item

    def items(self) -> list:
        seen = {}
        for item in [*self.picked, *([self.edge] if self.edge else [])]:
            seen[item[0]] = item
        return [seen[o] for o in sorted(seen)]


#: ``RunConfig`` fields the harness derives from the configuration and the
#: mix (and ``fetch_f16``, the control's switch); a configuration's
#: ``"run"`` object may set any other field, never these
DERIVED = ("index", "ftv_indices", "params", "tile_size", "products", "change_filt",
           "scale", "offset", "fetch_f16")

#: ``process_tile_dn``'s parameters the harness does not take from the
#: ``RunConfig`` by name: the tile's inputs, the implementation (the
#: port's default: the kernel on the card) and ``chunk`` (``chunk_px``)
_NOT_BY_NAME = ("years", "dn_bands", "qa", "impl", "chunk")

#: rows a block of the reference computes at once
REF_CHUNK = 262_144


def program_config(cell: Cell, fetch_f16: bool = False):
    """The port's ``RunConfig`` for the cell (the driver's defaults for
    chunking and fetch depth, then the configuration's ``"run"`` object);
    ``fetch_f16`` is the control's path."""
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops.change import ChangeFilter
    from land_trendr_tpu_torch.runtime.driver import RunConfig

    c, t = cell.config, cell.traffic
    run = c.get("run", {})
    clash = sorted(set(run) & set(DERIVED))
    if clash:
        raise ValueError(f"{cell.name}: the configuration's \"run\" names {clash}, "
                         f"which the harness derives ({', '.join(DERIVED)})")
    return RunConfig(
        index=c["index"],
        ftv_indices=tuple(c["ftv_indices"]),
        params=LTParams(**c["params"]),
        tile_size=int(t["tile_size"]),
        products=tuple(t["products"]),
        change_filt=ChangeFilter(**c["change_filter"]) if t["change"] else None,
        scale=float(c["scale"]),
        offset=float(c["offset"]),
        fetch_f16=fetch_f16,
        **{k: tuple(v) if isinstance(v, list) else v for k, v in run.items()},
    )


def reference_spec(cell: Cell):
    """The reference's view of the same cell, by the cell's reference
    module (its own parameter classes)."""
    return load_reference(cell).spec_of(cell.config, cell.traffic)


def _bands(cell: Cell) -> tuple[str, ...]:
    return load_reference(cell).bands_of(cell.config)


def make_cell_scene(cell: Cell, seed: int, device, size: "tuple[int, int] | None" = None):
    """The cell's scene from ``seed`` (``size`` = (height, width) overrides
    the configuration's, for tests)."""
    from lt_bench.gen import SceneStats, make_scene

    c = cell.config
    h, w = size or (c["scene"]["height"], c["scene"]["width"])
    return make_scene(
        width=w,
        height=h,
        year_start=c["scene"]["year_start"],
        year_end=c["scene"]["year_end"],
        tile=int(cell.traffic["tile_size"]),
        bands=_bands(cell),
        stats=SceneStats(**c["assumed"]["scene_stats"]),
        seed=seed,
        device=device,
    )


def tile_program_args(cfg) -> dict:
    """The keyword arguments of ``process_tile_dn`` that the ``RunConfig``
    gives: every field named as one of its parameters (bar
    :data:`_NOT_BY_NAME`), and ``chunk`` from ``chunk_px``."""
    from land_trendr_tpu_torch.ops.tile import process_tile_dn

    fields = {f.name for f in dataclasses.fields(cfg)}
    names = [p for p in inspect.signature(process_tile_dn).parameters
             if p in fields and p not in _NOT_BY_NAME]
    return {**{p: getattr(cfg, p) for p in names}, "chunk": cfg.chunk_px}


class Program:
    """The program's per-tile step, bound to one scene and configuration."""

    def __init__(self, scene, cfg, device) -> None:
        import torch

        from land_trendr_tpu_torch.ops.tile import process_tile_dn
        from land_trendr_tpu_torch.runtime.fetch import TileFetcher, resolve_packed

        dev = torch.device(device)
        self.scene = scene
        self.cfg = cfg
        self.fetcher = TileFetcher(cfg, dev, packed=resolve_packed("auto", dev))
        self._process = process_tile_dn
        self._args = tile_program_args(cfg)
        self._record = torch.profiler.record_function

    def dispatch(self, k: int):
        """Enqueue tile ``k``'s program; its device outputs."""
        dn, qa = self.scene.tile_inputs(k)
        with self._record("lt_bench.dispatch"):
            return self._process(self.scene.years, dn, qa, **self._args)

    def fetch(self, out):
        with self._record("lt_bench.fetch"):
            return self.fetcher.start(out)

    def wait(self, handle) -> None:
        with self._record("lt_bench.wait"):
            handle.wait()


def drive(prog: Program, depth: int, seconds: float, sampler: "_Sampler | None" = None,
          max_tiles: "int | None" = None) -> tuple[list[TileRecord], float]:
    """The closed loop: dispatch and fetch tiles in raster order, keeping
    no more than ``depth`` in flight after each dispatch, until ``seconds``
    have passed and the scene pass under way is whole (or ``max_tiles``
    are dispatched); then land the rest.  Whole passes keep the work of a
    window the same from run to run: an edge tile costs a full tile and
    lands fewer pixels.  Returns the tiles and the window's seconds,
    first call to last land."""
    tiles = prog.scene.tiles
    n = len(tiles)
    inflight: deque = deque()
    done: list[TileRecord] = []

    def land() -> None:
        rec, handle = inflight.popleft()
        prog.wait(handle)
        rec.t_landed = time.perf_counter()
        done.append(rec)
        if sampler is not None:
            tw = tiles[rec.k]
            edge = tw.h * tw.w < prog.scene.tile_px
            sampler.offer(len(done) - 1, tw, rec.k, handle, edge)

    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while (time.perf_counter() < deadline or i % n) and (max_tiles is None or i < max_tiles):
        k = i % n
        t_call = time.perf_counter()
        out = prog.dispatch(k)
        t_disp = time.perf_counter()
        handle = prog.fetch(out)
        del out
        inflight.append((TileRecord(k, tiles[k].px, t_call, t_disp, time.perf_counter()), handle))
        while len(inflight) > depth:
            land()
        i += 1
    while inflight:
        land()
    return done, time.perf_counter() - t0


def check(cell: Cell, scene, items: list, rng: np.random.Generator, device,
          free: Callable[[], None]) -> dict:
    """Unpack the sampled tiles through the program's handles, keep the
    sampled rows, free the program's state, recompute the rows with the
    cell's reference module and compare.  Returns the per-product gaps and the numbers
    compared."""
    import torch

    from lt_bench.compare import product_gaps

    rows_per = int(cell.traffic["check_rows"])
    prog_parts: dict[str, list[np.ndarray]] = {}
    dn_parts: dict[str, list] = {b: [] for b in scene.dn}
    qa_parts = []
    for _ordinal, k, tw, handle in items:
        rows = np.sort(rng.choice(tw.px, size=min(rows_per, tw.px), replace=False))
        arrays, model_valid = handle.rows(tw.px)
        arrays.setdefault("model_valid", model_valid)
        for name, a in arrays.items():
            prog_parts.setdefault(name, []).append(a[rows])
        idx = torch.from_numpy(rows).to(device)
        for b in scene.dn:
            dn_parts[b].append(scene.dn[b][k].index_select(0, idx))
        qa_parts.append(scene.qa[k].view(torch.int16).index_select(0, idx))
    years = scene.years
    dn = {b: torch.cat(v) for b, v in dn_parts.items()}
    qa = torch.cat(qa_parts).view(torch.uint16)
    prog_rows = {name: np.concatenate(v) for name, v in prog_parts.items()}
    items.clear()
    free()
    module = load_reference(cell)
    spec = module.spec_of(cell.config, cell.traffic)
    gaps = product_gaps(prog_rows, module.reference_products(years, dn, qa, spec, REF_CHUNK))
    return {
        "rows": int(qa.shape[0]),
        "gaps": gaps,
        "numbers": {"worst_gap": max(gaps.values(), default=float("inf"))},
    }


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", fetch_f16: bool = False, size=None,
             warm_tiles: "int | None" = None, max_tiles: "int | None" = None) -> dict:
    """Set up, measure and check one run; returns the run, the check, the
    memory peak and the seconds from ``t_start`` at the end of each phase.
    ``fetch_f16`` switches on the control's path; the CPU device, ``size``
    (scene height, width), ``warm_tiles`` and ``max_tiles`` (a window cut
    after that many tiles) are for tests."""
    import torch

    from land_trendr_tpu_torch.ops import segment_cuda
    from lt_bench import trace as tracemod

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(seed % (1 << 63))
    marks = {"imports": time.perf_counter() - t_start}

    def mark(name: str) -> None:
        marks[name] = time.perf_counter() - t_start

    if on_card:
        segment_cuda.load_library()  # the first run of a checkout builds it
    mark("library")
    scene = make_cell_scene(cell, seed, dev, size)
    mark("scene")
    cfg = program_config(cell, fetch_f16)
    prog = Program(scene, cfg, dev)
    depth = int(cfg.fetch_depth)
    n_check = int(cell.traffic["check_tiles"])

    # warm-up: the cell's one tile shape through the whole step (every
    # tile is padded to it), then as many pinned buffers of its fetch as
    # the window holds at once (in flight and kept for the check), so the
    # host allocator's cache already has them
    drive(prog, depth, float("inf"), max_tiles=warm_tiles or depth + 1)
    if on_card:
        from land_trendr_tpu_torch.runtime.fetch import plan_wire_bytes

        nbytes = plan_wire_bytes(prog.fetcher.plan)
        stock = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                 for _ in range(depth + n_check + 1)]
        del stock
        torch.cuda.synchronize()
    mark("warm_up")

    prof = None
    if trace:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        *([torch.profiler.ProfilerActivity.CUDA] if on_card else [])]
        )
        prof.start()
    sampler = _Sampler(rng, n_check)
    launches0 = segment_cuda.LAUNCHES
    setup_s = time.perf_counter() - t_start
    with torch.profiler.record_function(tracemod.WINDOW):
        tiles, window_s = drive(prog, depth, seconds, sampler, max_tiles)
    launches = segment_cuda.LAUNCHES - launches0
    mark("window")
    digest = None
    if prof is not None:
        if on_card:
            torch.cuda.synchronize()
        prof.stop()
        mark("trace_stop")
        digest = tracemod.digest(prof.profiler.kineto_results.events())
        prof = None
        mark("trace_digest")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    def free() -> None:
        nonlocal prog
        scene.dn.clear()
        scene.qa = None
        prog = None
        if on_card:
            torch.cuda.empty_cache()

    checked = check(cell, scene, sampler.items(), rng, dev, free)
    mark("check")
    run = Run(
        cell=cell,
        device_kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
        setup_s=setup_s,
        window_s=window_s,
        tiles=tiles,
        launches=launches,
        trace=digest,
    )
    return {
        "run": run,
        "checked": checked,
        "memory_peak_bytes": int(peak),
        "marks": marks,
    }
