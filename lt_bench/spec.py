"""Find a cell's pieces by name: ``BENCHMARK.json`` and the files under
``lt_bench/``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each lives in a file of its own, found by its name:

* ``lt_bench/configs/<config>.json`` — the deployment: scene, years,
  indices, LandTrendr parameters, change filter, the scene statistics;
* ``lt_bench/traffic/<traffic>.json`` — how the tiles are driven: tile
  size, which products are fetched, how many tiles and rows the check
  samples;
* ``lt_bench/limits/<cell>.json`` — each number ``correct`` compares, with
  its limit;
* ``lt_bench/metrics/<metric>.py`` — one reader per metric, a
  ``read(run)`` that returns the number or None.

So a later cell, mix or metric is added by adding files and entries,
and no file of the harness changes.

A later configuration is added the same way.  Besides its JSON file it
may bring:

* a ``"run"`` object in that file: ``RunConfig`` fields of the port
  (``land_trendr_tpu_torch/runtime/driver.py``) by name, lists taken as
  tuples, applied after the fields the harness derives from the
  configuration and the mix (:data:`lt_bench.harness.DERIVED`), which it
  may not name.  Every field that is also a parameter of the tile
  program ``ops/tile.py:process_tile_dn`` reaches it by that name;
* a ``"reference"`` key naming its own reference module,
  ``lt_bench/reference/<reference>.py`` (default ``tile``), found by
  :func:`load_reference`.  The module imports nothing of the program or
  of JAX and provides ``spec_of(config, traffic)`` (what its
  ``reference_products`` needs of the cell), ``bands_of(config)`` (the
  bands the scene carries), ``series_per_px(config)`` (how many series
  the segmentation kernel fits a pixel; the kernel's bytes a pixel are
  counted that many times) and ``reference_products(years, dn, qa,
  spec, chunk)`` (every product the cell lands, as host arrays, for the
  rows given);
* metric files for what only it reports, listed by the metric's
  ``workloads`` key.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable

__all__ = ["Cell", "ROOT", "load_cell", "load_reader", "load_reference", "metrics_of"]

#: the checkout's root: ``BENCHMARK.json`` beside the ``lt_bench`` folder
ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    limits: dict[str, float]
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, kind: str, workload: str) -> tuple[dict, ...]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics ``workload``
    reports: those with no ``workloads`` key and those that list it."""
    return tuple(
        m for m in bench[kind] if "workloads" not in m or workload in m["workloads"]
    )


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = _read_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(wl)})")
    w = wl[name]
    here = root / "lt_bench"
    return Cell(
        name=name,
        root=root,
        chips=int(w["chips"]),
        config=_read_json(here / "configs" / f"{w['config']}.json"),
        traffic=_read_json(here / "traffic" / f"{w['traffic']}.json"),
        limits={k: float(v["limit"]) for k, v in _read_json(here / "limits" / f"{name}.json").items()},
        end_to_end=metrics_of(bench, "end_to_end", name),
        per_layer=metrics_of(bench, "per_layer", name),
    )


def _load_file(path: Path, module_name: str):
    """The module of the file at ``path``, run afresh under
    ``module_name`` (registered, as a dataclass in it needs)."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``root/lt_bench/metrics/<metric>.py``, loaded from
    its file (a metric's name may hold dots)."""
    path = root / "lt_bench" / "metrics" / f"{metric}.py"
    return _load_file(path, f"lt_bench_metric_{metric}").read


def load_reference(cell: Cell):
    """The reference module the cell's configuration names (its
    ``"reference"`` key, default ``tile``): ``lt_bench.reference.<name>``
    of this checkout, or loaded from its file under another root."""
    name = cell.config.get("reference", "tile")
    if not name.isidentifier():
        raise ValueError(f"reference {name!r} is not a module name")
    if cell.root == ROOT:
        return importlib.import_module(f"lt_bench.reference.{name}")
    path = cell.root / "lt_bench" / "reference" / f"{name}.py"
    return _load_file(path, f"lt_bench_reference_{name}")
