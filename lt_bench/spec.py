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
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable

__all__ = ["Cell", "ROOT", "load_cell", "load_reader", "metrics_of"]

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


def load_reader(metric: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``root/lt_bench/metrics/<metric>.py``, loaded from
    its file (a metric's name may hold dots)."""
    path = root / "lt_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"lt_bench_metric_{metric}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
