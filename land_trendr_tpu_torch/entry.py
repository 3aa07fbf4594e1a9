"""Entry points: a single-card forward step and a multi-device dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.

``entry(device="cuda")`` returns the flagship forward step — the batched
LandTrendr segmentation, :func:`~land_trendr_tpu_torch.ops.segment_cuda.
cuda_segment_pixels` — with a 256 x 40 example batch on ``device``: the
fused CUDA kernel for CUDA tensors, its plain PyTorch version only for CPU
tensors.  There is no compile step to check: the kernel library is built
at its first launch, keyed by its source's hash.

``dryrun_multichip(n, devices=None)`` runs one whole pipeline step over a
mesh of ``n`` devices, as the JAX function does over ``n`` chips: the
pixel axis padded to the mesh and segmented sharded, FTV fitted on the
shards, the metrics reduction, the f64 decisions held against one device
and against the oracle, the multi-host feed path, and the full driver
under the mesh with change selection and assembly.  The pixel axis is the
only one there is to shard (no weights, and each pixel keeps its whole
year axis).  PyTorch has no virtual devices, so a mesh may repeat one:
``["cuda:0"] * n`` on one card, ``["cpu"] * n`` on the CPU.
"""

from __future__ import annotations

import os
import tempfile
from typing import Sequence

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.models import oracle
from land_trendr_tpu_torch.ops.segment import SegOutputs
from land_trendr_tpu_torch.ops.segment_cuda import cuda_segment_pixels
from land_trendr_tpu_torch.ops.tile import ftv_fit, resolve_impl
from land_trendr_tpu_torch.parallel import (
    feed_global,
    gather_local_rows,
    make_mesh,
    pad_to_multiple,
    segment_pixels_sharded,
    shard_pixels,
    summarize_sharded,
)

__all__ = ["entry", "dryrun_multichip"]

#: the decision fields the dry run holds exactly
DECISIONS = ("vertex_indices", "n_vertices", "model_valid")


def _example_batch(px: int, ny: int):
    """``(years int32 (NY,), values float32 (PX, NY), mask bool (PX, NY))``:
    a step disturbance at a random year on noisy flat series, 10% of the
    years masked, from seed 11 — the JAX package's example batch, value
    for value."""
    rng = np.random.default_rng(11)
    years = np.arange(1984, 1984 + ny, dtype=np.int32)
    t = np.arange(ny, dtype=np.float32)[None, :]
    d_year = rng.integers(3, ny - 3, size=(px, 1))
    mag = rng.uniform(0.1, 0.4, size=(px, 1)).astype(np.float32)
    vals = 0.65 - np.where(t >= d_year, mag, 0.0) + rng.normal(
        0.0, 0.01, size=(px, ny)
    ).astype(np.float32)
    mask = rng.uniform(size=(px, ny)) > 0.1
    return years, (-vals).astype(np.float32), mask


def entry(device: "str | torch.device" = "cuda"):
    """``(forward, (years, values, mask))`` for a single-card run.

    ``forward(years, values, mask)`` segments with default ``LTParams``;
    the batch is :func:`_example_batch` at 256 px x 40 years as tensors on
    ``device``.  Without a CUDA device it raises unless the caller asks
    for the CPU (``device="cpu"``): it never falls back.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "entry(): no CUDA device (torch.cuda.is_available() is False); "
            "pass device='cpu' to run the plain version on the CPU"
        )
    params = LTParams()

    def forward(years: torch.Tensor, values: torch.Tensor, mask: torch.Tensor) -> SegOutputs:
        return cuda_segment_pixels(years, values, mask, params)

    years, vals, mask = _example_batch(px=256, ny=40)
    return forward, tuple(torch.from_numpy(a).to(dev) for a in (years, vals, mask))


def _mesh_of(n_devices: int, devices: "Sequence[torch.device | str] | None") -> list:
    devs = make_mesh(devices)
    if len(devs) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devs)}; on one card pass "
            f"devices=['cuda:0'] * {n_devices}, on the CPU devices=['cpu'] * {n_devices}"
        )
    return devs[:n_devices]


def dryrun_multichip(n_devices: int,
                     devices: "Sequence[torch.device | str] | None" = None) -> dict:
    """One fully sharded pipeline step over the first ``n_devices`` of
    ``devices`` (default :func:`~land_trendr_tpu_torch.parallel.make_mesh`:
    every local CUDA device, which raises without one); fewer devices than
    ``n_devices`` raise.  Asserts what the JAX dry run asserts and returns
    what it computed: the sharded decisions in f32 and f64, the metrics,
    the driver's run summary and the assembled rasters' names.
    """
    mesh = _mesh_of(n_devices, devices)
    kind = mesh[0].type
    params = LTParams(max_segments=4, vertex_count_overshoot=2)

    # tiny but uneven shapes: the padding and every sharded code path
    years_np, vals_np, mask_np = _example_batch(px=3 * n_devices + 1, ny=16)
    years = torch.from_numpy(years_np)
    vals_p, mask_p, n_real = pad_to_multiple(
        torch.from_numpy(vals_np), torch.from_numpy(mask_np), n_devices)
    out = segment_pixels_sharded(years, vals_p, mask_p, params, mesh=mesh)

    # FTV on the shards, each on its own device (the second sharded step),
    # picked by the device as the tile program picks it
    step = vals_p.shape[0] // n_devices
    ftv = []
    for k, (d, (v, m)) in enumerate(zip(mesh, shard_pixels(mesh, vals_p, mask_p))):
        part = slice(k * step, (k + 1) * step)
        ftv.append(ftv_fit(resolve_impl("auto", d))(
            years.to(d), v, m, out.vertex_indices[part].to(d), out.n_vertices[part].to(d),
            params).cpu())
    ftv = torch.cat(ftv)

    # the cross-pixel metrics reduction
    metrics = summarize_sharded(out, n_real=n_real)

    # the value check: in f64 the sharded run makes the decisions of one
    # device's run of the same batch, and those of the oracle on three pixels
    y64, v64 = years.double(), vals_p.double()
    out_sh = segment_pixels_sharded(y64, v64, mask_p, params, mesh=mesh)
    one = cuda_segment_pixels(y64.to(mesh[0]), v64.to(mesh[0]), mask_p.to(mesh[0]), params)
    for field in DECISIONS:
        assert torch.equal(getattr(out_sh, field), getattr(one, field).cpu()), (
            f"sharded != single-device on {field}")
    for i in (0, n_real // 2, n_real - 1):
        ref = oracle.segment_series(y64.numpy(), v64[i].numpy(), mask_p[i].numpy(), params)
        assert bool(out_sh.model_valid[i]) == ref.model_valid, f"oracle model_valid px {i}"
        assert int(out_sh.n_vertices[i]) == ref.n_vertices, f"oracle n_vertices px {i}"
        assert (out_sh.vertex_indices[i].numpy() == ref.vertex_indices).all(), (
            f"oracle vertices px {i}")

    # the multi-host feed path: this process's rows on its mesh, segmented
    # shard by shard, and its result rows gathered back
    rows = feed_global(mesh, vals_p, mask_p)
    local_rmse = gather_local_rows([
        cuda_segment_pixels(years.to(v.device), v, m, params).rmse
        for v, m in zip(rows.values, rows.mask)
    ])

    assert out.fitted.shape == (vals_p.shape[0], 16)
    assert out.model_valid[:n_real].any(), "no pixel fitted"
    assert not out.model_valid[n_real:].any(), "padding fitted"
    assert bool(torch.isfinite(ftv).all())
    assert 0.0 < metrics["fit_rate"] <= 1.0
    assert local_rmse.shape[0] == vals_p.shape[0]
    assert np.isfinite(local_rmse).all()

    # the full driver under the mesh: stack in, sharded tile program with
    # the change selector, manifest, rasters
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.ops.change import ChangeFilter
    from land_trendr_tpu_torch.runtime import (
        RunConfig,
        assemble_outputs,
        run_stack,
        stack_from_synthetic,
    )

    rs = stack_from_synthetic(make_stack(
        SceneSpec(width=2 * n_devices + 1, height=6, year_start=1998, year_end=2013)))
    with tempfile.TemporaryDirectory(prefix="lt_dryrun_") as tmp:
        cfg = RunConfig(
            params=params,
            tile_size=5,  # 25 px, not a multiple of 2 or 8: the padded path
            workdir=os.path.join(tmp, "work"),
            out_dir=os.path.join(tmp, "out"),
            change_filt=ChangeFilter(min_mag=0.05),
        )
        summary = run_stack(rs, cfg, device=kind, mesh=mesh)
        assert summary["mesh_devices"] == n_devices
        assert summary["pixels"] == 6 * (2 * n_devices + 1)
        paths = assemble_outputs(rs, cfg, device=kind)
        assert os.path.exists(paths["rmse"])

    def decisions(o: SegOutputs) -> dict:
        return {f: getattr(o, f).numpy() for f in DECISIONS}

    return {
        "mesh": [str(d) for d in mesh],
        "n_real": n_real,
        "decisions_f32": decisions(out),
        "decisions_f64": decisions(out_sh),
        "metrics": metrics,
        "summary": {k: summary[k] for k in ("pixels", "tiles", "fit_rate", "mesh_devices")},
        "rasters": sorted(paths),
    }
