"""The port's pod runs (``parallel/multihost.py``), held against the JAX
package's: the static ``host_share`` split, the process group, the
primary's event-log merge, the local-rows feed and gather, and one real
two-process ``gloo`` pod through ``run_stack`` over a shared workdir.
"""

import json
import os
import shutil
import socket

import jax
import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.ops.segment import jax_segment_pixels
from land_trendr_tpu.parallel import feed_global as jax_feed_global
from land_trendr_tpu.parallel import gather_local_rows as jax_gather_local_rows
from land_trendr_tpu.parallel import make_mesh as jax_make_mesh
from land_trendr_tpu.parallel import multihost as jax_mh
from land_trendr_tpu.runtime import faults as jax_faults
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.segment import torch_segment_pixels
from land_trendr_tpu_torch.parallel import multihost as mh
from land_trendr_tpu_torch.runtime import faults

torch.set_num_threads(1)

PARAMS = LTParams(max_segments=4, vertex_count_overshoot=2)
MARKERS = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "SLURM_JOB_ID",
           "SLURM_NTASKS", "SLURM_NPROCS", "SLURM_PROCID")


@pytest.mark.parametrize(
    "n, i", [(n, i) for n in range(1, 9) for i in range(n)], ids=lambda v: str(v)
)
def test_host_share_equals_jax(monkeypatch, n, i):
    """Every process of every pod size up to 8 takes the JAX package's
    contiguous slice, for tile lists shorter and longer than the pod."""
    monkeypatch.setattr(mh, "process_count", lambda: n)
    monkeypatch.setattr(mh, "process_index", lambda: i)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(jax, "process_index", lambda: i)
    for length in range(0, 20):
        items = [(k, -k) for k in range(length)]
        assert mh.host_share(items) == jax_mh.host_share(items), length
    # the shares of all processes tile the list in order
    monkeypatch.setattr(mh, "process_index", lambda: 0)
    parts = []
    for j in range(n):
        monkeypatch.setattr(mh, "process_index", lambda j=j: j)
        parts += mh.host_share(list(range(13)))
    assert parts == list(range(13))


def test_init_distributed_without_a_cluster_is_a_noop(monkeypatch):
    for k in MARKERS:
        monkeypatch.delenv(k, raising=False)
    assert mh.init_distributed() is False
    assert mh.process_index() == 0 and mh.process_count() == 1
    assert mh.is_primary_host()


@pytest.mark.parametrize(
    "env, want",
    [
        ({"WORLD_SIZE": "2"}, True),
        ({"WORLD_SIZE": "1"}, False),
        ({"MASTER_ADDR": "10.0.0.1"}, True),
        ({"SLURM_JOB_ID": "7", "SLURM_NTASKS": "4"}, True),
        ({"SLURM_JOB_ID": "7", "SLURM_NTASKS": "1"}, False),
        ({}, False),
    ],
)
def test_cluster_markers(monkeypatch, env, want):
    for k in MARKERS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mh._cluster_env_detected() is want


def test_explicit_unreachable_coordinator_raises():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]  # nobody listens here
    with pytest.raises(Exception, match="timed out|connect|refused"):
        mh.init_distributed(f"localhost:{port}", 2, 1, timeout_s=1.0)
    assert mh.process_count() == 1
    with pytest.raises(ValueError, match="together"):
        mh.init_distributed("localhost:1", 2)


def _series(rng, px, ny=24):
    years = np.arange(1990, 1990 + ny, dtype=np.int32)
    t = np.arange(ny, dtype=np.float64)[None, :]
    d = rng.integers(5, ny - 5, size=(px, 1))
    vals = 0.6 - np.where(t >= d, 0.3, 0.0) + rng.normal(0, 0.01, (px, ny))
    mask = rng.uniform(size=(px, ny)) > 0.1
    return years, -vals, mask


def test_feed_global_and_gather_local_rows_equal_jax(rng):
    """One process: the port places its rows on a 4-device CPU mesh with
    offset 0, and the rows it gathers back equal the JAX pair's local rows
    on the 8-device mesh (inputs exactly, rmse within the parity bound)."""
    years, vals, mask = _series(rng, px=32)
    rows = mh.feed_global([torch.device("cpu")] * 4, vals, mask)
    assert rows.offset == 0 and rows.n_global == 32
    assert [v.shape[0] for v in rows.values] == [8] * 4
    jmesh = jax_make_mesh()
    gvals, gmask = jax_feed_global(jmesh, vals, mask)
    assert np.array_equal(mh.gather_local_rows(rows.values), jax_gather_local_rows(gvals))
    assert np.array_equal(mh.gather_local_rows(rows.mask), jax_gather_local_rows(gmask))
    outs = [torch_segment_pixels(torch.from_numpy(years), v, m, PARAMS)
            for v, m in zip(rows.values, rows.mask)]
    jout = jax_segment_pixels(years, gvals, gmask, JLTParams(**PARAMS.to_dict()))
    assert np.array_equal(mh.gather_local_rows([o.vertex_indices for o in outs]),
                          jax_gather_local_rows(jout.vertex_indices))
    np.testing.assert_allclose(mh.gather_local_rows([o.rmse for o in outs]),
                               jax_gather_local_rows(jout.rmse), atol=1e-8)


def _run_pod(tmp_path, telemetry=True):
    from tests._pod_launch import launch_pod, pod_env

    worker = os.path.join(os.path.dirname(__file__), "_torch_pod_worker.py")
    workdir = str(tmp_path / "shared")
    outs = [str(tmp_path / f"summary{i}.json") for i in range(2)]
    launch_pod(
        worker,
        lambda i: ["2", str(i), workdir, outs[i], "20", str(int(telemetry))],
        env=pod_env(1),
        timeout=120.0,
        # a lost-port-race attempt may have part-written the shared workdir
        before_attempt=lambda: shutil.rmtree(workdir, ignore_errors=True),
    )
    per = []
    for o in outs:
        with open(o) as f:
            per.append(json.load(f))
    return workdir, per


def test_two_process_pod_matches_one_process(tmp_path):
    """Two gloo processes on the CPU over a shared workdir: ``host_share``
    splits the 6 tiles 3/3, the primary folds both event streams, the two
    event-log merges (port and JAX) agree, and the assembled rasters are
    byte-equal to a one-process run's."""
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.obs import events_path, validate_events_file
    from land_trendr_tpu_torch.runtime import (
        RunConfig,
        assemble_outputs,
        run_stack,
        stack_from_synthetic,
    )

    workdir, per = _run_pod(tmp_path)
    assert [s["tiles_done"] for s in per] == [3, 3]
    assert [s["pixels"] for s in per] == [960, 960]
    for i in range(2):
        assert validate_events_file(events_path(workdir, i, 2)) == []
    hosts = per[0]["telemetry"]["hosts"]
    assert [h["process_index"] for h in hosts] == [0, 1]
    assert all(h["status"] == "ok" for h in hosts)
    assert sum(h["tiles_done"] for h in hosts) == 6
    assert len({h["run_id"] for h in hosts}) == 1  # one pod run, one run_id
    assert "hosts" not in per[1]["telemetry"]  # the primary's fold only

    # the merge itself: port and JAX package over the same files, and the
    # merge.peer seam (a peer read as not terminal) in both
    assert mh.merge_host_event_logs(workdir, expect_hosts=2) == jax_mh.merge_host_event_logs(
        workdir, expect_hosts=2
    )
    faults.activate(faults.parse_schedule("seed=1,merge.peer%1.0"))
    jax_faults.activate(jax_faults.parse_schedule("seed=1,merge.peer%1.0"))
    try:
        partial = mh.merge_host_event_logs(workdir, expect_hosts=2, timeout_s=0.2, poll_s=0.05)
        jpartial = jax_mh.merge_host_event_logs(workdir, expect_hosts=2, timeout_s=0.2,
                                                poll_s=0.05)
    finally:
        faults.deactivate()
        jax_faults.deactivate()
    assert partial == jpartial and len(partial) == 2

    stack = stack_from_synthetic(
        make_stack(SceneSpec(width=48, height=40, year_start=1990, year_end=2013, seed=11))
    )
    kw = dict(params=PARAMS, tile_size=20)
    one = RunConfig(workdir=str(tmp_path / "one"), out_dir=str(tmp_path / "one_o"), **kw)
    run_stack(stack, one, device="cpu")
    a = assemble_outputs(stack, one, device="cpu")
    b = assemble_outputs(stack, RunConfig(workdir=workdir, out_dir=str(tmp_path / "pod_o"),
                                          **kw), device="cpu")
    for name in a:
        with open(a[name], "rb") as fa, open(b[name], "rb") as fb:
            assert fa.read() == fb.read(), name
