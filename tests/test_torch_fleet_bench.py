"""The port's ``tools/fleet_bench.py --smoke --device cpu`` at the JAX
tool's sizes: four legs (single, no-affinity, affinity, kill) over spawned
``serve`` replicas, with its invariants met — affinity's warm-hit ratio
above no-affinity, no job lost over the replica kill, and every job's
artifacts byte-identical across the legs.
"""

import json

from land_trendr_tpu_torch.tools import fleet_bench


def test_build_trace_is_the_jax_tools():
    from tools import fleet_bench as jax_fleet_bench

    for smoke in (True, False):
        assert fleet_bench.build_trace(smoke) == jax_fleet_bench.build_trace(smoke)
    assert fleet_bench._SHAPES == jax_fleet_bench._SHAPES


def test_fleet_bench_smoke_on_cpu(tmp_path, monkeypatch):
    # the spawned replicas share this worker's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "fleet.json"
    assert fleet_bench.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and all(rep["invariants"].values()), rep["invariants"]
    assert set(rep["legs"]) == {"single", "noaff", "affinity", "kill"}
    assert all(leg["jobs"] == 12 and leg["lost_jobs"] == 0 for leg in rep["legs"].values())
    assert rep["legs"]["kill"]["killed_replica"] is not None
    assert rep["workload"]["scene_big_px"] == 4 * rep["workload"]["scene_small_px"]
    assert all(v == 0 for v in rep["launches"].values())
