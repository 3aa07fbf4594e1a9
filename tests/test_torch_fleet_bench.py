"""The port's ``tools/fleet_bench.py --smoke --device cpu`` at the JAX
tool's sizes: four legs (single, no-affinity, affinity, kill) over spawned
``serve`` replicas, with its invariants met — affinity's warm-hit ratio
above no-affinity, no job lost over the replica kill, and every job's
artifacts byte-identical across the legs.

The router's own choice reads each replica's in-flight count, so which
replica a job lands on follows job timing, and on a loaded CPU the two
legs' warm-hit ratios can tie.  The smoke here routes in a fixed order
instead (:func:`_routing_in_a_fixed_order`); the card smoke
(``chip_smoke.py`` phase 12 e) runs the bench on the router's own choice.
"""

import json
import time

from land_trendr_tpu_torch.fleet.router import FleetRouter
from land_trendr_tpu_torch.tools import fleet_bench


def _routing_in_a_fixed_order(self, key):
    """``FleetRouter._choose_replica_locked`` made a function of the
    routing history alone: with affinity, the lowest-id ready replica
    already holding ``key``; otherwise the ready replica routed to least
    often (ties on id).  A chosen replica at its in-flight cap is waited
    for, never passed over; a replica in back-off after a failed forward
    (the kill leg) is not ready."""
    now = time.monotonic()
    ready = sorted((r for r in self.pool if r.state == "ready" and r.backoff_until <= now),
                   key=lambda r: r.rid)
    routed = self.__dict__.setdefault("_routed_by_rid", {})
    warm = [r for r in ready if key in r.warm] if self.cfg.affinity else []
    pick = warm[0] if warm else min(ready, key=lambda r: (routed.get(r.rid, 0), r.rid),
                                    default=None)
    if pick is None or len(pick.inflight) >= self.cfg.replica_inflight:
        return None, False
    routed[pick.rid] = routed.get(pick.rid, 0) + 1
    return pick, key in pick.warm


def test_build_trace_is_the_jax_tools():
    from tools import fleet_bench as jax_fleet_bench

    for smoke in (True, False):
        assert fleet_bench.build_trace(smoke) == jax_fleet_bench.build_trace(smoke)
    assert fleet_bench._SHAPES == jax_fleet_bench._SHAPES


def test_fleet_bench_smoke_on_cpu(tmp_path, monkeypatch):
    # the spawned replicas share this worker's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(FleetRouter, "_choose_replica_locked", _routing_in_a_fixed_order)
    out = tmp_path / "fleet.json"
    assert fleet_bench.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and all(rep["invariants"].values()), rep["invariants"]
    assert set(rep["legs"]) == {"single", "noaff", "affinity", "kill"}
    assert all(leg["jobs"] == 12 and leg["lost_jobs"] == 0 for leg in rep["legs"].values())
    assert rep["legs"]["kill"]["killed_replica"] is not None
    assert rep["workload"]["scene_big_px"] == 4 * rep["workload"]["scene_small_px"]
    assert all(v == 0 for v in rep["launches"].values())
