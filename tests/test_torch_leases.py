"""The port's elastic tile lease queue (``runtime/leases.py``) and its
driver integration, held against the JAX package's.

The lease protocol is pure file I/O, so two :class:`LeaseQueue` instances
over one manifest path ARE two hosts: the protocol cases drive claim,
steal, renew, flag and speculation races in milliseconds.  The interop
case alternates a port queue and a JAX package queue over one manifest
and requires them to agree on every claim.  The driver case runs one
elastic ``run_stack`` against the static split, byte for byte, with the
event and rollup contract.
"""

import json
import os
import time

import numpy as np
import pytest

from land_trendr_tpu.runtime.leases import LeaseQueue as JaxLeaseQueue
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.runtime import RunConfig, TileManifest, faults
from land_trendr_tpu_torch.runtime.leases import LeaseQueue

PARAMS = LTParams(max_segments=4, vertex_count_overshoot=2)


@pytest.fixture(scope="module")
def rstack():
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.runtime import stack_from_synthetic

    return stack_from_synthetic(
        make_stack(SceneSpec(width=48, height=40, year_start=1990, year_end=2013, seed=11))
    )


def _manifest(tmp_path):
    path = str(tmp_path / "manifest.jsonl")
    with open(path, "w") as f:
        f.write('{"kind":"header","fingerprint":"fp","run_id":"r1"}\n')
    return path


def _q(path, owner, ttl=5.0, n=4, done0=None, cls=LeaseQueue):
    return cls(path, range(n), ttl_s=ttl, owner=owner, done0=done0)


def _append(path, *recs):
    with open(path, "a") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")


# ---------------------------------------------------------------------------
# protocol cases (two queues = two hosts)
# ---------------------------------------------------------------------------


def test_claims_partition_without_overlap(tmp_path):
    path = _manifest(tmp_path)
    a, b = _q(path, "h1:1:a"), _q(path, "h2:2:b")
    wa, wb = a.acquire(2), b.acquire(2)
    ids_a, ids_b = {t for t, _, _ in wa}, {t for t, _, _ in wb}
    assert all(m == "claim" for _, m, _ in wa + wb)
    assert ids_a | ids_b == {0, 1, 2, 3}
    assert not ids_a & ids_b


def test_same_generation_race_first_writer_wins(tmp_path):
    path = _manifest(tmp_path)
    a, b = _q(path, "h1:1:a", n=1), _q(path, "h2:2:b", n=1)
    rec = {"kind": "lease", "tile_id": 0, "gen": 0, "ttl_s": 5.0,
           "t_wall": time.time(), "mode": "claim"}
    _append(path, {**rec, "owner": "h1:1:a"}, {**rec, "owner": "h2:2:b"})
    assert b.acquire(1) == []  # b's own record lost (a's is first)
    a.refresh()
    with a._lock:
        assert a._leases[0].owner == "h1:1:a"


def test_expired_lease_is_stolen_and_renewal_prevents_it(tmp_path):
    path = _manifest(tmp_path)
    a, b = _q(path, "h1:1:a", ttl=0.2), _q(path, "h2:2:b", ttl=0.2)
    a.acquire(2)
    b.acquire(2)
    time.sleep(0.3)
    a.renew(min_interval=0.0)  # a's leases live on; b's expire
    stolen = a.acquire(4)
    assert {m for _, m, _ in stolen} == {"steal"}
    assert len(stolen) == 2 and a.stats()["stolen"] == 2
    assert all(lease.gen == 1 for _, _, lease in stolen)


def test_done_record_supersedes_every_lease(tmp_path):
    path = _manifest(tmp_path)
    a = _q(path, "h1:1:a", ttl=0.01, n=2)
    a.acquire(2)
    _append(path, {"kind": "tile", "tile_id": 0, "owner": "h1:1:a"})
    time.sleep(0.05)
    a.refresh()
    assert 0 not in {t for t, _, _ in a.acquire(2)}
    # a late joiner seeds done0 from the manifest's artifact-verified set
    b = _q(path, "h2:2:b", ttl=0.01, n=2, done0={0})
    assert {t for t, _, _ in b.acquire(2)} == {1}
    assert not b.run_complete()
    _append(path, {"kind": "tile", "tile_id": 1, "owner": "h2:2:b"})
    assert b.run_complete()


def test_release_makes_tiles_immediately_claimable(tmp_path):
    path = _manifest(tmp_path)
    a, b = _q(path, "h1:1:a", ttl=60.0, n=2), _q(path, "h2:2:b", ttl=60.0, n=2)
    a.acquire(2)
    assert b.acquire(2) == []  # all leased, TTL far away
    assert a.release_held("aborted") == 2
    won = b.acquire(2)
    assert len(won) == 2 and all(m == "claim" for _, m, _ in won)


def test_flag_enables_speculation_for_idle_peer_only(tmp_path):
    path = _manifest(tmp_path)
    a, b = _q(path, "h1:1:a", ttl=60.0, n=2), _q(path, "h2:2:b", ttl=60.0, n=2)
    a.acquire(2)
    assert b.acquire(1, speculate=True) == []  # nothing flagged yet
    assert a.flag(1) is True
    won = b.acquire(1, speculate=True)
    assert [(t, m) for t, m, _ in won] == [(1, "spec")] and won[0][2].gen == 1
    assert a.flag(0) is True
    assert len(b.acquire(4, speculate=True)) <= 1  # one speculative claim per call
    _append(path, {"kind": "tile", "tile_id": 1, "owner": "h2:2:b"},
            {"kind": "tile", "tile_id": 1, "owner": "h1:1:a"})
    b.refresh()
    assert b.stats()["spec_wins"] == 1


def test_flag_requires_holding_the_lease(tmp_path):
    path = _manifest(tmp_path)
    a, b = _q(path, "h1:1:a", n=2), _q(path, "h2:2:b", n=2)
    a.acquire(1)
    assert b.flag(0) is False  # not b's lease
    assert b.flag(1) is False  # nobody holds it


def test_torn_trailing_line_is_carried_not_fatal(tmp_path):
    path = _manifest(tmp_path)
    a = _q(path, "h1:1:a")
    with open(path, "a") as f:
        f.write('{"kind":"lease","tile_id"')  # a peer died mid-append
    a.refresh()
    assert a.stats()["malformed_lines"] == 0  # carried, not condemned
    won = a.acquire(4)
    won2 = a.acquire(4)
    assert {t for t, _, _ in won} | {t for t, _, _ in won2} == {0, 1, 2, 3}
    assert a.stats()["malformed_lines"] == 1  # the mashed line, counted


def test_lease_expire_fault_forces_steal_under_living_owner(tmp_path):
    path = _manifest(tmp_path)
    a, b = _q(path, "h1:1:a", ttl=60.0, n=1), _q(path, "h2:2:b", ttl=60.0, n=1)
    a.acquire(1)
    faults.activate(faults.parse_schedule("seed=1,lease.expire@0"))
    try:
        won = b.acquire(1)
    finally:
        faults.deactivate()
    assert [(t, m) for t, m, _ in won] == [(0, "steal")]


def test_lease_acquire_fault_raises(tmp_path):
    path = _manifest(tmp_path)
    a = _q(path, "h1:1:a")
    faults.activate(faults.parse_schedule("seed=1,lease.acquire@0=io"))
    try:
        with pytest.raises(OSError):
            a.acquire(2)
        assert len(a.acquire(2)) == 2  # the next invocation proceeds
    finally:
        faults.deactivate()


def test_failed_record_is_terminal_this_run_only(tmp_path):
    path = _manifest(tmp_path)
    _append(path, {"kind": "tile_failed", "tile_id": 0, "attempts": 3, "error": "x"})
    a = _q(path, "h1:1:a", n=2)
    assert {t for t, _, _ in a.acquire(2)} == {0, 1}  # history does not block
    _append(path, {"kind": "tile_failed", "tile_id": 1, "attempts": 3, "error": "x"})
    a.refresh()
    assert a.stats()["failed"] == 1
    assert not a.run_complete()
    _append(path, {"kind": "tile", "tile_id": 0, "owner": "h1:1:a"})
    assert a.run_complete()


# ---------------------------------------------------------------------------
# interop: one manifest, a port queue and a JAX package queue
# ---------------------------------------------------------------------------


def test_port_and_jax_queues_agree_on_every_claim(tmp_path):
    """Alternating claims, a steal after expiry, a flag and a speculative
    re-lease: after every step both queues' views of every tile's lease
    (generation, owner, flag) and of the done set are identical."""
    path = _manifest(tmp_path)
    n = 6
    port = _q(path, "port:1:p", ttl=0.3, n=n)
    ref = _q(path, "jax:2:j", ttl=0.3, n=n, cls=JaxLeaseQueue)

    def views():
        out = []
        for q in (port, ref):
            q.refresh()
            with q._lock:
                out.append((
                    {t: (lz.gen, lz.owner, lz.flagged, lz.released)
                     for t, lz in q._leases.items()},
                    set(q._done),
                ))
        return out

    for _ in range(3):
        for q in (port, ref):
            q.acquire(1)
            a, b = views()
            assert a == b
    assert {lz[1] for lz in views()[0][0].values()} == {"port:1:p", "jax:2:j"}
    flagged = sorted(ref.held())[0]
    assert ref.flag(flagged) is True
    spec = port.acquire(1, speculate=True)
    assert [(t, m) for t, m, _ in spec] == [(flagged, "spec")]
    a, b = views()
    assert a == b and a[0][flagged][:2] == (1, "port:1:p")
    _append(path, {"kind": "tile", "tile_id": 0, "owner": "port:1:p"})
    time.sleep(0.35)
    port.renew(min_interval=0.0)  # the port's leases live on; the JAX queue's expire
    stolen = port.acquire(6)
    assert stolen and {m for _, m, _ in stolen} == {"steal"}
    a, b = views()
    assert a == b and 0 in a[1]
    assert all(a[0][t][:2] == (1, "port:1:p") for t, _, _ in stolen)


# ---------------------------------------------------------------------------
# driver integration
# ---------------------------------------------------------------------------


def _tile_arrays(workdir):
    man = TileManifest(workdir, "")
    out = {}
    for r in man.iter_records():
        if r.get("kind") == "tile":
            with np.load(man.tile_path(r["tile_id"])) as z:
                out[r["tile_id"]] = {k: z[k].tobytes() for k in z.files}
    return out


def test_elastic_run_matches_static_and_reports(tmp_path, rstack):
    from land_trendr_tpu_torch.obs.events import iter_events, validate_events_file
    from land_trendr_tpu_torch.runtime import assemble_outputs, run_stack

    kw = dict(params=PARAMS, tile_size=20, retry_backoff_s=0.0)
    static = RunConfig(workdir=str(tmp_path / "s"), out_dir=str(tmp_path / "so"), **kw)
    run_stack(rstack, static, device="cpu")
    elastic = RunConfig(workdir=str(tmp_path / "e"), out_dir=str(tmp_path / "eo"),
                        lease_batch=2, lease_ttl_s=10.0, telemetry=True, **kw)
    summary = run_stack(rstack, elastic, device="cpu")
    lease = summary["lease"]
    assert lease["acquired"] == summary["tiles"] == 6
    assert lease["stolen"] == 0 and lease["speculated"] == 0
    assert summary["tiles_stolen"] == 0 and summary["tiles_speculated"] == 0
    events = list(iter_events(os.path.join(elastic.workdir, "events.jsonl")))
    leased = [e for e in events if e["ev"] == "tile_leased"]
    assert len(leased) == 6 and all(e["gen"] == 0 for e in leased)
    run_done = [e for e in events if e["ev"] == "run_done"][-1]
    assert run_done["tiles_stolen"] == 0 and run_done["tiles_speculated"] == 0
    assert validate_events_file(os.path.join(elastic.workdir, "events.jsonl")) == []
    owners = {r.get("owner") for r in TileManifest(elastic.workdir, "").iter_records()
              if r.get("kind") == "tile"}
    assert len(owners) == 1 and None not in owners
    # byte for byte: tile artifacts and assembled rasters
    assert _tile_arrays(elastic.workdir) == _tile_arrays(static.workdir)
    a = assemble_outputs(rstack, static, device="cpu")
    b = assemble_outputs(rstack, elastic, device="cpu")
    for name in a:
        with open(a[name], "rb") as fa, open(b[name], "rb") as fb:
            assert fa.read() == fb.read(), name


def test_elastic_run_steals_a_dead_peers_leases(tmp_path, rstack):
    """A peer died holding two leases: the ``lease.expire`` seam reads them
    as expired, the run steals them (gen 1) and every tile lands."""
    from land_trendr_tpu_torch.runtime import run_stack

    cfg = RunConfig(params=PARAMS, tile_size=20, workdir=str(tmp_path / "w"),
                    out_dir=str(tmp_path / "o"), lease_batch=2, lease_ttl_s=600.0,
                    fault_schedule="seed=1,lease.expire%1.0")
    man = TileManifest(cfg.workdir, cfg.fingerprint(rstack),
                       context={"mesh_devices": 1, "impl": "torch"})
    man.open(resume=True)
    dead = LeaseQueue(man.path, range(6), ttl_s=600.0, owner="dead:1:peer")
    assert len(dead.acquire(2)) == 2
    summary = run_stack(rstack, cfg, device="cpu")
    assert summary["lease"]["stolen"] == 2 and summary["lease"]["acquired"] == 6
    assert summary["tiles_done"] == 6


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(speculate=True), "speculate requires lease_batch"),
        (dict(lease_batch=1, lease_ttl_s=0.0), "lease_ttl_s"),
        (dict(lease_batch=-1), "lease_batch"),
        (dict(merge_timeout_s=0.0), "merge_timeout_s"),
    ],
)
def test_lease_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        RunConfig(**kw)


def test_elastic_run_speculates_a_flagged_straggler(tmp_path, rstack):
    """A live peer holds tile 0 and flags it as a straggler: an idle run
    with ``speculate`` claims every free tile, then re-leases tile 0 at
    generation 1; its done record lands first, so the win is its own."""
    from land_trendr_tpu_torch.runtime import run_stack

    cfg = RunConfig(params=PARAMS, tile_size=20, workdir=str(tmp_path / "w"),
                    out_dir=str(tmp_path / "o"), lease_batch=2, lease_ttl_s=600.0,
                    speculate=True)
    man = TileManifest(cfg.workdir, cfg.fingerprint(rstack),
                       context={"mesh_devices": 1, "impl": "torch"})
    man.open(resume=True)
    peer = LeaseQueue(man.path, range(6), ttl_s=600.0, owner="slow:1:peer")
    assert [t for t, _, _ in peer.acquire(1)] == [0] and peer.flag(0)
    summary = run_stack(rstack, cfg, device="cpu")
    lease = summary["lease"]
    assert lease["speculated"] == 1 and lease["acquired"] == 6 and lease["stolen"] == 0
    assert lease["spec_wins"] == 1 and summary["tiles_done"] == 6


def test_aborted_elastic_run_releases_its_leases(tmp_path, rstack):
    """A run that dies with claims in hand appends ``lease_release`` for
    them, so a peer claims them at once (generation 1, mode claim) instead
    of waiting out the TTL."""
    from land_trendr_tpu_torch.runtime import TileRetriesExhausted, run_stack

    cfg = RunConfig(params=PARAMS, tile_size=20, workdir=str(tmp_path / "w"),
                    out_dir=str(tmp_path / "o"), lease_batch=2, lease_ttl_s=600.0,
                    max_retries=0, fault_schedule="seed=1,dispatch@1")
    with pytest.raises(TileRetriesExhausted):
        run_stack(rstack, cfg, device="cpu")
    recs = list(TileManifest(cfg.workdir, "").iter_records())
    released = {r["tile_id"] for r in recs if r.get("kind") == "lease_release"}
    done = {r["tile_id"] for r in recs if r.get("kind") == "tile"}
    # every unfinished claim is released (a release of a tile whose done
    # record the queue had not yet re-read is harmless: done supersedes it)
    assert done and released >= set(range(6)) - done
    peer = LeaseQueue(os.path.join(cfg.workdir, "manifest.jsonl"), range(6), ttl_s=600.0,
                      owner="peer:2:p", done0=done)
    won = peer.acquire(6)
    assert {t for t, _, _ in won} == set(range(6)) - done
    assert all(m == "claim" for _, m, _ in won)
