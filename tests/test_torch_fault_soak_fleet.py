"""The port's fault soak on the CPU, serve and router tracks (``--smoke``):
the server seams (``serve.submit``, ``serve.job``, ``debug.profile``,
``batch.pack``, ``batch.demux``), the in-process router seams
(``router.forward``, ``replica.health``, ``router.journal``,
``router.recover``) and the ``loadgen.tick`` churn case over two spawned
``serve --device cpu`` replicas, each byte-identical to a clean run.
"""

import torch

from land_trendr_tpu_torch.tools import fault_soak

torch.set_num_threads(1)


def test_soak_smoke_serve_and_router_tracks(tmp_path, monkeypatch):
    from tools.check_events_schema import value_lints

    # the spawned replicas share this worker's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    report = fault_soak.soak(smoke=True, keep=str(tmp_path / "soak"), verbose=False,
                             device="cpu", tracks=("serve", "router"), lint_extra=value_lints)
    assert report["ok"] is True
    cases = [(r["track"], r["case"]) for r in report["cases"]]
    assert cases == [
        ("serve", "submit_reject_and_sibling_quarantine"),
        ("serve", "debug_stacks_under_hang_and_profile_fault"),
        ("serve", "job_fault_then_resubmit"),
        ("serve", "batch_pack_and_demux_faults"),
        ("router", "forward_fault_rerouted"),
        ("router", "health_fault_unready_job_survives"),
        ("router", "journal_fault_503_then_resubmit"),
        ("router", "recover_probe_fault_requeued_resume"),
        ("router", "loadgen_tick_churn_sigkill"),
    ]
    assert all(r["artifacts_identical"] for r in report["cases"])
    assert set(report["seams_fired"]) == {
        "serve.submit", "dispatch", "debug.profile", "serve.job", "batch.pack",
        "batch.demux", "router.forward", "replica.health", "router.journal",
        "router.recover", "loadgen.tick"}
    churn = report["cases"][-1]
    assert churn["done"] == 6 and churn["replay_match"] is True
    # the surviving replica answered /debug/kernels (the CPU launches none)
    assert churn["survivor_launches"]
    assert all(v == 0 for c in churn["survivor_launches"].values() for v in c.values())
