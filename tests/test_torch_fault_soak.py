"""The port's fault soak (``land_trendr_tpu_torch/tools/fault_soak.py``) on
the CPU: its eager and lazy tracks in ``--smoke`` mode, and its case table
held to the JAX package's soak.

The serve and router tracks run in ``tests/test_torch_fault_soak_fleet.py``
(split by track so ``--dist loadfile`` spreads them across workers).  The
coverage pin mirrors ``tests/test_faults.py``: ``SOAK_COVERED_SEAMS`` names
exactly the port's registered ``SEAMS``, and every entry is armed
(``seam@`` / ``seam%``) by some schedule in the soak's source.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from land_trendr_tpu_torch.runtime import faults
from land_trendr_tpu_torch.tools import fault_soak
from tools import fault_soak as jax_soak

torch.set_num_threads(1)

SOAK_SRC = Path(fault_soak.__file__)


def test_covered_seams_table_pins_registry_and_schedules():
    covered = fault_soak.SOAK_COVERED_SEAMS
    assert len(covered) == len(set(covered)) == 27
    assert set(covered) == set(faults.SEAMS)
    src = SOAK_SRC.read_text()
    for seam in covered:
        assert re.search(re.escape(seam) + r"[@%]", src), (
            f"SOAK_COVERED_SEAMS lists {seam!r} but no soak schedule arms it"
        )
    # the JAX soak covers the same registry
    assert set(covered) == set(jax_soak.SOAK_COVERED_SEAMS)


def _table(cases):
    return [(c.name, c.schedule, c.mode) for c in cases]


def test_case_tables_equal_the_jax_soaks():
    assert _table(fault_soak._eager_cases(2)) == _table(jax_soak._eager_cases(2))
    assert _table(fault_soak._LAZY_CASES) == _table(jax_soak._LAZY_CASES)
    # the knobs too (on the card the packed paths are forced as in JAX)
    assert [c.cfg_kw for c in fault_soak._eager_cases(2)] == [
        c.cfg_kw for c in jax_soak._eager_cases(2)]
    assert [c.cfg_kw for c in fault_soak._LAZY_CASES] == [
        c.cfg_kw for c in jax_soak._LAZY_CASES]
    assert [f.name for f in dataclasses.fields(fault_soak.Case)] == [
        f.name for f in dataclasses.fields(jax_soak.Case)]


def test_armed_parses_schedules():
    assert fault_soak._armed("seed=1,lease.expire%1.0,lease.steal@0=io") == [
        "lease.expire", "lease.steal"]
    assert fault_soak._armed("seed=2,dispatch@0*2=hang:1.0,debug.profile@0") == [
        "dispatch", "debug.profile"]


def test_error_chain_text_walks_wrapped_errors():
    try:
        try:
            raise OSError("injected fault at manifest.record#1")
        except OSError as inner:
            raise RuntimeError("tile 3 failed") from inner
    except RuntimeError as e:
        text = fault_soak._error_chain_text(e)
    assert text == "tile 3 failed | injected fault at manifest.record#1"


def test_resume_abort_books_no_seam_for_a_foreign_crash(tmp_path, monkeypatch):
    """A resume case's first-run abort counts its armed seam as fired only
    when the plan logged the seam and the error is the injected one: a
    crash from anywhere else fails the case instead of passing as
    coverage."""
    from land_trendr_tpu_torch.runtime import Run

    case = fault_soak.Case("manifest_enospc", "seed=1,manifest.record@1=enospc", {}, "resume")
    monkeypatch.setattr(fault_soak, "_eager_cases", lambda retries: [case])
    real_execute = Run.execute

    def execute(self):
        if self.cfg.fault_schedule:
            raise RuntimeError("foreign crash before any seam")
        return real_execute(self)

    monkeypatch.setattr(Run, "execute", execute)
    with pytest.raises(RuntimeError, match="foreign crash before any seam"):
        fault_soak.soak(smoke=True, keep=str(tmp_path / "soak"), verbose=False,
                        device="cpu", tracks=("eager",))


def test_soak_smoke_eager_and_lazy_tracks(tmp_path):
    from tools.check_events_schema import value_lints

    report = fault_soak.soak(smoke=True, keep=str(tmp_path / "soak"), verbose=False,
                             device="cpu", tracks=("eager", "lazy"), lint_extra=value_lints)
    assert report["ok"] is True and report["device"] == "cpu"
    cases = {(r["track"], r["case"]) for r in report["cases"]}
    assert {c.name for c in fault_soak._eager_cases(2)} <= {c for t, c in cases if t == "eager"}
    assert {c.name for c in fault_soak._LAZY_CASES} == {c for t, c in cases if t == "lazy"}
    assert {"straggler_slow", "lease_forced_steal", "merge_peer_partial",
            "tune_probe_fault", "fleet_publish_and_history_faults"} <= {c for _, c in cases}
    assert all(r["artifacts_identical"] for r in report["cases"])
    # every seam these tracks arm fired, save the packed upload's (its host
    # path exists only on a CUDA device)
    expect = {"feed", "dispatch", "compute.wait", "fetch.wait", "manifest.record",
              "manifest.torn", "lease.acquire", "lease.steal", "lease.expire",
              "merge.peer", "tune.probe", "obs.publish", "history.append",
              "feed.decode", "cache.corrupt", "store.corrupt"}
    assert set(report["seams_fired"]) == expect
    assert set(report["seams_armed"]) == expect | {"upload.wait"}
    assert fault_soak.CARD_ONLY_SEAMS == ("upload.wait",)
    assert report["eager_scene"]["tile"] == 20  # the JAX soak's CPU scene
    assert all(v == 0 for v in report["launches"].values())
