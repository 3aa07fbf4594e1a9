"""The port's fault injector against the JAX package's: the same seams,
default kinds and grammar, and the same firing sequence for the same
schedule over 200 invocations of every seam."""

import errno

import numpy as np
import pytest

from land_trendr_tpu.runtime import faults as jfaults
from land_trendr_tpu_torch.runtime import faults

N_CALLS = 200


def test_seams_and_default_kinds_equal():
    assert faults.SEAMS == jfaults.SEAMS
    assert faults._DEFAULT_KIND == jfaults._DEFAULT_KIND
    assert faults._RAISING_KINDS == jfaults._RAISING_KINDS


def _fire_sequence(mod, schedule: str, seam: str) -> list:
    """What each of N_CALLS invocations of ``seam`` did under ``schedule``:
    the exception class and message, True/False for a behavioral seam, or
    the damaged length for a corruption seam."""
    plan = mod.parse_schedule(schedule)
    kind = mod._DEFAULT_KIND[seam]
    out = []
    for _ in range(N_CALLS):
        if kind == "fire":
            out.append(plan.fired(seam))
        elif kind == "corrupt":
            out.append(int(plan.corrupt(seam, np.arange(8)).size))
        else:
            try:
                plan.check(seam)
                out.append(None)
            except Exception as e:
                out.append((type(e).__name__, str(e), getattr(e, "errno", None)))
    return out + [plan.injected(), plan.counts()]


@pytest.mark.parametrize("seam", jfaults.SEAMS)
def test_same_schedule_fires_identically(seam):
    schedule = f"seed=7,{seam}%0.3,{seam}@5*3"
    ours = _fire_sequence(faults, schedule, seam)
    theirs = _fire_sequence(jfaults, schedule, seam)
    assert ours == theirs
    # the schedule really fired, at the scheduled indices among others
    injected = ours[-2]
    assert {5, 6, 7} <= {i for _s, i, _k in injected}
    assert 20 < len(injected) < 120


@pytest.mark.parametrize(
    "text",
    [
        "seed=9,dispatch@1,fetch.wait@0*3=io,feed%0.5=slow:0.2",
        "compute.wait@1=hang:30,manifest.torn@2",
        "seed=3,feed.decode%0.25=value,store.corrupt@0,cache.corrupt%1.0",
        "upload.wait@0*2=enospc, manifest.record@4=io",
    ],
)
def test_grammar_parses_identically(text):
    ours, theirs = faults.parse_schedule(text), jfaults.parse_schedule(text)
    assert ours.seed == theirs.seed
    assert [tuple(s) for s in ours.specs] == [tuple(s) for s in theirs.specs]


@pytest.mark.parametrize(
    "bad",
    ["dispatchh@1", "dispatch", "feed.decode%25", "dispatch@-1", "dispatch@0*0",
     "fetch.wait@0=boom", "seed=x,feed@1"],
)
def test_typos_rejected_by_both(bad):
    with pytest.raises(ValueError):
        jfaults.parse_schedule(bad)
    with pytest.raises(ValueError):
        faults.parse_schedule(bad)


def test_error_kinds_raise_realistic_classes():
    plan = faults.parse_schedule("feed@0=io,feed@1=enospc,feed@2=value,feed@3=runtime")
    seen = []
    for _ in range(4):
        with pytest.raises(Exception) as ei:
            plan.check("feed")
        seen.append(ei.value)
    assert type(seen[0]) is OSError and seen[1].errno == errno.ENOSPC
    assert isinstance(seen[2], ValueError) and isinstance(seen[3], faults.FaultInjected)


def test_slow_proceeds_and_module_seams_follow_activation():
    plan = faults.parse_schedule("dispatch@0=slow:0.01")
    faults.check("dispatch")  # inert without an active plan
    assert not faults.fired("manifest.torn")
    faults.activate(plan)
    try:
        faults.check("dispatch")  # slow: sleeps, then proceeds
        from land_trendr_tpu_torch.io import blockcache

        assert blockcache._fault_plan is plan
    finally:
        faults.deactivate()
    assert plan.injected() == [("dispatch", 0, "slow")]
    assert blockcache._fault_plan is None
