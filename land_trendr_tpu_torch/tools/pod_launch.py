"""The one launcher of the port's true multi-process runs (a pod of
``torch.distributed`` processes on localhost): the chip smoke's phase 9
pod and :mod:`~land_trendr_tpu_torch.tools.multihost_bench` both start
their workers here.

Counterpart of the JAX package's ``tests/_pod_launch.py``: the free-port
pick, the reaping (no worker outlives a failure or a timeout) and the
retry of a lost port race live in one place.  The bind/close/reuse port
pick is a race — another process can take the port between the probe's
``close()`` and worker 0's bind — so that failure retries on a fresh
port; any other failure raises with the worker's stderr tail.
"""

from __future__ import annotations

import socket
import subprocess
from typing import Callable, Sequence

__all__ = ["PodBindRace", "free_coordinator", "launch_pod", "reap"]


class PodBindRace(RuntimeError):
    """A worker lost the free-port race; retry on a fresh port."""


def free_coordinator() -> str:
    """``localhost:<port>`` of a port that was free a moment ago."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return f"localhost:{sk.getsockname()[1]}"


def reap(procs: list, timeout: float) -> "list[tuple[str, str]]":
    """Wait for every process (stdout, stderr); on a timeout or a failure
    kill the rest, so no process outlives the caller."""
    results = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"process {p.args[:6]} timed out after {timeout:.0f}s")
            if p.returncode != 0:
                if "address already in use" in err.lower():
                    raise PodBindRace(f"process {p.args[:6]} lost the port race:\n{err[-3000:]}")
                raise RuntimeError(f"process {p.args[:6]} exited {p.returncode}:\n{err[-3000:]}")
            results.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def launch_pod(
    argv_for: Callable[[str, int], Sequence[str]],
    env: dict,
    n: int = 2,
    timeout: float = 300.0,
    attempts: int = 3,
    before_attempt: "Callable[[], None] | None" = None,
) -> "list[tuple[str, str]]":
    """Run ``n`` workers to completion against a coordinator on a free
    localhost port; ``argv_for(coordinator, i)`` is worker ``i``'s full
    command.  ``before_attempt`` (e.g. resetting a shared workdir that a
    failed attempt may have written) runs before every attempt.  Returns
    each worker's (stdout, stderr)."""
    for attempt in range(attempts):
        if before_attempt is not None:
            before_attempt()
        coordinator = free_coordinator()
        procs = [
            subprocess.Popen([str(a) for a in argv_for(coordinator, i)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(n)
        ]
        try:
            return reap(procs, timeout=timeout)
        except PodBindRace:
            if attempt == attempts - 1:
                raise
    raise AssertionError("unreachable")
