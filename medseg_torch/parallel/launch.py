"""Start N ranks of a command on this host and wait for them, with a time
limit: the launcher of the multi-process tools, smoke phases and tests.

Each rank is ``python <args>`` with ``MEDSEG_COORDINATOR`` set to a
``file://`` rendezvous in a fresh directory (no port to pick or to collide
on), ``MEDSEG_NUM_PROCESSES`` and ``MEDSEG_PROCESS_ID``, which
``runtime.initialize_distributed`` reads. Its output goes to files there
(no pipe to fill). If a rank fails or the time runs out, every rank still
running is killed and the error carries each rank's exit code and the end
of its output, so that a hung collective fails the caller instead of
hanging it.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str


def _tail(text: str, n: int = 3000) -> str:
    return text if len(text) <= n else "..." + text[-n:]


def run_ranks(args: list[str], world: int, *, timeout: float, env: dict | None = None,
              cwd: str | None = None, workdir: str | None = None) -> list[RankResult]:
    """Runs ``python *args`` as ranks 0 .. world - 1 and returns their
    results; raises ``RuntimeError`` if one exits non-zero or the ranks do
    not all end within ``timeout`` seconds. ``env`` adds to this process's
    environment; ``workdir`` (default: a new temporary directory, removed
    at the end) holds the rendezvous file and the ranks' output."""
    own_tmp = workdir is None
    workdir = tempfile.mkdtemp(prefix="medseg_ranks_") if own_tmp else workdir
    os.makedirs(workdir, exist_ok=True)
    rendezvous = os.path.join(workdir, f"rendezvous.{os.getpid()}.{time.monotonic_ns()}")
    procs, files = [], []
    try:
        for rank in range(world):
            rank_env = dict(os.environ, **(env or {}))
            rank_env.update(MEDSEG_COORDINATOR=f"file://{rendezvous}",
                            MEDSEG_NUM_PROCESSES=str(world), MEDSEG_PROCESS_ID=str(rank))
            out = open(os.path.join(workdir, f"rank{rank}.out"), "w+")
            err = open(os.path.join(workdir, f"rank{rank}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *args], env=rank_env, cwd=cwd,
                                          stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        timed_out = False
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                timed_out = not failed
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, files)):
        out.seek(0)
        err.seek(0)
        results.append(RankResult(rank, p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    if own_tmp:
        shutil.rmtree(workdir, ignore_errors=True)
    if timed_out or any(r.returncode != 0 for r in results):
        what = f"did not end within {timeout:.0f} s" if timed_out else "failed"
        detail = "\n".join(f"--- rank {r.rank}: exit {r.returncode}\nstdout: {_tail(r.stdout)}\n"
                           f"stderr: {_tail(r.stderr)}" for r in results)
        raise RuntimeError(f"{world} ranks of {args} {what}:\n{detail}")
    return results
