"""Start the ranks of a job as subprocesses and collect what each returns.

``spawn(world, argv)`` starts ``world`` copies of ``sys.executable argv``
with the ``TIDS_*`` variables of ``multihost.initialize`` set for each
(a ``file://`` init method in a fresh temporary directory, so that no TCP
port is picked, and races), waits for all with a wall-clock limit and
raises if any rank exits non-zero or the limit passes (every rank is then
killed). ``run_ranks(world, job, payload)`` runs ``job``, a
``"module:function"`` importable from the working directory, in each rank
as ``function(payload)`` after ``initialize``, and returns the ranks'
return values in rank order (through ``torch.save`` files).

Run as ``python -m triangulation_in_deformable_scenes_torch.parallel.launch``
it is the rank side of ``run_ranks``. Rank processes are always started
fresh, never forked from a process that has touched CUDA.
"""

from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ENV_JOB = "TIDS_JOB"
ENV_JOB_DIR = "TIDS_JOB_DIR"
ENV_DEVICE = "TIDS_DEVICE"
ENV_BACKEND = "TIDS_BACKEND"


def spawn(world: int, argv: list, env: dict | None = None, timeout: float = 300.0, cwd: str | None = None,
          workdir: str | None = None) -> list:
    """Run ``world`` ranks of ``sys.executable *argv``; returns each rank's
    (stdout, stderr). Raises RuntimeError as soon as a rank exits non-zero
    (the others would wait for it in a collective) or when ``timeout``
    seconds pass; the other ranks are killed."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="tids_ranks_")
    procs, logs = [], []
    try:
        for rank in range(world):
            e = dict(os.environ)
            e.setdefault("OMP_NUM_THREADS", "1")
            e.update(env or {})
            e.update({
                "TIDS_COORDINATOR": f"file://{os.path.join(workdir, 'init')}",
                "TIDS_NUM_PROCESSES": str(world),
                "TIDS_PROCESS_ID": str(rank),
            })
            out = open(os.path.join(workdir, f"rank{rank}.out"), "w+")
            err = open(os.path.join(workdir, f"rank{rank}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv], env=e, cwd=cwd, stdout=out, stderr=err,
                                          text=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.02)

        def text(f):
            f.flush()
            f.seek(0)
            return f.read()

        outs = [(text(o), text(e)) for o, e in logs]
        for rank, p in enumerate(procs):
            if p.returncode is None:
                continue
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} of {world} exited {p.returncode} ({argv}):\n"
                                   f"{outs[rank][0][-2000:]}\n{outs[rank][1][-4000:]}")
        if any(p.returncode is None for p in procs):
            raise RuntimeError(f"ranks of {world} did not finish within {timeout} s ({argv}):\n"
                               + "\n".join(e[-1500:] for _, e in outs))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o, e in logs:
            o.close()
            e.close()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def run_ranks(world: int, job: str, payload=None, device="cuda", backend: str | None = None,
              timeout: float = 300.0, cwd: str | None = None) -> list:
    """``job(payload)`` on ``world`` ranks on ``device`` (``backend`` as in
    ``multihost.initialize``); returns the ranks' return values."""
    workdir = tempfile.mkdtemp(prefix="tids_job_")
    try:
        torch.save(payload, os.path.join(workdir, "payload.pt"))
        env = {ENV_JOB: job, ENV_JOB_DIR: workdir, ENV_DEVICE: str(device)}
        if backend:
            env[ENV_BACKEND] = backend
        spawn(world, ["-m", __name__], env=env, timeout=timeout, cwd=cwd, workdir=workdir)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> int:
    import torch.distributed as tdist

    from . import multihost

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    multihost.initialize(device=os.environ[ENV_DEVICE], backend=os.environ.get(ENV_BACKEND))
    workdir = os.environ[ENV_JOB_DIR]
    module, _, name = os.environ[ENV_JOB].partition(":")
    fn = getattr(importlib.import_module(module), name)
    out = fn(torch.load(os.path.join(workdir, "payload.pt"), weights_only=False))
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    if tdist.is_initialized():
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
