"""Run a function in ``k`` processes joined by a ``torch.distributed`` group.

The port's sharded plans (``ExecutionPlan(devices=k)``), ``pipeline_spmd``
and ``pipeline_forward`` run one process per device.  ``torchrun
--nproc-per-node k script.py`` starts such processes; :func:`spawn_group`
starts them from Python, with a deadline::

    from repro_torch.launch.group import spawn_group
    results = spawn_group("mypkg.mymod:body", world=2, workdir="/tmp/run1",
                          args=(64,), timeout=300)

Each rank ``r`` joins a gloo group through a ``file://`` rendezvous under
``workdir`` (no TCP port), binds ``cuda:(r % device_count)`` when a card is
visible, calls ``body(r, world, *args)`` and hands its return value back
pickled; ``results[r]`` is rank ``r``'s.  A rank that fails makes the
others be killed and :class:`GroupError` raised with each rank's exit code
and the tail of its log; a group still running at ``timeout`` seconds is
killed the same way.  Every process started is ended before the call
returns.
"""
from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional, Sequence

_CHILD = (
    "import pickle, sys\n"
    "spec = pickle.load(open(sys.argv[1], 'rb'))\n"
    "sys.path[:0] = spec['path']\n"
    "from repro_torch.launch.group import _child_main\n"
    "_child_main(spec, int(sys.argv[2]))\n")


class GroupError(RuntimeError):
    """A spawned group failed or timed out; ``exitcodes[r]`` is rank
    ``r``'s (negative: killed by that signal, at the deadline or after
    another rank failed)."""

    def __init__(self, msg: str, exitcodes: Sequence[int]):
        super().__init__(msg)
        self.exitcodes = list(exitcodes)


def _child_main(spec: dict, rank: int) -> None:
    """One rank: bind ``cuda:(rank % device_count)`` on the card, join the
    group through the ``file://`` rendezvous, run the target, pickle its
    return value."""
    import torch
    import torch.distributed as dist
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=f"file://{spec['init_file']}",
                            rank=rank, world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=spec["timeout"]))
    mod, fn = spec["target"].split(":")
    out = getattr(importlib.import_module(mod), fn)(rank, spec["world"], *spec["args"])
    with open(os.path.join(spec["dir"], f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def spawn_group(target: str, world: int, workdir: str, args: Sequence[Any] = (),
                timeout: float = 600.0, threads: Optional[int] = None) -> List[Any]:
    """Run ``target`` (``"module:function"``) on ``world`` ranks; returns
    each rank's return value.  ``timeout`` is also the group's collective
    timeout; ``threads`` sets each rank's ``torch.set_num_threads``."""
    os.makedirs(workdir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="group_", dir=workdir)
    spec = {"path": list(sys.path), "target": target, "world": int(world),
            "args": tuple(args), "timeout": float(timeout), "threads": threads, "dir": run_dir,
            "init_file": os.path.join(run_dir, "rendezvous")}
    spec_path = os.path.join(run_dir, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    logs = [os.path.join(run_dir, f"rank_{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, spec_path, str(r)],
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = timed_out = False
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            if any(c not in (None, 0) for c in codes):
                failed = True
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    codes = [p.returncode for p in procs]
    if timed_out or failed or any(codes):
        if timed_out:
            why = f"still running after {timeout:g} s"
        else:
            why = f"exit codes {codes}"
        detail = "".join(f"\n--- rank {r} (exit {c}) ---\n{_tail(logs[r])}"
                         for r, c in enumerate(codes) if c)
        raise GroupError(f"spawn_group({target!r}, world={world}): {why}{detail}", codes)
    out = []
    for r in range(world):
        with open(os.path.join(run_dir, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
