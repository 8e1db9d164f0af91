"""Start the ranks of a gloo group (port-only: the counterpart of the
reference's fake host devices, ``--xla_force_host_platform_device_count``).

``run(n, fn, args, device=...)`` makes the caller rank 0 and starts ranks
1 .. n-1 as processes of the ``spawn`` start method. Every rank joins one
**gloo** group through a ``FileStore`` in a fresh temporary directory (no
TCP port, so runs side by side never collide) with a finite ``timeout``, so
a rank whose partner died raises instead of waiting for ever. Every rank
runs on ``device`` (``cuda:0`` when all ranks share one card, ``cpu`` when
asked for): the ranks' tensors stay on it, and only what a collective
carries goes through host memory, which gloo's point-to-point operations
need. A rank that raises, dies or misses the deadline makes ``run`` raise:
nothing carries on with fewer ranks.

gloo is the only backend here. NCCL, with device-to-device exchange, needs
a card per rank.
"""
from __future__ import annotations

import datetime
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600.0        # the group's collectives and the wait for the ranks
GRACE_S = 10.0           # after a failure, the wait for the other ranks' reports


def _join(rank: int, n: int, store_path: str, device: str, timeout: float) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, n), rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout))


def _rank_main(rank: int, n: int, store_path: str, device: str, timeout: float,
               threads: int, fn: Callable, args: Sequence, ready, results) -> None:
    """Entry point of a spawned rank: say it started (its imports and
    arguments came through), take the caller's CPU thread count (CPU
    factorizations give the same bits only at the same count), join, run
    ``fn(*args)``, send back its result (pickled here, so the rank owes the
    caller nothing once it has exited) or its traceback."""
    ready.put(rank)
    torch.set_num_threads(threads)
    try:
        _join(rank, n, store_path, device, timeout)
        out = (None, pickle.dumps(fn(*args)))
    except BaseException:                       # reported to the caller
        out = (traceback.format_exc(), None)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank,) + out)


def _wait_started(procs, ready, deadline: float) -> List[str]:
    """Wait until every spawned rank has said it started; a rank that dies
    while it starts (an import error, say) fails the run here, not after
    rank 0 has waited out the rendezvous."""
    pending = set(range(1, len(procs) + 1))
    while pending:
        try:
            pending.discard(ready.get(timeout=1.0))
        except queue_lib.Empty:
            dead = sorted(r for r in pending if not procs[r - 1].is_alive())
            if dead:
                return [f"ranks {dead} died while starting (exit codes "
                        f"{[procs[r - 1].exitcode for r in dead]})"]
            if time.monotonic() > deadline:
                return [f"ranks {sorted(pending)} did not start"]
    return []


def _collect(procs, results, outs: List[Any], failures: List[str],
             deadline: float) -> None:
    """Every spawned rank's report into ``outs`` / ``failures``; once one
    rank failed, the others get GRACE_S to report theirs (the cause is often
    theirs)."""
    pending = set(range(1, len(procs) + 1))
    until = deadline if not failures else time.monotonic() + GRACE_S
    while pending:
        try:
            rank, err, payload = results.get(timeout=1.0)
        except queue_lib.Empty:
            dead = sorted(r for r in pending if not procs[r - 1].is_alive())
            if dead:
                failures.append(f"ranks {dead} exited without a result (exit "
                                f"codes {[procs[r - 1].exitcode for r in dead]})")
                pending.difference_update(dead)
            elif time.monotonic() > until:
                failures.append(f"ranks {sorted(pending)} did not finish")
                return
        else:
            pending.discard(rank)
            if err is not None:
                failures.append(f"rank {rank}:\n{err}")
            else:
                outs[rank] = pickle.loads(payload)
        if failures:
            until = min(until, time.monotonic() + GRACE_S)


def run(n: int, fn: Callable, args: Sequence = (), *, device: str,
        rank0: Optional[Callable[[], Any]] = None,
        timeout: float = TIMEOUT_S) -> List[Any]:
    """Run on ``n`` ranks of one gloo group and return their results in
    rank order. Ranks 1 .. n-1 are spawned processes that call
    ``fn(*args)`` (``fn`` importable by name, its result picklable); rank 0
    is the caller and calls ``rank0()``, or ``fn(*args)`` without it. Each
    rank finds its place through ``torch.distributed.get_rank()``. Raises
    RuntimeError, with the failing ranks' tracebacks, when a rank raises,
    dies or has not finished ``timeout`` seconds after the start; the
    other ranks are then stopped. The caller's ``__main__`` must be
    importable without side effects (the ``spawn`` start method imports
    it in every rank)."""
    if n < 1:
        raise ValueError(f"run: {n} ranks")
    if dist.is_initialized():
        raise RuntimeError("run: this process is already in a process group")
    tmp = tempfile.mkdtemp(prefix="repro_gloo_")
    store_path = str(Path(tmp) / "store")
    ctx = mp.get_context("spawn")
    ready, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, store_path, device, timeout,
                               torch.get_num_threads(), fn, args, ready, results))
             for r in range(1, n)]
    deadline = time.monotonic() + timeout
    outs: List[Any] = [None] * n
    try:
        for p in procs:
            p.start()
        failures = _wait_started(procs, ready, deadline)
        if not failures:
            try:
                _join(0, n, store_path, device, timeout)
                outs[0] = rank0() if rank0 is not None else fn(*args)
            except BaseException:
                failures.append(f"rank 0:\n{traceback.format_exc()}")
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
            _collect(procs, results, outs, failures, deadline)
        for p in procs:
            p.join(timeout=1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        ready.close()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise RuntimeError(f"{len(failures)} of {n} ranks failed:\n" + "\n".join(failures))
    return outs
