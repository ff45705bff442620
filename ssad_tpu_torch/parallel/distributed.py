"""Multi-process runs: one rank per device on ``torch.distributed``.

Counterpart of ssad_tpu/parallel/distributed.py.  JAX runs one
controller process per host over all of that host's devices;
torch.distributed runs one process, a rank, per device.  The mapping:

* ``train-multi --coordinator HOST:PORT --num-processes N --process-id i
  --local-devices L``: a world of N·L ranks.  Process i launches L local
  ranks, i·L … i·L + L − 1 (``launch_local``), and rank 0 serves the
  rendezvous store at HOST:PORT (``initialize``).  JAX's
  ``--local-devices`` provisions L virtual CPU devices in one process;
  here it is L CPU ranks.  On cards L defaults to the host's card count
  and local rank j takes ``cuda:j``; on the CPU to 1.
* ``train --data-shards N``: N local ranks on one host, the store on a
  free localhost port.
* The backend is NCCL for cards and gloo for the CPU.  A failed
  initialisation raises; nothing falls back.
* Every rank runs the same program on its own slice.  ``to_host``
  gathers Python objects in rank order, ``put_global`` broadcasts one.
* ``barrier``: a rendezvous on the store with an explicit timeout (JAX:
  the coordination service's ``wait_at_barrier``).  ``global_any``: an
  all-reduce MAX of one element, the consensus of the coordinated drain.
* JAX's ``warmup_collectives`` works around XLA's fixed ~30 s deadline
  on a device clique's first collective.  torch.distributed has no such
  deadline beyond the process group's ``timeout``, set explicitly here,
  so it has no counterpart.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import multiprocessing.connection
import os
import signal
import socket
import sys
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

#: the process group's and the barrier's timeout: process 0 may spend
#: minutes writing artifacts while the others wait
DEFAULT_TIMEOUT_S = 1200.0
#: the exit code of a drained rank (EX_TEMPFAIL, as the CLI's)
EXIT_PREEMPTED = 75

_store: Optional[dist.TCPStore] = None
_device: Optional[torch.device] = None
_barriers: dict = {}


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on localhost (bound, read, released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator: str, world: int, rank: int, device,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a world of ``world`` ranks as ``rank`` on ``device``: rank 0
    serves the store at ``coordinator`` (HOST:PORT), the others connect;
    then the process group (NCCL on a card, gloo on the CPU).  Equivalent
    to ``init_process_group(init_method="tcp://HOST:PORT")``, with the
    store kept for ``barrier``."""
    global _store, _device
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    _store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)
    dist.init_process_group(backend_for(device), store=_store, world_size=world, rank=rank,
                            timeout=timeout)
    _device = device


def shutdown() -> None:
    global _store, _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _store, _device = None, None
    _barriers.clear()


@contextlib.contextmanager
def process_group(coordinator: str, world: int, rank: int, device,
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """``initialize`` for the block, ``shutdown`` after it."""
    initialize(coordinator, world, rank, device, timeout_s)
    try:
        yield
    finally:
        shutdown()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier(name: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Hold every rank at a named rendezvous on the store, ``timeout_s``
    at most (then it raises).  No device collective: a rank that is
    still writing artifacts keeps the others alive without any deadline
    but this one.  No-op in a world of one."""
    if not is_multiprocess():
        return
    n = _barriers[name] = _barriers.get(name, 0) + 1
    key = f"ssad/barrier/{name}/{n}"
    if _store.add(key, 1) == dist.get_world_size():
        _store.set(key + "/go", "1")
    _store.wait([key + "/go"], datetime.timedelta(seconds=timeout_s))


def global_any(flag: bool) -> bool:
    """OR of every rank's ``flag`` at a lockstep point (an all-reduce MAX
    of one element): every rank takes the same branch.  A world of one:
    the flag."""
    if not is_multiprocess():
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=_device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0.0)


def to_host(obj: Any, everywhere: bool = True) -> Optional[List[Any]]:
    """Every rank's ``obj`` in rank order: on every rank, or with
    ``everywhere`` False on rank 0 only (None elsewhere).  A world of one:
    ``[obj]``."""
    if not is_multiprocess():
        return [obj]
    out = [None] * dist.get_world_size()
    if everywhere:
        dist.all_gather_object(out, obj)
        return out
    dist.gather_object(obj, out if dist.get_rank() == 0 else None, dst=0)
    return out if dist.get_rank() == 0 else None


def put_global(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if not is_multiprocess():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def local_rank_device(kind, local_rank: int) -> torch.device:
    """Local rank j's device: ``cuda:j`` on cards, the CPU otherwise."""
    if torch.device(kind).type == "cuda":
        return torch.device("cuda", local_rank)
    return torch.device("cpu")


def _run_rank(target: Callable, rank: int, args: tuple) -> None:
    sys.exit(target(rank, *args))


def launch_local(target: Callable[..., int], n_local: int, first_rank: int = 0,
                 args: tuple = ()) -> int:
    """Run ``target(rank, *args)`` for the local ranks ``first_rank`` …
    ``first_rank + n_local − 1`` → one exit code.  One rank runs in this
    process; more run in spawned processes (``target`` must be importable
    by name), a SIGTERM to this process is passed on to each of them, and
    when one fails the others are stopped (they would wait in a
    collective).  The code: 0 when every rank returned 0, 75 when they
    drained, else the first failure's."""
    if n_local == 1:
        return int(target(first_rank, *args) or 0)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_run_rank, args=(target, first_rank + j, args))
             for j in range(n_local)]
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    prev = signal.signal(signal.SIGTERM, forward)
    try:
        pending = {p.sentinel: p for p in procs}
        failed = None
        while pending:
            for s in multiprocessing.connection.wait(list(pending)):
                p = pending.pop(s)
                p.join()
                if p.exitcode not in (0, EXIT_PREEMPTED) and failed is None:
                    failed = p.exitcode
                    for q in pending.values():
                        q.terminate()
        codes = [p.exitcode for p in procs]
    finally:
        signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.is_alive():
                p.kill()
    if failed is not None:
        return failed if failed > 0 else 1
    return EXIT_PREEMPTED if EXIT_PREEMPTED in codes else 0
