"""Process-group setup for the domain decomposition over several
processes: one process per part, each with its own card (NCCL) or all
on the host (gloo).

Two ways in:

- :func:`init_from_env` under ``torchrun --nproc-per-node N``: reads
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``,
  and starts NCCL with ``torch.cuda.set_device(LOCAL_RANK)`` when every
  local rank has a card of its own, gloo when the caller asks for
  ``device="cpu"`` (or the ranks share a card);
- :func:`spawn` from one Python process: starts ``nprocs`` children
  (``multiprocessing`` spawn), joins them in a group through a
  ``file://`` store in a temporary directory, runs ``fn(group, device,
  *args)`` in each and returns their results in rank order. Each child
  gets the same environment as a ``torchrun`` rank (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
  ``OMP_NUM_THREADS=1`` with one torch thread, so every rank's host
  arithmetic runs alike). ``fn`` must be importable by name: a child
  imports its module, never the caller's test file.

A collective that one rank never reaches ends in an error, not a hang:
the group times out after ``pg_timeout`` seconds, and :func:`spawn`
kills every child once one fails or its wall limit passes.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch

#: seconds a collective may wait for the other ranks
PG_TIMEOUT = 120.0


def backend_for(device: str, nprocs: int) -> str:
    """NCCL when every rank can have a card of its own, else gloo (the
    host, or ranks that share one card)."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= nprocs:
        return "nccl"
    return "gloo"


def _rank_device(device: str, backend: str, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the ranks on the host")
    card = local_rank if backend == "nccl" \
        else local_rank % torch.cuda.device_count()
    torch.cuda.set_device(card)
    return torch.device("cuda", card)


def init_from_env(device: str | None = None,
                  pg_timeout: float = PG_TIMEOUT):
    """The process group of a ``torchrun`` rank (or of a :func:`spawn`
    child, which is already in one). Returns (group, device, created):
    ``created`` is False when the group already existed."""
    import torch.distributed as dist
    device = "cuda" if device is None else device
    if dist.is_initialized():
        return (dist.group.WORLD,
                _rank_device(device, dist.get_backend(),
                             int(os.environ.get("LOCAL_RANK", 0))),
                False)
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend_for(device, local_world)
    dev = _rank_device(device, backend, int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=world,
        timeout=datetime.timedelta(seconds=pg_timeout))
    return dist.group.WORLD, dev, True


def _child(rank, nprocs, store, backend, device, fn, args, results,
           pg_timeout):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dev = _rank_device(device, backend, rank)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=nprocs,
            timeout=datetime.timedelta(seconds=pg_timeout))
        try:
            out = fn(dist.group.WORLD, dev, *args)
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put(("error", rank, traceback.format_exc()))
        raise SystemExit(1)
    results.put(("ok", rank, out))


def spawn(fn, nprocs: int, backend: str, device: str = "cpu",
          args: tuple = (), wall: float = 600.0,
          pg_timeout: float = PG_TIMEOUT) -> list:
    """Run ``fn(group, device, *args)`` in ``nprocs`` new processes
    joined in one process group; return the results in rank order.

    Raises RuntimeError, with the failing rank's traceback, when a rank
    raises, dies or the ranks outlast ``wall`` seconds; every child is
    killed before it returns or raises."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    env = {"WORLD_SIZE": str(nprocs), "LOCAL_WORLD_SIZE": str(nprocs),
           "OMP_NUM_THREADS": "1"}
    saved = {k: os.environ.get(k) for k in
             ("RANK", "LOCAL_RANK", *env)}
    with tempfile.TemporaryDirectory(prefix="xfemm_pg_") as tmp:
        results = ctx.Queue()
        procs = []
        try:
            # a child inherits the environment at start(); a torchrun
            # rank's variables are set around each start only
            os.environ.update(env)
            for rank in range(nprocs):
                os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(rank)
                p = ctx.Process(
                    target=_child,
                    args=(rank, nprocs, os.path.join(tmp, "store"), backend,
                          device, fn, args, results, pg_timeout))
                p.start()
                procs.append(p)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        try:
            return _collect(procs, results, wall)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
            results.close()


def _collect(procs, results, wall: float) -> list:
    """Drain the children's results (before joining them: a child that
    has put a large result cannot exit until it is read)."""
    out: dict = {}
    deadline = time.monotonic() + wall
    dead_seen = None
    while len(out) < len(procs):
        try:
            tag, rank, val = results.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode not in (None, 0)]
            if dead and dead_seen is not None \
                    and time.monotonic() > dead_seen + 2.0:
                # no traceback came from the dead rank
                raise RuntimeError(f"rank {dead[0]} died with exit code "
                                   f"{procs[dead[0]].exitcode}") from None
            if dead and dead_seen is None:
                dead_seen = time.monotonic()
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"the ranks outlasted their wall limit of {wall:g} s "
                    f"(done: {sorted(out)})") from None
            continue
        if tag == "error":
            raise RuntimeError(f"rank {rank} failed:\n{val}")
        out[rank] = val
    return [out[r] for r in range(len(procs))]
