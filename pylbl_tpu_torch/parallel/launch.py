"""Starts a group of ranks on this host and runs functions on all of them
(counterpart of tools/distributed_worker.py of the JAX package).

::

    from pylbl_tpu_torch.parallel import launch

    def work(n):                  # module level: the ranks import it
        mesh = make_mesh(batch=2, spec=2, device="cpu")
        ...
        return result

    out = launch.launch(work, 4, 16)            # rank 0's result

    with launch.RankGroup(4) as group:          # one group, many calls
        first = group.run(work, 16)
        every = group.run_all(work, 32)         # one result per rank

Each rank is a process started with the "spawn" method (CUDA forbids
fork) whose environment carries torchrun's variables (MASTER_ADDR,
MASTER_PORT on a free port, RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE); it initializes the default process group once
(parallel/distributed.py ``initialize``) and then runs the functions it is
sent, in order.  A rank that raises, dies or outlasts the timeout ends the
whole group and the call raises.
"""
import os
import queue
import socket
import time
import traceback

import multiprocessing as mp


class RankError(RuntimeError):
    """A rank failed, died or timed out; the group was ended."""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, backend, threads, tasks, results):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    parent = os.getppid()
    try:
        import torch
        import torch.distributed as dist

        from .distributed import initialize
        if threads:
            torch.set_num_threads(threads)
        initialize(backend=backend)
        results.put((rank, None, "ready", None))
    except (Exception, SystemExit):
        results.put((rank, None, "error", traceback.format_exc()))
        return
    while True:
        try:
            task = tasks.get(timeout=5.0)
        except queue.Empty:
            if os.getppid() != parent:      # the caller is gone
                break
            continue
        if task is None:
            break
        task_id, fn, args = task
        try:
            results.put((rank, task_id, "ok", fn(*args)))
        except (Exception, SystemExit):
            results.put((rank, task_id, "error", traceback.format_exc()))
    dist.destroy_process_group()


class RankGroup:
    """``nprocs`` ranks of one process group on this host.

    Args:
        nprocs: world size.
        backend: "gloo" (default; ranks may share a card or run on the
            CPU), "nccl" (one card per rank) or None for
            parallel/distributed.py ``pick_backend``'s choice.
        timeout: seconds a call (and the start-up) may take.
        threads: torch intra-op threads per rank (0 keeps torch's default).
    """

    def __init__(self, nprocs, backend="gloo", timeout=600.0, threads=1):
        ctx = mp.get_context("spawn")
        self.nprocs = nprocs
        self.timeout = timeout
        self._tasks = [ctx.Queue() for _ in range(nprocs)]
        self._results = ctx.Queue()
        self._next = 0
        port = free_port()
        self._procs = [ctx.Process(
            target=_worker, args=(r, nprocs, port, backend, threads,
                                  self._tasks[r], self._results),
            daemon=True) for r in range(nprocs)]
        for proc in self._procs:
            proc.start()
        try:
            self._collect(None, timeout)
        except BaseException:
            self.close()
            raise

    def _collect(self, task_id, timeout):
        """One message per rank for ``task_id``, by rank; ends the group
        and raises on an error, a dead rank or the timeout."""
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < self.nprocs:
            try:
                rank, tid, status, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in out]
                if dead or time.monotonic() > deadline:
                    self.close()
                    what = f"ranks {dead} died" if dead \
                        else f"timed out after {timeout} s"
                    raise RankError(f"rank group {what}") from None
                continue
            if tid != task_id:
                continue
            if status == "error":
                self.close()
                raise RankError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.nprocs)]

    def run_all(self, fn, *args, timeout=None):
        """Runs ``fn(*args)`` on every rank; returns the results by rank.
        ``fn`` must be importable by name (a module-level function)."""
        if not self._procs:
            raise RankError("the rank group is closed")
        self._next += 1
        for q in self._tasks:
            q.put((self._next, fn, args))
        return self._collect(self._next, timeout or self.timeout)

    def run(self, fn, *args, timeout=None):
        """Runs ``fn(*args)`` on every rank; returns rank 0's result."""
        return self.run_all(fn, *args, timeout=timeout)[0]

    def close(self):
        """Stops every rank (killing those that do not stop within a few
        seconds).  Results still queued are drained first: a rank whose
        result was never read cannot exit."""
        procs, self._procs = self._procs, []
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError, RuntimeError):
                pass        # a queue closed at interpreter shutdown
        deadline = time.monotonic() + 10.0
        while any(p.is_alive() for p in procs) \
                and time.monotonic() < deadline:
            try:
                self._results.get(timeout=0.1)
            except (queue.Empty, OSError, ValueError):
                pass
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_procs", None):
            self.close()


def launch(fn, nprocs, *args, backend="gloo", timeout=600.0, threads=1):
    """Starts ``nprocs`` ranks, runs ``fn(*args)`` on each, stops them and
    returns rank 0's result (raising :class:`RankError` on any rank's
    failure or the timeout)."""
    with RankGroup(nprocs, backend=backend, timeout=timeout,
                   threads=threads) as group:
        return group.run(fn, *args)
