"""Spawned ``torch.distributed`` gloo groups for the port's multi-rank CPU
tests (``test_torch_parallel.py``, ``test_torch_multihost.py``).

:func:`run_ranks` starts ``world`` processes with the ``spawn`` start
method (never ``fork``: the parent may hold threads and a JAX runtime),
each one thread, joined through a rendezvous file of their own (so xdist
workers never share a port), runs ``fn(rank, world)`` on every rank and
returns the ranks' results in rank order. A rank that raises, or a group
that outlives ``timeout`` seconds, fails the caller instead of hanging the
run; every child is stopped on the way out. ``fn`` must be a module-level
function of a module the children import without JAX (this one's
neighbours ``torch_*_cases.py``).
"""

import multiprocessing
import os
import queue
import time
import traceback


def _child(fn, rank: int, world: int, init_file: str, start: bool,
           out) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        if start:
            dist.init_process_group("gloo",
                                    init_method=f"file://{init_file}",
                                    rank=rank, world_size=world)
        try:
            result = (fn(rank, world) if start
                      else fn(rank, world, f"file://{init_file}"))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        out.put((rank, None, result))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
        raise


def run_ranks(fn, world: int, tmp_dir, timeout: float = 150.0, *,
              start_group: bool = True) -> list:
    """``[fn(0, world), ..., fn(world - 1, world)]``, each on a rank of a
    fresh ``world``-rank gloo group in a process of its own. With
    ``start_group=False`` the ranks start no group: ``fn(rank, world,
    init_method)`` starts it itself from the rendezvous URL."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init_file = os.path.join(str(tmp_dir), f"rendezvous_{world}")
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, init_file, start_group, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"the {world}-rank group did not finish in {timeout} s "
                    f"(ranks done: {sorted(results)})")
            try:
                rank, err, result = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise AssertionError(
                        f"ranks {dead} exited without a result (exit codes "
                        f"{[procs[r].exitcode for r in dead]})") from None
                continue
            if err is not None:
                raise AssertionError(f"rank {rank} failed:\n{err}")
            results[rank] = result
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
