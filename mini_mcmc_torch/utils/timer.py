"""Wall-clock timer (counterpart of ``mini_mcmc_tpu/utils/timer.py``).

``Timer.log(msg)`` prints the time since the previous call, as the
reference's ``dev_tools::Timer``; :func:`time_blocked` times a call whose
CUDA work runs asynchronously, waiting for the devices of its result.
"""

from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self):
        self._last = time.monotonic()

    def log(self, msg: str) -> float:
        """Print and return the seconds since the last call."""
        now = time.monotonic()
        elapsed = now - self._last
        self._last = now
        print(f"[timer] {msg}: {elapsed * 1000.0:.3f} ms")
        return elapsed

    def reset(self) -> None:
        self._last = time.monotonic()


def _tensors(x):
    """The tensors in ``x`` (a tensor, or tuples, lists, dicts and
    NamedTuples of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _synchronize(result):
    """Wait for the work that produces ``result`` on each CUDA device of
    its tensors; return ``result``."""
    for device in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return result


def time_blocked(fn, *args, **kwargs):
    """Time ``fn(*args, **kwargs)`` up to the completion of the CUDA work
    behind its result. Returns ``(result, seconds)``."""
    start = time.monotonic()
    result = _synchronize(fn(*args, **kwargs))
    return result, time.monotonic() - start
