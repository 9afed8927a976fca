"""Profiling helpers (counterpart of ``mini_mcmc_tpu/utils/profiling.py``).

CUDA work is asynchronous: a host clock read without a synchronize measures
the enqueue. ``trace`` writes a ``torch.profiler`` trace of a block;
``sync`` waits for the device; ``step_timer`` times on CUDA events for CUDA
results and on the host clock otherwise; ``device_profile`` splits one
call's device time by kernel with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

#: profiled calls of :func:`device_profile` before it gives up
_PROFILE_ATTEMPTS = 3


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Trace a block with ``torch.profiler`` (CPU and CUDA activity; the
    CPU alone where PyTorch sees no CUDA device) and write it into
    ``log_dir`` as a Chrome trace JSON (``*.pt.trace.json``, which
    TensorBoard and Perfetto read). Yields ``log_dir``, by default
    ``mini_mcmc_torch_trace`` in the temporary directory (``TMPDIR``).

        with profiling.trace("runs/trace"):
            sampler.run(1000, 100)
    """
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "mini_mcmc_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def sync(x):
    """Wait until every queued CUDA kernel has finished; return ``x``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return x


def step_timer(fn, *args, repeats: int = 3, **kwargs):
    """Median seconds of ``fn(*args, **kwargs)`` over ``repeats`` calls,
    completion included. Returns ``(last result, seconds)``."""
    times = []
    result = None
    cuda = torch.cuda.is_available()
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    times.sort()
    return result, times[len(times) // 2]


class ProfilerDroppedEvents(RuntimeError):
    """:func:`device_profile` got no device event (or none of the kernel it
    expected) from any of its profiled calls: the profiler dropped them.
    Only this is a time "not measured"; an error of the profiled call
    itself is not."""


def device_profile(fn, *args, expect: str | None = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under ``torch.profiler`` with CUDA
    activity, completion included.

    Returns ``(wall seconds, busy microseconds, {name: (count, device
    microseconds)})``: ``busy`` sums the device events' durations (one
    stream, so they do not overlap), and ``1 - busy / wall`` is the
    device's idle share during the call. The wall time includes the
    profiler's own overhead. On the H100 the CUDA activity of a profiled
    call now and then arrives without the kernels it ran; a call that
    recorded no device event, or none whose name holds ``expect``, is
    profiled again, up to three calls in all (``fn`` runs again each
    time), and :class:`ProfilerDroppedEvents` is raised if none did. Any
    other error of ``fn`` propagates as it was raised.
    """
    from torch.profiler import ProfilerActivity, profile

    for _ in range(_PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if by_name and (expect is None
                        or any(expect in name for name in by_name)):
            busy = sum(us for _, us in by_name.values())
            return wall, busy, by_name
    what = "" if expect is None else f" of {expect!r}"
    raise ProfilerDroppedEvents(f"torch.profiler recorded no device event"
                                f"{what} in {_PROFILE_ATTEMPTS} profiled "
                                "calls")
