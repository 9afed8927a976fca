"""Utilities: initial positions, timers and profiling (counterpart of
``mini_mcmc_tpu.utils``; ``chain_keys`` has no counterpart, since the port
keys its draws by place)."""

from . import profiling
from .init import init, init_det, init_with_seed
from .timer import Timer, time_blocked

__all__ = [
    "Timer",
    "init",
    "init_det",
    "init_with_seed",
    "profiling",
    "time_blocked",
]
