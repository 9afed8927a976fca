"""Minimal NUTS on the 2D Rosenbrock with progress and diagnostics.

Counterpart of ``examples/minimal_nuts.py``; on CUDA NUTS takes its fused
tier (:func:`~mini_mcmc_torch.examples.nuts_tier`).
"""

from .. import NUTS, init
from ..models import rosenbrock2d
from . import nuts_tier


def main(device="cuda"):
    target = rosenbrock2d(a=1.0, b=100.0)
    # on the card the fused tier (Kernel 4), on the CPU the lockstep one
    sampler = NUTS(target, init(4, 2, device=device), target_accept_p=0.95,
                   device=device, **nuts_tier(device)).seed(42)
    n_collect, n_discard = 400, 400

    sample, stats = sampler.run_progress(n_collect, n_discard)
    print("sample shape:", tuple(sample.shape))
    print(stats)
    assert tuple(sample.shape) == (4, 400, 2)


if __name__ == "__main__":
    main()
