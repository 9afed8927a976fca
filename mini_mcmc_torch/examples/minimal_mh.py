"""Minimal Metropolis-Hastings: 4 chains on a 2D standard Gaussian.

Counterpart of ``examples/minimal_mh.py``.
"""

from .. import MetropolisHastings, init_det
from ..models import gaussian2d, isotropic_gaussian_proposal


def main(device="cuda"):
    target = gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    proposal = isotropic_gaussian_proposal(1.0)

    # 4 parallel chains, deterministic (seed-42) starting positions.
    mh = MetropolisHastings(target, proposal,
                            init_det(4, 2, device=device), device=device)

    # 1,100 steps per chain, discarding the first 100 as burn-in.
    sample = mh.run(1000, 100)

    assert sample.shape[0] == 4
    assert sample.shape[1] == 1000
    print("sample shape:", tuple(sample.shape))


if __name__ == "__main__":
    main()
