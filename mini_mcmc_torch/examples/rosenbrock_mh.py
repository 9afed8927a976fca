"""MH on a custom user-defined target (2D Rosenbrock density).

Counterpart of ``examples/rosenbrock_mh.py``: a target written as a plain
log-density function. The port's densities act on the trailing axis of a
``[..., D]`` tensor, so the function below serves one state and a batch.
"""

from .. import MetropolisHastings, init_det
from ..models import isotropic_gaussian_proposal
from ..models.base import Target


def rosenbrock_logp(pos):
    """``[..., 2] -> [...]``: the example's density,
    ``-((1 - x)^2 + 100 (y - x^2)^2) / 20``."""
    x, y = pos[..., 0], pos[..., 1]
    return -((1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2) / 20.0


def main(device="cuda"):
    target = Target(logp=rosenbrock_logp)
    proposal = isotropic_gaussian_proposal(0.5)
    mh = MetropolisHastings(target, proposal, init_det(8, 2, device=device),
                            device=device).seed(0)
    sample = mh.run(5000, 1000)

    flat = sample.cpu().numpy().reshape(-1, 2)
    print("sample shape:", tuple(sample.shape))
    print("x mean/std:", flat[:, 0].mean(), flat[:, 0].std())
    print("y mean/std:", flat[:, 1].mean(), flat[:, 1].std())


if __name__ == "__main__":
    main()
