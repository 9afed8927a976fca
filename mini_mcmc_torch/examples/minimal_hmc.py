"""Minimal batched HMC on the N-D Rosenbrock (3D).

Counterpart of ``examples/minimal_hmc.py``.
"""

from .. import HMC, init_det
from ..models import rosenbrock_nd


def main(device="cuda"):
    target = rosenbrock_nd()
    sampler = HMC(target, init_det(4, 3, device=device), step_size=0.032,
                  n_leapfrog=10, device=device)
    sample = sampler.run(400, 50)
    print("collected sample with shape:", tuple(sample.shape))


if __name__ == "__main__":
    main()
