"""3D Rosenbrock HMC with progress, diagnostics, and an optional 3D scatter.

Counterpart of ``examples/rosenbrock3d_hmc.py``.
"""

import os
import tempfile
import time

from .. import HMC, init_det
from ..models import rosenbrock_nd


def main(device="cuda"):
    target = rosenbrock_nd()
    sampler = HMC(target, init_det(4, 3, device=device), step_size=0.01,
                  n_leapfrog=10, device=device).seed(42)

    start = time.monotonic()
    sample, stats = sampler.run_progress(400, 50)
    elapsed = time.monotonic() - start

    print("shape:", tuple(sample.shape))
    print(stats)
    n_obs = sample.shape[0] * sample.shape[1]
    print(f"HMC sampler: generating {n_obs} observations took {elapsed:.2f}s")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        flat = sample.cpu().numpy().reshape(-1, 3)
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(flat[:, 0], flat[:, 1], flat[:, 2], s=1, alpha=0.3)
        png = os.path.join(tempfile.gettempdir(), "rosenbrock3d_hmc.png")
        plt.savefig(png, dpi=100)
        plt.close(fig)
        print("saved 3D scatter:", png)
    except ImportError:
        pass


if __name__ == "__main__":
    main()
