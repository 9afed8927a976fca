"""MH on a correlated 2D Gaussian with live progress, scatter plot, and
Parquet export.

Counterpart of ``examples/gauss_mh.py`` (the scatter plot with matplotlib
if it imports, else a text summary).
"""

import os
import tempfile

import numpy as np

from .. import MetropolisHastings, init_det
from ..io import save_parquet
from ..models import gaussian2d, isotropic_gaussian_proposal


def main(device="cuda"):
    target = gaussian2d([2.0, 3.0], [[4.0, 2.0], [2.0, 3.0]])
    proposal = isotropic_gaussian_proposal(2.0)
    mh = MetropolisHastings(target, proposal, init_det(6, 2, device=device),
                            device=device).seed(42)

    sample, stats = mh.run_progress(2000, 500)
    print(stats)

    flat = sample.cpu().numpy()
    out = os.path.join(tempfile.gettempdir(), "gauss_mh.parquet")
    save_parquet(flat, out)
    print("saved parquet:", out)

    flat = flat.reshape(-1, 2)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(5, 5))
        plt.scatter(flat[:, 0], flat[:, 1], s=1, alpha=0.2)
        png = os.path.join(tempfile.gettempdir(), "gauss_mh.png")
        plt.savefig(png, dpi=100)
        plt.close()
        print("saved scatter:", png)
    except ImportError:
        print("sample mean:", flat.mean(axis=0), "cov:\n", np.cov(flat.T))


if __name__ == "__main__":
    main()
