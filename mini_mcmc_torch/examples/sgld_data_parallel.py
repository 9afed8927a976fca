"""SGLD with the dataset sharded across a data mesh.

Counterpart of ``examples/sgld_data_parallel.py``. When the dataset no
longer fits one device, :func:`mini_mcmc_torch.data_parallel_grad` splits
its rows over a 1-D ``"data"`` mesh. Each step every rank draws
``batch_size / n_ranks`` rows from its own shard, takes the partial
minibatch gradient of the replicated ``[C, D]`` chains, and the partials
reduce with exactly one all-reduce. On one GPU the mesh has one rank and
the all-reduce is the identity. The posterior is a conjugate Bayesian
linear regression, so the analytic posterior is the yardstick.
"""

import numpy as np
import torch

from .. import SGLD, data_parallel_grad, init_det, polynomial_decay, summary
from ..parallel import data_mesh


def main(device="cuda", n_rows=8192, dim=4, n_chains=64, batch_size=512,
         seed=0):
    mesh = data_mesh(device=device)
    n_dev = mesh.size()
    # equal shards: trim to divisibility (unequal shards bias the estimator)
    n_rows -= n_rows % n_dev
    batch_size -= batch_size % n_dev

    # conjugate Bayesian linear regression: prior N(0, tau^2 I),
    # y ~ N(Xw, s^2 I) => posterior N(S X'y / s^2, S),
    # S = (X'X / s^2 + I / tau^2)^-1
    tau, s_noise = 2.0, 0.5
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, dim)).astype(np.float32) / np.sqrt(dim)
    w_true = np.linspace(-1.0, 1.0, dim).astype(np.float32)
    y = (x @ w_true + s_noise * rng.standard_normal(n_rows)).astype(
        np.float32
    )
    prec = x.T @ x / s_noise**2 + np.eye(dim) / tau**2
    post_cov = np.linalg.inv(prec)
    post_mean = post_cov @ (x.T @ y) / s_noise**2

    # rows shard over the mesh inside data_parallel_grad; nothing else in
    # the program needs to know the dataset is distributed
    grad_fn = data_parallel_grad(
        lambda w: -0.5 * torch.sum(w * w) / tau**2,
        lambda w, b: -0.5 * torch.sum((b[1] - b[0] @ w) ** 2) / s_noise**2,
        (torch.as_tensor(x, dtype=torch.float32),
         torch.as_tensor(y, dtype=torch.float32)),
        batch_size=batch_size,
        mesh=mesh,
    )
    sgld = SGLD(
        grad_fn,
        init_det(n_chains, dim, device=device),
        step_size=polynomial_decay(1e-4, 100.0, 0.4),
        seed=42,
        device=device,
    )
    sample = sgld.run(1500, 1500)

    flat = sample.cpu().numpy().reshape(-1, dim)
    sd = np.sqrt(np.diag(post_cov))
    mean_err_sd = np.max(np.abs(flat.mean(0) - post_mean) / sd)
    print(f"data mesh: {n_dev} device(s), {n_rows} rows "
          f"({n_rows // n_dev} per shard), B={batch_size}")
    print(summary(sample))
    print(f"max |posterior mean err| = {mean_err_sd:.2f} posterior sd")
    assert mean_err_sd < 1.5, (flat.mean(0), post_mean, sd)
    return sample


if __name__ == "__main__":
    main()
