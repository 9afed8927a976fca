"""Measurements behind two of ``chip_smoke.py``'s constrained stages, in
both packages on the CPU (not a test: run it by hand, ~5 minutes):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/measure_transform_stages.py

1. ``[nuts_constrained]``: NUTS on ``diffable_gaussian2d([0, 1], [[4, 2],
   [2, 3]])`` with x0 > 0 (``CoordinateTransform({0: positive()})``) from
   the same numpy starting points in the JAX package (its lockstep NUTS on
   the wrapped target) and the port (Kernel 4's plain twin), ``run(256,
   64)`` twice at 2,048 chains: the second run's divergences per
   transition. The stage's divergence gate is set from it.
2. ``[sep_constrained]``: ``standard_normal()`` with ``positive()`` on all
   D = 10,000 coordinates from x = 1 (``examples/bigd_separable_hmc.py:
   41-46``). The energy error of one L = 10 trajectory from that start by
   step size (the port, float64); the acceptance of the example's eps
   0.22, L = 8 over ``run(20, 20)`` in both packages (8 chains); and at
   D = 1,000 (mixing per coordinate does not depend on D) the acceptance,
   moments, split R-hat and ESS per draw at eps 0.04 by L, 256 chains,
   ``run(128, 128)`` then ``run(128)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.ops.kernels.hmc import leapfrog_trajectory_plain
from mini_mcmc_tpu import HMC as JaxHMC
from mini_mcmc_tpu import NUTS as JaxNUTS
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models import transforms as jt

MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


def nuts_divergences(n_chains=2048, n_collect=256, n_discard=64):
    y0 = np.random.default_rng(0).standard_normal((n_chains, 2)).astype(
        np.float32)
    steps = n_collect + n_discard - 1
    tf = mt.CoordinateTransform({0: mt.positive()}, dim=2)
    port = mt.NUTS(mt.diffable_gaussian2d(MEAN, COV),
                   tf.to_x(torch.from_numpy(y0)), 0.8, use_pallas="full",
                   transform=tf, device="cpu").seed(7)
    for _ in range(2):
        port.run(n_collect, n_discard)
    print("[nuts_constrained] port (Kernel 4 twin): divergences per "
          "transition", float(port.last_run_divergences.sum())
          / (n_chains * steps), "mean step", float(port.step_size.mean()))
    jtf = jt.CoordinateTransform({0: jt.positive()}, dim=2)
    ref = JaxNUTS(jtf.wrap(jm.diffable_gaussian2d(MEAN, COV)),
                  jnp.asarray(y0), 0.8).seed(7)
    for _ in range(2):
        ref.run(n_collect, n_discard)
    print("[nuts_constrained] JAX (lockstep NUTS): divergences per "
          "transition", float(jnp.sum(ref.last_run_divergences))
          / (n_chains * steps))


def _accept(s):
    return float((s[:, 1:, 0] != s[:, :-1, 0]).mean())


def separable_steps(d=10_000):
    tf = mt.CoordinateTransform({i: mt.positive() for i in range(d)}, dim=d)
    w = tf.wrap(mt.standard_normal())
    y = torch.zeros((16, d), dtype=torch.float64)
    mom = torch.randn((16, d), generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64)
    lp, g = w.batch_logp_and_grad(y)
    for eps in (0.04, 0.05, 0.06, 0.1, 0.22):
        _, m2, lp2, _ = leapfrog_trajectory_plain(
            w, y, mom, g, torch.tensor(eps, dtype=torch.float64), 10)
        dh = (-lp + 0.5 * (mom * mom).sum(1)) - (-lp2 + 0.5 * (m2 * m2)
                                                 .sum(1))
        print(f"[sep_constrained] D={d} from x = 1, L = 10, eps {eps}: "
              f"H_cur - H_prop mean {float(dh.mean()):.3f} sd "
              f"{float(dh.std()):.3f}")
    port = mt.HMC(mt.standard_normal(), torch.ones((8, d)), 0.22, 8,
                  transform=tf, device="cpu").seed(1)
    print("[sep_constrained] port, eps 0.22, L = 8: acceptance",
          _accept(port.run(20, 20).numpy()))
    jtf = jt.CoordinateTransform({i: jt.positive() for i in range(d)}, d)
    ref = JaxHMC(jm.standard_normal(), jnp.full((8, d), 1.0, jnp.float32),
                 0.22, 8, transform=jtf).seed(1)
    print("[sep_constrained] JAX, eps 0.22, L = 8: acceptance",
          _accept(np.asarray(ref.run(20, 20))))
    d = 1000
    tf = mt.CoordinateTransform({i: mt.positive() for i in range(d)}, dim=d)
    for n_leapfrog in (10, 20, 30, 40):
        h = mt.HMC(mt.standard_normal(), torch.ones((256, d)), 0.04,
                   n_leapfrog, transform=tf, device="cpu").seed(1)
        h.run(128, 128)
        s = h.run(128, 0, time_major=True)
        rhat, ess = mt.split_rhat_mean_ess(s.contiguous(), time_major=True)
        print(f"[sep_constrained] D={d}, eps 0.04, L = {n_leapfrog}: "
              f"acceptance {_accept(s.transpose(0, 1).numpy()):.4f} mean "
              f"{float(s.mean()):.4f} var {float(s.var()):.4f} R-hat "
              f"{float(rhat.mean()):.4f} ESS per draw "
              f"{float(ess.mean()) / (256 * 128):.4f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(8)
    nuts_divergences()
    separable_steps()
