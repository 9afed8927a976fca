"""Measurements behind ``chip_smoke.py``'s constrained stages, in both
packages on the CPU (not a test: run it by hand, ~5 minutes; one stage
with ``python tests/measure_transform_stages.py mh_pt``):

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
3. A transform on an integer state (``[int_state]``, ROADMAP Queue 3):
   the JAX package's draws and the port's refusal.
4. ``[mh_constrained]`` and ``[pt_constrained]``: the MH stage
   (``bench.py:391-431``, standard 2-D Gaussian, walk 1.0, K = 16) with
   ``positive()`` on x0, and the tempering stage (``bench.py:858-909``,
   the 0.3/0.7 mixture at -8 and 8, 8 rungs, K = 16, all chains from -8)
   with ``interval(-24, 24)``, at a quarter and an eighth of their chains,
   ``run(2048)`` twice, in the JAX package (its lockstep XLA tiers) and the
   port (Kernels 5 and 8's twins), each with the stage's gates: the MH
   stage at walk 1.0, tempering by cold proposal scale in y. Under the
   interval, ``dx/dy`` is about 10.7 at the modes, so the bench's scale
   1.0 in y is a walk of about 10.7 in x, and 0.1 in y about the bench's
   1.0 in x.
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


def int_state_transform():
    """``positive()`` on the Poisson MH's int32 state: the JAX package
    walks the float y and returns non-integer natural draws (its lockstep
    tier, 8 chains from 3, seed 1, ``run(5)``); the port raises."""
    from mini_mcmc_tpu import MetropolisHastings as JaxMH

    jtf = jt.CoordinateTransform({0: jt.positive()}, dim=1)
    ref = JaxMH(jm.poisson_target(4.0), jm.random_walk_int_proposal(),
                jnp.full((8, 1), 3, jnp.int32), transform=jtf).seed(1)
    print("[int_state] JAX: state", ref.state.positions.dtype,
          np.asarray(ref.state.positions)[0].tolist(), "chain 0 draws",
          np.asarray(ref.run(5, 0))[0, :, 0].tolist())
    try:
        mt.MetropolisHastings(
            mt.poisson_target(4.0), mt.random_walk_int_proposal(),
            torch.full((8, 1), 3, dtype=torch.int32),
            transform=mt.CoordinateTransform({0: mt.positive()}, dim=1),
            device="cpu")
    except ValueError as e:
        print("[int_state] port: ValueError:", e)


def _mh_gates(x, ess, n):
    """The [mh_constrained] gates: x0 half-normal (mean sqrt(2 / pi), var
    1 - 2 / pi), x1 ~ N(0, 1), x0 > 0, and the MH stage's ESS floor."""
    x = np.asarray(x, np.float64).reshape(-1, 2)
    mean, var = x.mean(0), x.var(0)
    return {"mean": mean.round(4).tolist(), "var": var.round(4).tolist(),
            "ess_per_draw": round(float(np.mean(ess)) / n, 4),
            "pass": bool((x[:, 0] > 0).all()
                         and abs(mean[0] - 0.797885) <= 0.03
                         and abs(var[0] - 0.363380) <= 0.05
                         and abs(mean[1]) <= 0.03 and abs(var[1] - 1) <= 0.05
                         and float(np.mean(ess)) >= 0.02 * n)}


def _pt_gates(x, swap):
    """The tempering stage's four gates (bench.py:890-898)."""
    x = np.asarray(x, np.float64).ravel()
    plus = x[x > 0]
    out = {"mode_weight": round(float((x > 0).mean()), 4),
           "plus_mean": round(float(plus.mean()), 4),
           "plus_std": round(float(plus.std()), 4),
           "min_swap": round(float(np.min(swap)), 4)}
    out["pass"] = bool(abs(out["mode_weight"] - 0.7) <= 0.05
                       and abs(out["plus_mean"] - 8.0) <= 0.05
                       and abs(out["plus_std"] - 0.5) <= 0.05
                       and out["min_swap"] > 0.05
                       and ((x > -24) & (x < 24)).all())
    return out


def mh_pt_constrained(mh_chains=16384, pt_chains=1024, n=2048):
    from mini_mcmc_tpu import MetropolisHastings as JaxMH
    from mini_mcmc_tpu import ParallelTempering as JaxPT
    from mini_mcmc_tpu import geometric_betas as jax_betas
    from mini_mcmc_tpu import split_rhat_mean_ess as jax_ess

    x0 = np.abs(np.random.default_rng(8).standard_normal(
        (mh_chains, 2))).astype(np.float32) + 0.05
    tf = mt.CoordinateTransform({0: mt.positive()}, dim=2)
    port = mt.MetropolisHastings(
        mt.gaussian2d([0, 0], [[1, 0], [0, 1]]),
        mt.isotropic_gaussian_proposal(1.0), torch.from_numpy(x0),
        use_pallas="full", steps_per_call=16, transform=tf,
        device="cpu").seed(8)
    port.run(n, 0, time_major=True)
    s = port.run(n, 0, time_major=True)
    _, ess = mt.split_rhat_mean_ess(s, time_major=True)
    print("[mh_constrained] port (Kernel 5 twin), walk 1.0:",
          _mh_gates(s.numpy(), ess.numpy(), mh_chains * n))
    jtf = jt.CoordinateTransform({0: jt.positive()}, dim=2)
    ref = JaxMH(jm.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                jm.isotropic_gaussian_proposal(1.0), jnp.asarray(x0),
                steps_per_call=16, transform=jtf).seed(8)
    ref.run(n, 0, time_major=True)
    s = ref.run(n, 0, time_major=True)
    _, ess = jax_ess(s, time_major=True)
    print("[mh_constrained] JAX (lockstep), walk 1.0:",
          _mh_gates(s, np.asarray(ess), mh_chains * n))

    itf = mt.CoordinateTransform({0: mt.interval(-24.0, 24.0)}, dim=1)
    jitf = jt.CoordinateTransform({0: jt.interval(-24.0, 24.0)}, dim=1)
    w_plus = 0.7
    lw0, lw1 = float(np.log(1 - w_plus)), float(np.log(w_plus))

    def logp(x):
        a = lw0 - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = lw1 - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    def jlogp(x):
        a = lw0 - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = lw1 - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return jnp.logaddexp(a, b)

    mix = mt.models.Target(logp=logp, cuda_functor="gaussian_mixture_1d",
                           cuda_params=(lw0, -8.0, 0.5, lw1, 8.0, 0.5))
    jmix = jm.Target(logp=jlogp, logp_batch=jlogp)
    start = np.full((pt_chains, 1), -8.0, np.float32)
    for std in (1.0, 0.2, 0.1, 0.05):
        pt = mt.ParallelTempering(
            mix, torch.from_numpy(start),
            betas=mt.geometric_betas(8, 0.01), proposal_std=std,
            steps_per_call=16, use_pallas="full", transform=itf,
            device="cpu").seed(5)
        pt.run(n, 0, time_major=True)
        s = pt.run(n, 0, time_major=True)
        print(f"[pt_constrained] port (Kernel 8 twin), cold scale {std} in "
              "y:", _pt_gates(s.numpy(), pt.swap_acceptance.numpy()))
        ref = JaxPT(jmix, jnp.asarray(start), betas=jax_betas(8, 0.01),
                    proposal_std=std, steps_per_call=16,
                    transform=jitf).seed(5)
        ref.run(n, 0, time_major=True)
        s = ref.run(n, 0, time_major=True)
        # under steps_per_call > 1 the JAX package records the cold rung
        # in y, unmapped (ROADMAP.md, Queue 3): mapped here for its gates
        print(f"[pt_constrained] JAX (lockstep), cold scale {std} in y: "
              f"cube in [{float(s.min()):.4f}, {float(s.max()):.4f}],",
              _pt_gates(jitf.to_x(s), np.asarray(ref.swap_acceptance)))


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(8)
    if sys.argv[1:] == ["mh_pt"]:
        int_state_transform()
        mh_pt_constrained()
    else:
        nuts_divergences()
        separable_steps()
        int_state_transform()
        mh_pt_constrained()
