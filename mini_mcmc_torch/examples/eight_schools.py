"""The hierarchical eight-schools posterior (Rubin 1981), in PyTorch.

A copy of ``examples/eight_schools_nuts.py`` for the port, which imports
neither that file nor JAX:

    y_j ~ N(theta_j, sigma_j^2)      j = 1..8   (observed effects and SEs)
    theta_j = mu + tau eta_j,  eta_j ~ N(0, 1)  (non-centered)
    mu ~ N(0, 5^2),  tau ~ HalfCauchy(5)

:func:`make_noncentered_target` samples ``[mu, log_tau, eta_1..8]`` with the
``log_tau`` Jacobian written in (``eight_schools_nuts.py:45-110``), its
gradient by hand; :func:`make_natural_target` is the same posterior over
``[mu, tau > 0, eta_1..8]`` with no Jacobian, for ``transform=`` with
``positive()`` on coordinate 1 (``tests/test_transforms.py:143-155``).
:func:`exact_posterior_means` gives ``E[mu]`` and ``E[tau]`` by quadrature
(``eight_schools_nuts.py:131-147``), numpy only. The non-centered target
carries the C++ of the example's ``logp_dc`` and ``grad_dc``
(``eight_schools_nuts.py:73-109``) as its ``cuda_source``, so that it also
runs on the fused NUTS tiers (``bench.py:1376-1447``): with the
hand-written gradient, with the gradient of dual numbers
(:func:`~mini_mcmc_torch.models.derive_grad_dc`), or from C++ generated
from ``logp_batch`` (no source). :func:`chees_adapted` is the ChEES half
(``bench.py:1342-1372``) and :func:`moment_gates` the bench's gates on a
run of any. :func:`make_centered_target` is the funnel parameterization
``[mu, log_tau, theta_1..8]``, and :func:`main` the example itself
(``eight_schools_nuts.py:150-200``): NUTS on both parameterizations, two
runs each, the non-centered posterior means against the quadrature and
the centered one's steady-state divergences.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..diagnostics import rank_normalized_diagnostics, summary
from ..models.base import Target
from ..nuts import NUTS
from ..ops.kernels.user_density import derive_grad_dc
from ..samplers import ChEESHMC
from ..stats import run_stats, split_rhat_mean_ess
from ..utils.init import init_with_seed
from . import nuts_tier

#: Rubin (1981): estimated treatment effects and their standard errors
Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], np.float32)
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], np.float32)
MU_PRIOR_STD = 5.0
TAU_PRIOR_SCALE = 5.0
#: the bench stages' size (bench.py:1282-1283): chains, then run(1024, 256)
N_CHAINS, N_COLLECT, N_DISCARD = 4096, 1024, 256
#: log(2 / (pi * 5)), the half-Cauchy's normalizing term
_LOG_HC = math.log(2.0 / (math.pi * TAU_PRIOR_SCALE))


def _data(like: torch.Tensor):
    return (torch.as_tensor(Y, dtype=like.dtype, device=like.device),
            torch.as_tensor(SIGMA, dtype=like.dtype, device=like.device))


def _log_half_cauchy(tau: torch.Tensor) -> torch.Tensor:
    return _LOG_HC - torch.log1p((tau / TAU_PRIOR_SCALE) ** 2)


def _rows(params: torch.Tensor):
    return params.reshape(-1, params.shape[-1]), params.shape[:-1]


#: the example's logp_dc and grad_dc (eight_schools_nuts.py:73-105) for
#: Kernels 1-4, term for term in their order; params: Y, then SIGMA
CUDA_SOURCE = """\
struct Density {
  const float* p;
  __device__ __forceinline__ explicit Density(const float* params)
      : p(params) {}

  // log(2 / (pi * 5)), the half-Cauchy's normalizing term
  static constexpr float kLogHC = -2.0610206f;

  template <class S, int D>
  __device__ __forceinline__ S logp(const S (&x)[D]) const {
    static_assert(D == 10, "[mu, log_tau, eta_1..8]");
    const S mu = x[0], log_tau = x[1];
    const S tau = mm::exp(log_tau);
    const S m5 = mu / 5.0f, t5 = tau / 5.0f;
    S acc = -0.5f * (m5 * m5);
    acc = acc + kLogHC - mm::log1p(t5 * t5);
    acc = acc + log_tau;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = __ldg(p + j), s = __ldg(p + 8 + j);
      const S eta = x[2 + j];
      const S r = y - (mu + tau * eta);
      acc = acc - 0.5f * (r * r) / (s * s);
      acc = acc - 0.5f * eta * eta;
    }
    return acc;
  }

  template <int D>
  __device__ __forceinline__ void grad(const float (&x)[D],
                                       float (&g)[D]) const {
    static_assert(D == 10, "[mu, log_tau, eta_1..8]");
    const float mu = x[0], tau = mm::exp(x[1]);
    float g_mu = -mu / 25.0f;
    const float t2 = (tau / 5.0f) * (tau / 5.0f);
    float g_lt = 1.0f - 2.0f * t2 / (1.0f + t2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = __ldg(p + j), s = __ldg(p + 8 + j);
      const float eta = x[2 + j];
      const float r = (y - (mu + tau * eta)) / (s * s);
      g_mu = g_mu + r;
      g_lt = g_lt + r * tau * eta;
      g[2 + j] = r * tau - eta;
    }
    g[0] = g_mu;
    g[1] = g_lt;
  }
};
"""
#: the forms :func:`make_noncentered_target` takes for Kernels 1-4
CUDA_FORMS = ("hand", "derived", "traced")


def make_noncentered_target(cuda: str = "hand") -> Target:
    """``params = [mu, log_tau, eta_1..8]`` (D = 10), ``theta = mu + tau
    eta``, the ``+ log_tau`` Jacobian of ``tau = exp(log_tau)`` included.
    ``logp`` takes ``[..., 10]``; ``grad`` is the example's hand-written
    ``grad_dc`` (``eight_schools_nuts.py:88-105``) in the batch layout.

    ``cuda``, the form Kernels 1-4 compile: ``"hand"`` the example's
    ``logp_dc`` and ``grad_dc`` in C++ (:data:`CUDA_SOURCE`, ``Y`` and
    ``SIGMA`` its ``cuda_params``); ``"derived"`` the same ``logp`` with
    the gradient of dual numbers (``derive_grad_dc``, bench.py's
    ``grad_dc=None``); ``"traced"`` no source, the C++ generated from
    ``logp_batch`` (``Target.dc_forms``)."""
    if cuda not in CUDA_FORMS:
        raise ValueError(f"cuda must be one of {CUDA_FORMS}; got {cuda!r}")

    def logp_batch(params):  # [C, 10] -> [C]
        y, sig = _data(params)
        mu, log_tau, eta = params[:, :1], params[:, 1:2], params[:, 2:]
        tau = torch.exp(log_tau)
        theta = mu + tau * eta  # [C, 8]
        loglik = -0.5 * torch.sum(((y - theta) / sig) ** 2, dim=1)
        logp_eta = -0.5 * torch.sum(eta * eta, dim=1)
        logp_mu = -0.5 * (mu[:, 0] / MU_PRIOR_STD) ** 2
        logp_tau = _log_half_cauchy(tau[:, 0]) + log_tau[:, 0]
        return loglik + logp_eta + logp_mu + logp_tau

    def logp(params):
        rows, lead = _rows(params)
        return logp_batch(rows).reshape(lead)

    def grad(params):  # [..., 10] -> [..., 10]
        rows, _ = _rows(params)
        y, sig = _data(rows)
        mu, log_tau, eta = rows[:, :1], rows[:, 1:2], rows[:, 2:]
        tau = torch.exp(log_tau)
        r = (y - (mu + tau * eta)) / (sig * sig)  # [C, 8]
        t2 = (tau / TAU_PRIOR_SCALE) ** 2
        g_mu = -mu / MU_PRIOR_STD**2 + torch.sum(r, dim=1, keepdim=True)
        g_lt = (1.0 - 2.0 * t2 / (1.0 + t2)
                + torch.sum(r * tau * eta, dim=1, keepdim=True))
        g = torch.cat([g_mu, g_lt, r * tau - eta], dim=1)
        return g.reshape(params.shape)

    if cuda == "traced":
        return Target(logp=logp, logp_batch=logp_batch, grad=grad)
    source = CUDA_SOURCE if cuda == "hand" else derive_grad_dc(CUDA_SOURCE)
    return Target(logp=logp, logp_batch=logp_batch, grad=grad,
                  cuda_source=source,
                  cuda_params=tuple(float(v) for v in np.concatenate(
                      [Y, SIGMA])))


def make_natural_target() -> Target:
    """The same posterior over ``[mu, tau > 0, eta_1..8]`` with no
    Jacobian term: sample it with ``transform=CoordinateTransform({1:
    positive()}, dim=10)`` (``tests/test_transforms.py:143-155``)."""

    def logp_batch(params):  # [C, 10] -> [C]
        y, sig = _data(params)
        mu, tau, eta = params[:, :1], params[:, 1:2], params[:, 2:]
        theta = mu + tau * eta
        loglik = -0.5 * torch.sum(((y - theta) / sig) ** 2, dim=1)
        logp_eta = -0.5 * torch.sum(eta * eta, dim=1)
        logp_mu = -0.5 * (mu[:, 0] / MU_PRIOR_STD) ** 2
        return loglik + logp_eta + logp_mu + _log_half_cauchy(tau[:, 0])

    def logp(params):
        rows, lead = _rows(params)
        return logp_batch(rows).reshape(lead)

    return Target(logp=logp, logp_batch=logp_batch)


def make_centered_target() -> Target:
    """``params = [mu, log_tau, theta_1..8]``, the funnel
    parameterization (``eight_schools_nuts.py:113-128``)."""

    def logp_batch(params):  # [C, 10] -> [C]
        y, sig = _data(params)
        mu, log_tau, theta = params[:, :1], params[:, 1:2], params[:, 2:]
        tau = torch.exp(log_tau)
        loglik = -0.5 * torch.sum(((y - theta) / sig) ** 2, dim=1)
        logp_theta = (-0.5 * torch.sum(((theta - mu) / tau) ** 2, dim=1)
                      - 8.0 * log_tau[:, 0])
        logp_mu = -0.5 * (mu[:, 0] / MU_PRIOR_STD) ** 2
        logp_tau = _log_half_cauchy(tau[:, 0]) + log_tau[:, 0]
        return loglik + logp_theta + logp_mu + logp_tau

    def logp(params):
        rows, lead = _rows(params)
        return logp_batch(rows).reshape(lead)

    return Target(logp=logp, logp_batch=logp_batch)


def exact_posterior_means() -> tuple[float, float]:
    """``E[mu | y]`` and ``E[tau | y]`` by 1-D quadrature over the tau
    marginal: given tau, theta and mu integrate out in closed form
    (``y_j ~ N(mu, sigma_j^2 + tau^2)``, then mu against its prior),
    leaving ``p(tau | y)`` on a grid."""
    tau = np.linspace(1e-4, 80.0, 200_000)
    v = SIGMA[None, :].astype(np.float64) ** 2 + tau[:, None] ** 2  # [T, 8]
    a = np.sum(1.0 / v, axis=1) + 1.0 / MU_PRIOR_STD**2
    b = np.sum(Y[None, :] / v, axis=1)
    log_lik = (-0.5 * np.sum(np.log(v) + Y[None, :] ** 2 / v, axis=1)
               - 0.5 * np.log(a) + 0.5 * b * b / a)
    log_prior = -np.log1p((tau / TAU_PRIOR_SCALE) ** 2)
    w = np.exp(log_lik + log_prior - np.max(log_lik + log_prior))
    w /= np.sum(w)
    return float(np.sum(w * b / a)), float(np.sum(w * tau))


def moment_gates(label: str, sample: torch.Tensor) -> dict:
    """The gates of ``bench.py:1285-1296`` on a ``[C, n, 10]`` cube of the
    non-centered posterior: ``|E[mu] - exact| <= 0.25``, ``|E[exp(log_tau)]
    - exact| <= 0.4`` (the quadrature means), the mean split R-hat in
    [0.95, 1.05] and the smallest ESS at least ``0.002 C n``. Returns the
    measures; raises ``AssertionError`` naming the first gate that
    fails."""
    exact_mu, exact_tau = exact_posterior_means()
    c, n = sample.shape[:2]
    rhat, ess = split_rhat_mean_ess(sample)
    m = {"mu_hat": float(sample[..., 0].double().mean()),
         "tau_hat": float(sample[..., 1].double().exp().mean()),
         "rhat_mean": float(rhat.mean()), "ess_mean": float(ess.mean()),
         "ess_min": float(ess.min())}
    for gate, ok, info in (
            ("E[mu]", abs(m["mu_hat"] - exact_mu) <= 0.25,
             (m["mu_hat"], exact_mu)),
            ("E[tau]", abs(m["tau_hat"] - exact_tau) <= 0.4,
             (m["tau_hat"], exact_tau)),
            ("rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"]),
            ("ess floor", m["ess_min"] >= 0.002 * c * n, (m["ess_min"],
                                                          c * n))):
        if not ok:
            raise AssertionError(f"{label} {gate} gate failed: {info}")
    return m


def chees_adapted(device="cuda", n_chains: int = N_CHAINS,
                  n_adapt: int = 500, seed: int = 33) -> ChEESHMC:
    """The ChEES half of ``bench.py:1342-1372``: ``ChEESHMC`` on the
    non-centered posterior from ``init_with_seed(n_chains, 10, seed)`` at
    step size 0.2, ``warmed_up(n_adapt)`` (the step size and trajectory
    length adapted together). The bench then runs ``run(1024, 256)``
    twice and applies :func:`moment_gates`; after warm-up the sampler is
    fixed-cost HMC, about ``traj_len / (2 step_size)`` leapfrogs a draw."""
    return ChEESHMC(make_noncentered_target(),
                    init_with_seed(n_chains, 10, seed=seed, device=device),
                    step_size=0.2, seed=seed, device=device).warmed_up(n_adapt)


def _run_twice(target, chains, seed, n_collect, n_discard, device):
    """NUTS from ``init_with_seed(chains, 10, seed)`` at step size 0.8,
    run twice: the first run adapts (epsilon search + dual averaging) and
    burns in; the second is the steady state, whose per-run divergence
    delta (``last_run_divergences``) is the honest geometry diagnostic.
    Returns the second run's sample and its divergences a step."""
    tier = nuts_tier(device)
    s = NUTS(target, init_with_seed(chains, 10, seed=seed, device=device),
             0.8, device=device, **tier).seed(seed)
    s.run(n_collect, n_discard)
    sample = s.run(n_collect, n_discard)
    steps = chains * (n_collect + n_discard)
    # executed-leapfrog accounting, one gradient eval per leapfrog:
    # lockstep, every chain pays the deepest tree; fused, chain 0's own
    lf_per_draw = float(s.last_run_leapfrogs[0]) / (
        n_collect + n_discard - 1)
    print(f"    ({lf_per_draw:.0f} leapfrog grad evals per draw, "
          f"{'fused' if tier else 'lockstep'})")
    return sample, int(s.last_run_divergences.sum()) / steps


def noncentered_half(n_chains=32, n_collect=1000, n_discard=500,
                     device="cuda"):
    """The example's non-centered half (``eight_schools_nuts.py:172-185``
    and its four asserts, ``:195-199``): NUTS on the non-centered
    posterior, ``n_chains`` chains, seed 3, two runs; the second run's
    posterior means within 0.3 and 0.5 of the quadrature, its largest
    rank-normalized R-hat under 1.05 and its steady-state divergence rate
    under 0.5%. Returns ``(E[mu], E[tau])``."""
    exact_mu, exact_tau = exact_posterior_means()
    sample, rate_nc = _run_twice(make_noncentered_target(), n_chains, 3,
                                 n_collect, n_discard, device)
    flat = sample.reshape(-1, 10).double()
    mu_hat = float(flat[:, 0].mean())
    tau_hat = float(flat[:, 1].exp().mean())
    print(f"non-centered: E[mu]={mu_hat:.3f}  E[tau]={tau_hat:.3f}  "
          f"steady-state divergence rate={rate_nc:.2%}")
    print(run_stats(sample))
    modern = rank_normalized_diagnostics(sample)
    print(modern)
    # the one-stop per-parameter report for the interesting coordinates
    print(summary(sample[:, :, :2], param_names=("mu", "log_tau")))

    # Exact-moment gates (quadrature ground truth, generous MCSE margin).
    assert abs(mu_hat - exact_mu) < 0.3, (mu_hat, exact_mu)
    assert abs(tau_hat - exact_tau) < 0.5, (tau_hat, exact_tau)
    assert float(modern.rhat.max()) < 1.05
    assert rate_nc < 0.005, rate_nc  # non-centered: clean steady state
    return mu_hat, tau_hat


def centered_half(n_collect=1000, n_discard=500, device="cuda"):
    """The example's centered half (``eight_schools_nuts.py:187-193``):
    NUTS on the funnel parameterization, 16 chains, seed 5, two runs. The
    same posterior, but its per-run divergence delta stays high after
    adaptation, the signal to reparameterize or raise
    ``target_accept_p``. Returns the steady-state divergence rate."""
    _, rate_cen = _run_twice(make_centered_target(), 16, 5, n_collect,
                             n_discard, device)
    print(f"centered:     steady-state divergence rate={rate_cen:.2%} "
          "(funnel geometry)")
    return rate_cen


def main(n_chains=32, n_collect=1000, n_discard=500, device="cuda"):
    """The example (``eight_schools_nuts.py:150-200``): the quadrature's
    means, :func:`noncentered_half` (its asserts the example's four) and
    :func:`centered_half`. Returns ``(E[mu], E[tau])``. On CUDA NUTS
    takes its fused tier (:func:`~mini_mcmc_torch.examples.nuts_tier`):
    Kernel 4 runs the non-centered form's hand-written C++ and the
    centered form's traced from its batch form."""
    exact_mu, exact_tau = exact_posterior_means()
    print(f"exact:        E[mu]={exact_mu:.3f}  E[tau]={exact_tau:.3f}")
    out = noncentered_half(n_chains, n_collect, n_discard, device)
    centered_half(n_collect, n_discard, device)
    return out
