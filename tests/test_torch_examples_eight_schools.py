"""The eight-schools example's non-centered half on the CPU at the JAX
example's defaults (``examples/eight_schools_nuts.py:150-199``): 32
chains, seed 3, ``run(1000, 500)`` twice on the lockstep NUTS tier. Its
asserts are the JAX example's four. The centered half runs in
``test_torch_examples.py``, so that the two take two workers."""

from mini_mcmc_torch.examples import eight_schools as es


def test_eight_schools_noncentered_half_at_the_jax_defaults():
    """The quadrature means within 0.3 and 0.5, the largest
    rank-normalized R-hat under 1.05 and the steady-state divergence rate
    under 0.5% (asserted inside the half), and ``(E[mu], E[tau])``
    returned."""
    mu_hat, tau_hat = es.noncentered_half(device="cpu")
    exact_mu, exact_tau = es.exact_posterior_means()
    assert abs(mu_hat - exact_mu) < 0.3 and abs(tau_hat - exact_tau) < 0.5
