"""User densities in the tempering kernel (Kernel 8): the value-only
library's density (``Target.cuda_source``, or the C++ traced from the
batch form, ``logaddexp`` included) built for the host with ``g++``
against the JAX package's chains-on-lanes form, the twin's draw layout
past D = 2, and the tempering sampler with a user density against the
JAX package's XLA tier.

Tolerances: the density's value at rtol 3e-4 with atol 1e-4 x max(|want|,
1) (the JAX ``validate_dc_forms`` rule); ``logaddexp`` of infinite
operands exactly as ``torch.logaddexp``; the draws bit for bit (both are
Philox by place); the mode weight within 0.05 and the mode's mean and
standard deviation within 0.05 for both packages (bench.py:890-898's
gates).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
import mini_mcmc_tpu as jmt
from mini_mcmc_torch.examples import user_forms as F
from mini_mcmc_torch.models import Target
from mini_mcmc_torch.models.base import validate_dc_forms
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels import user_density as U
from mini_mcmc_torch.ops.kernels.pt_full import pt_draws, pt_instance
from mini_mcmc_tpu import models as jm

RTOL, ATOL = 3e-4, 1e-4
W_PLUS = 0.7


def _jax_bimodal():
    lw0, lw1 = math.log(1 - W_PLUS), math.log(W_PLUS)

    def logp(x):  # bench.py:863-876, on the rows of a batch
        a = lw0 - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = lw1 - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return jnp.logaddexp(a, b)

    return jm.Target(logp=logp, logp_batch=logp)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


@pytest.mark.parametrize("dim", [1, 2, 5, 10, 16])
@pytest.mark.parametrize("hand", [True, False], ids=["hand", "traced"])
def test_bimodal_values_match_the_jax_dc_form(dim, hand):
    """bench.py's logaddexp density, traced through the generator's
    logaddexp and as the hand source, at every D (it reads x0)."""
    g = np.random.default_rng(dim)
    x = (8.0 * g.standard_normal((64, dim))).astype(np.float32)
    t = F.bimodal(W_PLUS, hand=hand)
    if not hand:
        assert "mm::logaddexp" in U.derive_logp_dc(t, dim)[0]
    lp, _ = U.probe(t, torch.from_numpy(x), need_grad=False)
    want = np.asarray(_jax_bimodal().dc_forms()[0](jnp.asarray(x.T)))
    _close(lp, want, f"D={dim}")
    # the dual-number gradient of logaddexp too (Kernels 1-4's route)
    lp, grad = U.probe(t, torch.from_numpy(x))
    _, want_g = t.batch_logp_and_grad(torch.from_numpy(x))
    _close(grad, want_g, "grad")


def test_logaddexp_of_infinite_operands_is_torchs():
    """-inf with -inf gives -inf, -inf with a number the number, +inf
    with anything +inf: the traced C++ against torch.logaddexp."""
    def logp(x):
        return torch.logaddexp(torch.log(x[..., 0]), torch.log(x[..., 1]))

    t = Target(logp=logp)
    x = torch.tensor([[0.0, 0.0], [0.0, 2.0], [3.0, 0.0], [1.0, 1.0],
                      [math.inf, 0.5], [0.5, 4.0]])
    lp, _ = U.probe(t, x, need_grad=False)
    want = logp(x)
    assert torch.equal(torch.isinf(lp), torch.isinf(want))
    finite = torch.isfinite(want)
    assert torch.equal(lp[~finite], want[~finite])
    _close(lp[finite], want[finite], "finite")


def test_twin_draw_layout_past_d2():
    """pt_draws: normals 2p and 2p + 1 of rung t from words x, y of draw
    p T + t (Box-Muller cosine and sine), accept and swap uniforms from
    draw t's words z and w; D = 1 and 2 take draw t alone."""
    c, t, seed, step = 16, 8, 0x5EED_5A5A, 3
    key = rng.seed_words(seed)
    for dim in (1, 2, 5):
        noises, us, u_swap = pt_draws(c, t, dim, 2, step, seed)
        for i in range(2):
            assert noises[i].shape == (t, dim, c)
            chain = torch.arange(c)
            for r in range(t):
                for p in range((dim + 1) // 2):
                    w = rng.philox4x32_10(chain, step, p * t + r, i, key)
                    cos, sin = rng.box_muller_pair(w[0], w[1])
                    assert torch.equal(noises[i][r, 2 * p], cos)
                    if 2 * p + 1 < dim:
                        assert torch.equal(noises[i][r, 2 * p + 1], sin)
                    if p == 0:
                        assert torch.equal(us[i][r], rng.unit_open(w[2]))
                        if i == 0 and r < t - 1:
                            assert torch.equal(u_swap[r],
                                               rng.unit_open(w[3]))


def test_tempering_with_a_user_density_passes_the_gates_of_the_jax_xla_path():
    """bench.py's tempering stage shrunk to 512 chains: the port's fused
    tier's twin on the traced bimodal density, the JAX package's XLA tier
    on its own; both pass the mode gates."""
    betas = jmt.geometric_betas(8, 0.01)
    x0 = np.full((512, 1), -8.0, np.float32)
    pt = mt.ParallelTempering(F.bimodal(W_PLUS), torch.from_numpy(x0),
                              betas=betas, proposal_std=1.0,
                              steps_per_call=16, use_pallas="full",
                              device="cpu").seed(5)
    pt.run(512, 0)
    port = pt.run(1024, 0).reshape(-1).double()
    jpt = jmt.ParallelTempering(_jax_bimodal(), jnp.asarray(x0), betas=betas,
                                proposal_std=1.0, steps_per_call=16).seed(5)
    jpt.run(512, 0)
    jax_x = torch.from_numpy(np.array(jpt.run(1024, 0))).reshape(-1).double()
    for what, xs in (("port", port), ("jax", jax_x)):
        plus = xs[xs > 0]
        assert abs(float((xs > 0).double().mean()) - W_PLUS) <= 0.05, what
        assert abs(float(plus.mean()) - 8.0) <= 0.05, what
        assert abs(float(plus.std()) - 0.5) <= 0.05, what
    assert bool((pt.swap_acceptance > 0.05).all())


def test_user_densities_are_accepted_and_validated():
    t = F.bimodal(W_PLUS)
    assert pt_instance(t, 8, 1) == -1 and pt_instance(t, 16, 16) == -1
    with pytest.raises(ValueError, match="at most 16 rungs"):
        pt_instance(t, 17, 1)
    x = torch.linspace(-10, 10, 64).reshape(-1, 1)
    validate_dc_forms(F.bimodal(W_PLUS, hand=True), x, need_grad=False)
    wrong = Target(logp=t.logp, cuda_source=F.BIMODAL_SOURCE,
                   cuda_params=(math.log(W_PLUS), math.log(1 - W_PLUS)))
    with pytest.raises(ValueError, match="compiled logp"):
        validate_dc_forms(wrong, x, need_grad=False)
