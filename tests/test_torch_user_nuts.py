"""Kernels 3 and 4 at D = 10 on eight schools (a user density): the
Kernel 3 twin against the JAX package's subtree kernel in interpret mode on
the example's chains-on-lanes forms, Kernel 4's draw layout above one quad
of momenta pinned to Philox words, and the fused NUTS tier's twin on the
three CUDA forms of the target. The kernels themselves are held against
these twins on the card in tests/test_torch_cuda.py.

Tolerances are those of tests/test_pallas.py:386-436: end positions within
rtol 1e-4 / atol 1e-5, n_alpha exactly, s on more than 99% of chains (the
JAX test holds its XLA builder to its kernel; here the port's twin, which
draws the same merge hash, to the kernel, so n agrees as well).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.examples import eight_schools as es
from mini_mcmc_torch.ops.kernels import rng
from mini_mcmc_torch.ops.kernels.nuts_full import (
    momentum_and_slice,
    nuts_step_plain,
)
from mini_mcmc_torch.ops.kernels.nuts_subtree import subtree
from mini_mcmc_tpu.ops.pallas.nuts_subtree import make_pallas_subtree

ROOT = Path(__file__).resolve().parents[1]


def _jax_eight_schools():
    spec = importlib.util.spec_from_file_location(
        "es8", ROOT / "examples" / "eight_schools_nuts.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_noncentered_target()


def test_subtree_twin_at_d10_matches_jax_pallas_interpret():
    """tests/test_pallas.py:386-436's inputs (1,024 chains near the mode,
    j = 2, max_depth 6, eps 0.05) through the port's Kernel 3 twin on the
    port's eight-schools target and JAX's kernel on the example's forms."""
    jt = _jax_eight_schools()
    c, d = 1024, 10
    key = jax.random.PRNGKey(5)
    f32 = jnp.float32
    pos = 0.5 * jax.random.normal(key, (c, d), f32)
    mom = jax.random.normal(jax.random.fold_in(key, 1), (c, d), f32)
    grad = jax.vmap(jax.grad(jt.logp))(pos)
    joint0 = jt.logp_batch(pos) - 0.5 * jnp.sum(mom * mom, axis=1)
    logu = joint0 - 1.0
    v = jnp.where(jax.random.uniform(jax.random.fold_in(key, 2), (c,))
                  < 0.5, -1, 1).astype(jnp.int32)
    eps = jnp.full((c,), 0.05, f32)
    active = jnp.ones((c,), bool)
    sub = make_pallas_subtree(jt.grad_dc, jt.logp_dc, 6, interpret=True)
    want = [np.asarray(x) for x in sub(
        pos, mom, grad, logu, v, jnp.int32(2), eps, joint0, active,
        jnp.zeros(2, jnp.int32))]

    def t(x):
        return torch.from_numpy(np.array(x))

    got = subtree(es.make_noncentered_target(), t(pos), t(mom), t(grad),
                  t(logu), t(v), 2, t(eps), t(joint0), t(active), (0, 0), 6)
    got = [x.numpy() for x in got]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[9], want[9])  # n_alpha
    assert np.mean(got[7] == want[7]) > 0.99  # s
    assert np.mean(got[6] == want[6]) > 0.99  # n


def _words(chain, step, draw, seed):
    return [torch.tensor(int(w)) for w in rng.philox4x32_10(
        torch.tensor([chain]), step, draw, 0, rng.seed_words(seed))]


@pytest.mark.parametrize("dim", [5, 6, 8, 10, 12, 16])
def test_step_draws_above_one_quad_follow_the_counter_layout(dim):
    """Kernel 4 at D > 4: draw q gives momenta 4q..4q+3 (words x, y the
    cosine and sine of one Box-Muller pair, z, w of the next), draw
    ceil(D / 4)'s word x the slice uniform."""
    seed, step = 0x0123456789ABCDEF, 77
    chain = torch.arange(5, 9)
    mom, u_slice = momentum_and_slice(chain, step, dim, seed)
    assert mom.shape == (4, dim)
    q = (dim + 3) // 4
    for row, c in enumerate(chain.tolist()):
        normals = []
        for k in range(q):
            w = _words(c, step, k, seed)
            normals += rng.box_muller_pair(w[0], w[1]) + rng.box_muller_pair(
                w[2], w[3])
        for i in range(dim):
            assert torch.equal(mom[row, i], normals[i])
        assert torch.equal(u_slice[row], rng.unit_open(
            _words(c, step, q, seed)[0]))


def test_nuts_step_twin_at_d10_is_a_function_of_key_step_and_chain():
    t = es.make_noncentered_target()
    g = np.random.default_rng(4)
    pos = torch.from_numpy((0.5 * g.standard_normal((128, 10))).astype(
        np.float32))
    eps = torch.full((128,), 0.3)
    key, step = 0xDEADBEEF12345678, 3
    full = nuts_step_plain(t, pos, eps, 10, key, step, 10)
    lo = nuts_step_plain(t, pos[:64], eps[:64], 10, key, step, 10)
    hi = nuts_step_plain(t, pos[64:], eps[64:], 10, key, step, 10, chain0=64)
    for a, b, c in zip(full, lo, hi):
        assert torch.equal(a, torch.cat([b, c]))
    assert torch.isfinite(full[0]).all() and int(full[4].min()) >= 1


@pytest.mark.parametrize("form", es.CUDA_FORMS)
def test_fused_nuts_twin_runs_each_cuda_form(form):
    """NUTS(use_pallas="full") on the CPU runs Kernel 4's twin on the
    batch form whatever the CUDA form: the three give the same draws."""
    x = mt.init_with_seed(64, 10, seed=35, device="cpu")
    s = mt.NUTS(es.make_noncentered_target(form), x, 0.9, seed=35,
                use_pallas="full", device="cpu")
    out = s.run(8, 8)
    ref = mt.NUTS(es.make_noncentered_target("hand"), x, 0.9, seed=35,
                  use_pallas="full", device="cpu").run(8, 8)
    assert torch.equal(out, ref) and torch.isfinite(out).all()
