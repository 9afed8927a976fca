"""Kernels 3 and 4 (NUTS subtree, whole NUTS step): their plain PyTorch
twins against the JAX package on the same numpy inputs, and the
properties the kernels' draws are built on. The kernels themselves are
held against the twins on a CUDA device in tests/test_torch_cuda.py.

Tolerance: the Gaussian2D density is the JAX package's chains-on-lanes
form term for term, so the Kernel 3 twin follows
``make_pallas_subtree(interpret=True)`` to float32 rounding: counts and
flags exactly, floats within rtol 1e-5 / atol 1e-6 (both float32; the JAX
side is pinned to float32 since the suite enables x64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.ops.kernels import _build, rng
from mini_mcmc_torch.ops.kernels.nuts_full import (
    DOUBLING_DRAW,
    doubling_uniforms,
    merge_ordinal,
    merge_uniform,
    momentum_and_slice,
    nuts_step,
    nuts_step_plain,
)
from mini_mcmc_torch.ops.kernels.nuts_subtree import (
    hash_u24,
    hash_unit,
    popcount,
    subtree,
    subtree_plain,
    trailing_ones,
)
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.ops.pallas.nuts_subtree import (
    _hash_u24,
    _hash_unit,
    make_pallas_subtree,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
MAX_DEPTH = 10


def test_gaussian2d_matches_jax():
    x = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32) * 2
    jt = jm.diffable_gaussian2d(MEAN, COV)
    want_lp = np.asarray(jt.logp_dc(jnp.asarray(x.T)), np.float32)
    want_g = np.asarray(jt.grad_dc(jnp.asarray(x.T)), np.float32).T
    t = mt.diffable_gaussian2d(MEAN, COV)
    lp, g = t.batch_logp_and_grad(torch.from_numpy(x))
    np.testing.assert_array_equal(lp.numpy(), want_lp)
    np.testing.assert_array_equal(g.numpy(), want_g)
    # the matmul batch form of the JAX package, to float32 rounding
    jlp, jg = jt.batch_logp_and_grad(jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    assert t.cuda_functor == "gaussian2d"
    assert _build.functor_id(t) == 1
    assert len(t.cuda_params) == 7
    assert t.logp(torch.tensor([0.0, 1.0])) == pytest.approx(
        float(jt.logp(jnp.array([0.0, 1.0]))), rel=1e-6)


def test_hash_matches_jax_bit_for_bit():
    g = np.random.default_rng(1)
    n = 1 << 16
    s0, s1, ev, lane = (g.integers(-2**31, 2**31, n, dtype=np.int64)
                        for _ in range(4))
    ev[: n // 2] %= 11 * 1024  # the events a max_depth-10 subtree uses
    lane[: n // 2] %= 1 << 17
    want = np.asarray(_hash_u24(*(jnp.asarray(a, jnp.int32)
                                  for a in (s0, s1, ev, lane))))
    got = hash_u24(*(torch.from_numpy(a) for a in (s0, s1, ev, lane)))
    np.testing.assert_array_equal(got.numpy(), want)
    want_u = np.asarray(_hash_unit(*(jnp.asarray(a, jnp.int32)
                                     for a in (s0, s1, ev, lane))))
    got_u = hash_unit(*(torch.from_numpy(a) for a in (s0, s1, ev, lane)))
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    assert got_u.min() > 0 and got_u.max() < 1


def test_philox_host_words_match_the_tensor_twin():
    seed = 0x0123456789ABCDEF
    for counter in [(0, 0, 0, 0), (7, 3, 0x20000 + 4, 0), (2**32 - 1,) * 4]:
        host = rng.philox_words(*counter, seed)
        tens = rng.philox4x32_10(*(torch.tensor(c) for c in counter),
                                 rng.seed_words(seed))
        assert host == tuple(int(w) for w in tens)
    assert rng.philox_words(0, 0, 0, 0, 0) == (
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)


def _subtree_inputs(c, j, seed):
    """A random subtree call on the Gaussian: states near the mode with
    slice levels that most leaves pass, and a quarter of chains
    inactive."""
    g = np.random.default_rng(seed)
    t = mt.diffable_gaussian2d(MEAN, COV)
    pos = g.normal(size=(c, 2)).astype(np.float32) * 1.5 + [0.0, 1.0]
    mom = g.normal(size=(c, 2)).astype(np.float32)
    lp, grad = t.batch_logp_and_grad(torch.from_numpy(pos))
    joint0 = (lp.numpy() - 0.5 * (mom * mom).sum(1)).astype(np.float32)
    logu = (joint0 - g.exponential(size=c)).astype(np.float32)
    v = np.where(g.uniform(size=c) < 0.5, -1, 1).astype(np.int32)
    # past j = 4 the steps shrink, so that some 2^j-leaf trajectories span
    # no U-turn and the subtree continues on some chains
    eps = (g.uniform(0.3, 1.2, size=c) / 2 ** max(j - 4, 0)).astype(
        np.float32)
    eps[:8] = 30.0  # diverging chains
    active = g.uniform(size=c) < 0.75
    seed_words = tuple(int(w) for w in g.integers(-2**31, 2**31, 2))
    return dict(pos=pos, mom=mom, grad=grad.numpy(), logu=logu, v=v, j=j,
                eps=eps, joint0=joint0, active=active, seed=seed_words)


# a quarter of the chains inactive (ids 0-5), or all active, or none: an
# inactive chain still integrates and defines s, as in the JAX kernel, but
# its n, alpha, n_alpha and divergence flag stay 0
@pytest.mark.parametrize(
    "j, mask", [(j, None) for j in range(6)] + [(3, True), (3, False)],
    ids=[str(j) for j in range(6)] + ["3-all-active", "3-none-active"])
def test_subtree_twin_matches_jax_pallas_interpret(j, mask):
    c = 1024  # one JAX grid block: JAX's lane id is then the chain index
    a = _subtree_inputs(c, j, seed=100 + j)
    if mask is not None:
        a["active"] = np.full(c, mask)
    jt = jm.diffable_gaussian2d(MEAN, COV)
    fn = make_pallas_subtree(jt.grad_dc, jt.logp_dc, MAX_DEPTH,
                             interpret=True)
    f32 = jnp.float32
    want = fn(jnp.asarray(a["pos"], f32), jnp.asarray(a["mom"], f32),
              jnp.asarray(a["grad"], f32), jnp.asarray(a["logu"], f32),
              jnp.asarray(a["v"], jnp.int32), jnp.int32(j),
              jnp.asarray(a["eps"], f32), jnp.asarray(a["joint0"], f32),
              jnp.asarray(a["active"]),
              jnp.asarray(a["seed"], jnp.int32))
    want = [np.asarray(x) for x in want]

    launches, calls = subtree.launches, subtree_plain.calls
    got = subtree(
        mt.diffable_gaussian2d(MEAN, COV),
        *(torch.from_numpy(a[k]) for k in ("pos", "mom", "grad", "logu")),
        torch.from_numpy(a["v"]), j, torch.from_numpy(a["eps"]),
        torch.from_numpy(a["joint0"]), torch.from_numpy(a["active"]),
        a["seed"], MAX_DEPTH)
    assert (subtree.launches, subtree_plain.calls) == (launches, calls + 1)
    got = [x.numpy() for x in got]
    names = ("end_pos", "end_mom", "end_grad", "prop_pos", "prop_grad",
             "prop_logp", "n", "s", "alpha", "n_alpha", "diverged")
    w, gt = dict(zip(names, want)), dict(zip(names, got))
    for k in ("n", "s", "n_alpha", "diverged"):
        np.testing.assert_array_equal(gt[k], w[k], err_msg=k)
    np.testing.assert_allclose(gt["alpha"], w["alpha"], rtol=RTOL, atol=ATOL)
    # a chain that stopped (s false) is not read past its stop; the JAX
    # kernel integrates it on, the twin may stop early
    s = w["s"]
    assert s.any() and (~s).any()
    if mask is False:
        for k in ("n", "alpha", "n_alpha", "diverged"):
            assert not gt[k].any(), k
    else:
        assert w["diverged"].any()
    for k in names[:6]:
        np.testing.assert_allclose(gt[k][s], w[k][s], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _step_inputs(c, seed):
    g = np.random.default_rng(seed)
    pos = torch.from_numpy(
        (g.normal(size=(c, 2)) * [2.0, 1.7] + [0.0, 1.0]).astype(np.float32))
    eps = torch.from_numpy(g.uniform(0.4, 1.4, size=c).astype(np.float32))
    return pos, eps


def test_nuts_step_depends_on_key_step_and_chain_alone():
    t = mt.diffable_gaussian2d(MEAN, COV)
    pos, eps = _step_inputs(256, seed=3)
    key, step = 0xDEADBEEF12345678, 41
    full = nuts_step_plain(t, pos, eps, MAX_DEPTH, key, step, MAX_DEPTH)
    depth = int(full[4].max())
    assert 1 <= depth < MAX_DEPTH
    # the cap at the depth actually reached changes nothing
    capped = nuts_step_plain(t, pos, eps, depth, key, step, MAX_DEPTH)
    for a, b in zip(full, capped):
        assert torch.equal(a, b)
    # two halves, each with its chain offset, give the same chains
    h = 128
    lo = nuts_step_plain(t, pos[:h], eps[:h], MAX_DEPTH, key, step,
                         MAX_DEPTH)
    hi = nuts_step_plain(t, pos[h:], eps[h:], MAX_DEPTH, key, step,
                         MAX_DEPTH, chain0=h)
    for a, b, c in zip(full, lo, hi):
        assert torch.equal(a, torch.cat([b, c]))
    # another step or key moves the chains differently
    other = nuts_step_plain(t, pos, eps, MAX_DEPTH, key, step + 1, MAX_DEPTH)
    assert not torch.equal(other[0], full[0])
    other = nuts_step_plain(t, pos, eps, MAX_DEPTH, key + 1, step, MAX_DEPTH)
    assert not torch.equal(other[0], full[0])
    assert torch.isfinite(full[0]).all()
    assert ((full[1] >= 0) & (full[1] <= full[2])).all()


def test_depth_is_each_chains_own_doubling_count():
    t = mt.diffable_gaussian2d(MEAN, COV)
    pos, eps = _step_inputs(512, seed=11)
    for depth_limit in (MAX_DEPTH, 3):
        details = {}
        got = nuts_step_plain(t, pos, eps, depth_limit, 0xABCD, 5, MAX_DEPTH,
                              details=details)
        depth, leaves = details["depth"], details["leaves"]
        assert depth.dtype == torch.int32
        assert torch.equal(got[4], depth.to(torch.float32))
        assert int(depth.min()) >= 1 and int(depth.max()) <= depth_limit
        # a chain integrates every leaf of its complete doublings and at
        # least one of its last: 2^(depth-1) <= leaves <= 2^depth - 1
        assert (leaves >= 2 ** (depth - 1)).all()
        assert (leaves <= 2 ** depth - 1).all()
        # chains of one warp of 32 keep their own depths
        per_warp = depth.reshape(-1, 32)
        assert (per_warp != per_warp[:, :1]).any(dim=1).all()


def _words(chain, step, draw, sub, seed):
    return [int(w) for w in rng.philox4x32_10(
        torch.tensor([chain]), step, draw, sub, rng.seed_words(seed))]


@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_step_draws_follow_the_counter_layout(dim):
    seed, step = 0x0123456789ABCDEF, 77
    chain = torch.arange(3, 9)
    mom, u_slice = momentum_and_slice(chain, step, dim, seed)
    assert mom.shape == (6, dim) and u_slice.shape == (6,)
    for row, c in enumerate(chain.tolist()):
        w = [torch.tensor(x) for x in _words(c, step, 0, 0, seed)]
        normals = rng.box_muller_pair(w[0], w[1]) + rng.box_muller_pair(
            w[2], w[3])
        for d in range(dim):
            assert torch.equal(mom[row, d], normals[d])
        # the slice: word z of draw 0 beside at most two momenta, else
        # word x of draw 1 (one quad of momenta)
        bits = w[2] if dim <= 2 else torch.tensor(
            _words(c, step, 1, 0, seed)[0])
        assert torch.equal(u_slice[row], rng.unit_open(bits))
        for j in (0, 3):
            w = _words(c, step, DOUBLING_DRAW + j, 0, seed)
            coin, accept = doubling_uniforms(chain, step, j, seed)
            assert torch.equal(coin[row], rng.unit_open(torch.tensor(w[0])))
            assert torch.equal(accept[row],
                               rng.unit_open(torch.tensor(w[1])))


@pytest.mark.parametrize("j", [1, 2, 5])
def test_merge_uniforms_are_four_to_an_evaluation(j):
    seed, step, chain = 0xFEEDFACE, 12, torch.arange(4)
    # the ordinals of a doubling's merges are 0..2^j - 2, each once, in
    # the order the leaves' cascades take them
    order = [merge_ordinal(i, k) for i in range(1 << j)
             for k in range(trailing_ones(i))]
    assert order == list(range((1 << j) - 1))
    assert merge_ordinal(5, 0) == 5 - popcount(5)
    for i in range(1 << j):
        for k in range(trailing_ones(i)):
            o = merge_ordinal(i, k)
            got = merge_uniform(chain, step, j, i, k, seed)
            for c in chain.tolist():
                w = _words(c, step, DOUBLING_DRAW + j, 1 + o // 4, seed)
                assert torch.equal(got[c], rng.unit_open(torch.tensor(
                    w[o % 4])))


def test_wrappers_run_twins_on_cpu_and_check_dtype():
    t = mt.diffable_gaussian2d(MEAN, COV)
    pos, eps = _step_inputs(64, seed=5)
    launches, calls = nuts_step.launches, nuts_step_plain.calls
    a = nuts_step(t, pos, eps, 6, 7, 0, MAX_DEPTH)
    b = nuts_step_plain(t, pos, eps, 6, 7, 0, MAX_DEPTH)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert nuts_step.launches == launches
    assert nuts_step_plain.calls == calls + 2
    with pytest.raises(ValueError, match="float32"):
        nuts_step(t, pos.double(), eps.double(), 6, 7, 0, MAX_DEPTH)
