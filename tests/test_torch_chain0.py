"""Chain offsets in the kernels' plain twins: the draws of chain ``c`` of a
launch at ``chain0`` are global chain ``chain0 + c``'s.

For Kernels 2-8, two calls of a twin over the row ranges ``[0, s)`` (at
``chain0 = 0``) and ``[s, C)`` (at ``chain0 = s``) give one call's
outputs over ``[0, C)`` bit for bit, at the half and at an odd split
(a shard's first chain need not sit at a warp or block boundary of the
unsharded launch). Kernels 2, 3 and 8 take the offset in this port's
chain sharding; 4-7 took it before and are held here alike. At ``chain0 =
0`` Kernel 3's twin still equals ``make_pallas_subtree(interpret=True)``
(its hash lane is the chain index there); ``tests/test_torch_cuda.py``
holds the CUDA kernels to these twins and to the same splits on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.ops.kernels.gibbs_full import gibbs_multistep_plain
from mini_mcmc_torch.ops.kernels.hmc_full import hmc_multistep_plain
from mini_mcmc_torch.ops.kernels.hmc_sep import hmc_separable_step_plain
from mini_mcmc_torch.ops.kernels.mh_full import mh_multistep_plain
from mini_mcmc_torch.ops.kernels.nuts_full import nuts_step_plain
from mini_mcmc_torch.ops.kernels.nuts_subtree import subtree_plain
from mini_mcmc_torch.ops.kernels.pt_full import make_ladder, pt_multistep_plain

torch.set_num_threads(1)

C = 40
SPLITS = [C // 2, 13]
SEED, STEP = 0x5EED_0123_4567_89AB, 17
MEAN, COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


def _split(fn, rows, s):
    """``fn(row_slice, chain0)`` over ``[0, s)`` and ``[s, C)``, each
    output concatenated along its chain axis."""
    a, b = fn(slice(0, s), 0), fn(slice(s, rows), s)
    return a, b


def _cat(a, b, axis=0):
    return [torch.cat([x, y], dim=axis) for x, y in zip(a, b)]


def _equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _init(c, d, seed=3):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=(c, d)).astype(np.float32))


@pytest.mark.parametrize("s", SPLITS)
def test_kernel2_twin_split(s):
    t = mt.rosenbrock_nd()
    pos = _init(C, 3) * 0.5 + 1.0
    logp, grad = t.batch_logp_and_grad(pos)
    eps = torch.full((4,), 0.02)

    def run(rows, chain0):
        hist = torch.empty((4, pos[rows].shape[0], 3))
        out = hmc_multistep_plain(t, pos[rows], logp[rows], grad[rows], eps,
                                  5, SEED, STEP, hist, chain0=chain0)
        return [*out, hist]

    full = run(slice(0, C), 0)
    a, b = _split(run, C, s)
    _equal(full, _cat(a[:3], b[:3]) + _cat(a[3:], b[3:], 1))


@pytest.mark.parametrize("s", SPLITS)
@pytest.mark.parametrize("j", [2, 4])
def test_kernel3_twin_split(s, j):
    t = mt.diffable_gaussian2d(MEAN, COV)
    g = np.random.default_rng(j)
    pos = _init(C, 2, j) * 1.5
    mom = _init(C, 2, j + 1)
    lp, grad = t.batch_logp_and_grad(pos)
    joint0 = lp - 0.5 * (mom * mom).sum(1)
    logu = joint0 - torch.from_numpy(g.exponential(size=C).astype(
        np.float32))
    v = torch.from_numpy(np.where(g.uniform(size=C) < 0.5, -1, 1)).to(
        torch.int32)
    eps = torch.from_numpy(g.uniform(0.3, 1.2, size=C).astype(np.float32))
    active = torch.from_numpy(g.uniform(size=C) < 0.75)

    def run(rows, chain0):
        return list(subtree_plain(t, pos[rows], mom[rows], grad[rows],
                                  logu[rows], v[rows], j, eps[rows],
                                  joint0[rows], active[rows], (123, -456),
                                  10, chain0=chain0))

    full = run(slice(0, C), 0)
    a, b = _split(run, C, s)
    _equal(full, _cat(a, b))
    # the offset moves the hash: other lanes give other merges somewhere
    shifted = run(slice(0, C), 1)
    assert any(not torch.equal(x, y) for x, y in zip(full, shifted))


def test_kernel3_twin_at_chain0_zero_matches_jax_interpret():
    from mini_mcmc_tpu import models as jm
    from mini_mcmc_tpu.ops.pallas.nuts_subtree import make_pallas_subtree

    j, c = 2, 1024  # one JAX grid block: its lane id is the chain index
    g = np.random.default_rng(7)
    t = mt.diffable_gaussian2d(MEAN, COV)
    pos = _init(c, 2, 7) * 1.5
    mom = _init(c, 2, 8)
    lp, grad = t.batch_logp_and_grad(pos)
    joint0 = lp - 0.5 * (mom * mom).sum(1)
    logu = joint0 - torch.from_numpy(g.exponential(size=c).astype(
        np.float32))
    v = torch.from_numpy(np.where(g.uniform(size=c) < 0.5, -1, 1)).to(
        torch.int32)
    eps = torch.from_numpy(g.uniform(0.3, 1.2, size=c).astype(np.float32))
    active = torch.ones(c, dtype=torch.bool)
    seed = (123, -456)
    jt = jm.diffable_gaussian2d(MEAN, COV)
    fn = make_pallas_subtree(jt.grad_dc, jt.logp_dc, 10, interpret=True)
    f32 = jnp.float32
    want = fn(*(jnp.asarray(x.numpy(), f32) for x in
                (pos, mom, grad, logu)), jnp.asarray(v.numpy()),
              jnp.int32(j), jnp.asarray(eps.numpy(), f32),
              jnp.asarray(joint0.numpy(), f32), jnp.asarray(active.numpy()),
              jnp.asarray(seed, jnp.int32))
    got = subtree_plain(t, pos, mom, grad, logu, v, j, eps, joint0, active,
                        seed, 10, chain0=0)
    # the counts and flags exactly, the states to float32 rounding (the
    # tolerances of test_torch_nuts_kernels.py)
    for name in ("n", "s", "n_alpha", "diverged"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy().astype(np.int64),
            np.asarray(want[list(got._fields).index(name)]).astype(np.int64))
    for name in ("end_pos", "prop_pos", "prop_logp", "alpha"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(),
            np.asarray(want[list(got._fields).index(name)]),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", SPLITS)
def test_kernel4_twin_split(s):
    t = mt.diffable_gaussian2d(MEAN, COV)
    pos = _init(C, 2, 4) * 1.5
    eps = torch.full((C,), 0.7)

    def run(rows, chain0):
        return list(nuts_step_plain(t, pos[rows], eps[rows], 6, SEED, STEP,
                                    10, chain0))

    full = run(slice(0, C), 0)
    a, b = _split(run, C, s)
    _equal(full, _cat(a, b))


@pytest.mark.parametrize("s", SPLITS)
def test_kernel5_twin_split(s):
    t = mt.gaussian2d(MEAN, COV)
    prop = mt.isotropic_gaussian_proposal(1.0)
    pos = _init(C, 2, 5)
    logp = t.batch_logp(pos)

    def run(rows, chain0):
        hist = torch.empty((6, pos[rows].shape[0], 2))
        out = mh_multistep_plain(t, prop, pos[rows], logp[rows], SEED, STEP,
                                 6, hist, chain0=chain0)
        return [*out, hist]

    full = run(slice(0, C), 0)
    a, b = _split(run, C, s)
    _equal(full, _cat(a[:2], b[:2]) + _cat(a[2:], b[2:], 1))


@pytest.mark.parametrize("s", SPLITS)
def test_kernel6_twin_split(s):
    cond = mt.gaussian_mixture_conditional(-2.0, 1.0, 3.0, 1.5, 0.5)
    pos = _init(C, 2, 6)

    def run(rows, chain0):
        hist = torch.empty((6, pos[rows].shape[0], 2))
        out = gibbs_multistep_plain(cond, pos[rows], SEED, STEP, 6, hist,
                                    chain0=chain0)
        return [out, hist]

    full = run(slice(0, C), 0)
    a, b = _split(run, C, s)
    _equal(full, _cat(a[:1], b[:1]) + _cat(a[1:], b[1:], 1))


@pytest.mark.parametrize("s", SPLITS)
def test_kernel7_twin_split(s):
    t = mt.standard_normal()
    pos = _init(C, 64, 7)
    logp = t.batch_logp(pos)
    tables = pos.new_empty((0, 64))
    eps = torch.tensor([0.3])

    def run(rows, chain0):
        return list(hmc_separable_step_plain(t, pos[rows], logp[rows], eps,
                                             8, SEED, STEP, tables,
                                             chain0=chain0))

    full = run(slice(0, C), 0)
    a, b = _split(run, C, s)
    _equal(full, _cat(a, b))


@pytest.mark.parametrize("s", SPLITS)
@pytest.mark.parametrize("n_temps, n_inner", [(4, 1), (8, 2)])
def test_kernel8_twin_split(s, n_temps, n_inner):
    t = mt.gaussian2d(MEAN, COV)
    betas = mt.geometric_betas(n_temps, 0.05)
    lad = make_ladder(betas, 1.5, 2, "cpu")
    x = _init(C, 2, 8) * 2.0
    pos = x.T.unsqueeze(0).repeat(n_temps, 1, 1).contiguous()  # [T, D, C]
    logp = t.batch_logp(x).unsqueeze(0).repeat(n_temps, 1).contiguous()
    sa = torch.zeros((n_temps - 1, C))

    def run(rows, chain0):
        hist = torch.empty((4, pos[..., rows].shape[2], 2))
        out = pt_multistep_plain(
            t, pos[..., rows].contiguous(), logp[:, rows].contiguous(),
            sa[:, rows].contiguous(), 1, lad, SEED, STEP, 4, n_inner, hist,
            chain0=chain0)
        return [*out, hist]

    full = run(slice(0, C), 0)
    a, b = _split(run, C, s)
    _equal(full, _cat(a[:1], b[:1], 2) + _cat(a[1:3], b[1:3], 1)
           + _cat(a[3:], b[3:], 1))
