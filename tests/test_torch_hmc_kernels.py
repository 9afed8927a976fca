"""Kernels 1 and 2 (leapfrog trajectory, K-step fused HMC): their plain
PyTorch twins against the JAX package on the same numpy inputs. The
kernels themselves are held against the twins on a CUDA device in
tests/test_torch_cuda.py.

Tolerance: rtol 1e-3, atol 1e-4, as tests/test_pallas.py:56 holds the
Pallas trajectory against the XLA leapfrog (float32, different operation
fusion on each side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_mcmc_torch.models import Target, rosenbrock_nd
from mini_mcmc_torch.ops.kernels import _build, hmc_full, rng
from mini_mcmc_torch.ops.kernels.hmc import (
    check_state,
    leapfrog_trajectory,
    leapfrog_trajectory_plain,
)
from mini_mcmc_torch.ops.kernels.hmc_full import (
    hmc_multistep,
    hmc_multistep_plain,
)
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models.base import Target as JaxTarget
from mini_mcmc_tpu.ops.pallas.hmc import make_pallas_leapfrog

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _state(c, d, seed):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((c, d)) * 0.3 + 0.9).astype(np.float32)
    mom = rng.standard_normal((c, d)).astype(np.float32)
    return pos, mom


def test_plain_leapfrog_matches_jax_pallas_and_xla():
    eps, n_leapfrog = 0.02, 7
    pos, mom = _state(16, 3, seed=1)
    jt = jm.rosenbrock_nd()
    jpos, jmom = jnp.asarray(pos), jnp.asarray(mom)
    _, jgrad = jt.batch_logp_and_grad(jpos)
    traj = make_pallas_leapfrog(jt.grad_dc, jt.logp_dc, eps, n_leapfrog,
                                interpret=True)
    want_pallas = traj(jpos, jmom, jgrad, jnp.float32(eps))
    # the XLA leapfrog of mini_mcmc_tpu/ops/hmc.py:170-190, written out
    x, m, g = jpos, jmom, jgrad
    for _ in range(n_leapfrog):
        m = m + 0.5 * eps * g
        x = x + eps * m
        _, g = jt.batch_logp_and_grad(x)
        m = m + 0.5 * eps * g
    want_xla = (x, m, jt.batch_logp(x), g)

    launches = leapfrog_trajectory.launches
    got = leapfrog_trajectory(
        rosenbrock_nd(), torch.from_numpy(pos), torch.from_numpy(mom),
        torch.from_numpy(np.array(jgrad, np.float32)),
        torch.tensor(eps), n_leapfrog)
    assert leapfrog_trajectory.launches == launches  # CPU: the plain twin
    for a, b, c in zip(got, want_pallas, want_xla):
        assert a.dtype == torch.float32
        _close(a, b)
        _close(a, c)


def _jax_inf_target():
    """Rosenbrock3D with logp = -inf for x0 >= 2, in the JAX package."""
    base = jm.rosenbrock_nd()

    def logp_batch(p):
        return jnp.where(p[:, 0] < 2.0, base.logp_batch(p), -jnp.inf)

    def logp_dc(p):
        return jnp.where(p[0] < 2.0, base.logp_dc(p), -jnp.inf)

    return JaxTarget(logp=base.logp, logp_batch=logp_batch, grad=base.grad,
                     logp_dc=logp_dc, grad_dc=base.grad_dc)


def _port_inf_target():
    base = rosenbrock_nd()

    def logp(p):
        return torch.where(p[..., 0] < 2.0, base.logp(p),
                           torch.tensor(-float("inf")))

    return Target(logp=logp, grad=base.grad)


def test_plain_multistep_matches_jax_composition():
    """hmc_multistep_plain with given momentum/uniforms/eps against
    make_pallas_leapfrog(interpret=True) composed with the accept of
    mini_mcmc_tpu/ops/pallas/hmc_full.py:139,154-160 (that kernel's
    hardware PRNG has no CPU lowering). Chain 0 proposes into the -inf
    region and chain 1 diverges: both must be rejected, finite, and the
    rest must follow the JAX composition."""
    c, d, k_steps, n_leapfrog = 32, 3, 6, 5
    rng = np.random.default_rng(7)
    pos, _ = _state(c, d, seed=7)
    pos[0] = [1.95, 3.8, 14.4]
    mom = rng.standard_normal((k_steps, c, d)).astype(np.float32)
    mom[:, 0, 0] = 40.0  # x0 crosses 2 within the trajectory
    mom[:, 1] = 1e4  # the trajectory overflows
    u = rng.uniform(1e-6, 1.0, (k_steps, c)).astype(np.float32)
    eps = (0.02 * (1 + 0.3 * rng.uniform(-1, 1, k_steps))).astype(np.float32)

    jt = _jax_inf_target()
    traj = make_pallas_leapfrog(jt.grad_dc, jt.logp_dc, 0.02, n_leapfrog,
                                interpret=True)
    jpos = jnp.asarray(pos)
    jlogp, jgrad = jt.batch_logp_and_grad(jpos)
    jlogp, jgrad = jlogp.astype(jnp.float32), jgrad.astype(jnp.float32)
    want_hist, want_acc = [], []
    for k in range(k_steps):
        m = jnp.asarray(mom[k])
        h_cur = -jlogp + 0.5 * jnp.sum(m * m, axis=1)
        p, mp, lp, g = traj(jpos, m, jgrad, jnp.float32(eps[k]))
        h_prop = -lp + 0.5 * jnp.sum(mp * mp, axis=1)
        acc = (h_cur - h_prop) >= jnp.log(jnp.asarray(u[k]))
        jpos = jnp.where(acc[:, None], p, jpos)
        jgrad = jnp.where(acc[:, None], g, jgrad)
        jlogp = jnp.where(acc, lp, jlogp)
        want_hist.append(np.asarray(jpos))
        want_acc.append(np.asarray(acc))

    t = _port_inf_target()
    tpos = torch.from_numpy(pos)
    tlogp, tgrad = t.batch_logp_and_grad(tpos)
    hist = torch.empty((k_steps, c, d))
    out = hmc_multistep_plain(t, tpos, tlogp, tgrad, torch.from_numpy(eps),
                              n_leapfrog, seed=0, step0=0, hist=hist,
                              mom=torch.from_numpy(mom),
                              u=torch.from_numpy(u))
    want_acc = np.stack(want_acc)
    assert not want_acc[:, :2].any()  # the -inf and diverging proposals
    assert want_acc.any() and not want_acc.all()
    np.testing.assert_array_equal(hist[:, :2].numpy(),
                                  np.broadcast_to(pos[:2], (k_steps, 2, d)))
    assert torch.isfinite(hist).all()
    assert all(torch.isfinite(x).all() for x in out)
    _close(hist, np.stack(want_hist))
    _close(out[0], jpos)
    _close(out[1], jlogp)
    _close(out[2], jgrad)


def test_multistep_stream_does_not_depend_on_block_split():
    pos, _ = _state(64, 3, seed=3)
    t = rosenbrock_nd()
    x = torch.from_numpy(pos)
    lp, g = t.batch_logp_and_grad(x)
    eps = torch.full((8,), 0.02)
    one = torch.empty((8, 64, 3))
    a = hmc_multistep(t, x, lp, g, eps, 4, 0xABCDEF12345, 10, one)
    two = torch.empty((8, 64, 3))
    s = hmc_multistep(t, x, lp, g, eps[:4], 4, 0xABCDEF12345, 10, two[:4])
    b = hmc_multistep(t, *s, eps[4:], 4, 0xABCDEF12345, 14, two[4:])
    assert torch.equal(one, two)
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    # a different seed moves the chains differently
    other = torch.empty((8, 64, 3))
    hmc_multistep(t, x, lp, g, eps, 4, 0xABCDEF12346, 10, other)
    assert not torch.equal(one, other)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_multistep_twin_draws_the_stream_words(d):
    """Kernel 2's twin draws one word stream per (chain, step)
    (``rng.stream_words``): normals 2p and 2p + 1 the cosine and sine of
    one Box-Muller angle on words 2p and 2p + 1, the accept uniform word
    2 ceil(D / 2): one Philox evaluation a step at D = 2, two at D = 3, 4.
    The block drawn in the twin equals the block given those words."""
    pos, _ = _state(64, d, seed=20 + d)
    t = rosenbrock_nd()
    x = torch.from_numpy(pos)
    lp, g = t.batch_logp_and_grad(x)
    k, seed, step0 = 3, 0xC0FFEE_1234, 7
    eps = torch.full((k,), 0.02)
    accept_word = 2 * ((d + 1) // 2)
    words = [rng.stream_words(64, accept_word + 1, step0 + i, seed)
             for i in range(k)]
    assert all(w.shape == (64, 4 if d == 2 else 8) for w in words)
    mom = torch.stack([rng.pair_normals(w, d) for w in words])
    u = torch.stack([rng.unit_open(w[:, accept_word]) for w in words])
    for p in range((d + 1) // 2):
        cos, sin = rng.box_muller_pair(words[0][:, 2 * p],
                                       words[0][:, 2 * p + 1])
        assert torch.equal(mom[0, :, 2 * p], cos)
        if 2 * p + 1 < d:
            assert torch.equal(mom[0, :, 2 * p + 1], sin)
    drawn, given = torch.empty((k, 64, d)), torch.empty((k, 64, d))
    a = hmc_multistep_plain(t, x, lp, g, eps, 4, seed, step0, drawn)
    b = hmc_multistep_plain(t, x, lp, g, eps, 4, seed, step0, given,
                            mom=mom, u=u)
    assert torch.equal(drawn, given)
    for p_, q_ in zip(a, b):
        assert torch.equal(p_, q_)
    assert (drawn != x[None]).any()  # the block moved chains


def test_multistep_writes_chain_major_views():
    pos, _ = _state(8, 3, seed=4)
    t = rosenbrock_nd()
    x = torch.from_numpy(pos)
    lp, g = t.batch_logp_and_grad(x)
    eps = torch.full((4,), 0.02)
    tm = torch.empty((4, 8, 3))
    hmc_multistep(t, x, lp, g, eps, 3, 99, 0, tm)
    cm = torch.empty((8, 4, 3))
    hmc_multistep(t, x, lp, g, eps, 3, 99, 0, cm.transpose(0, 1))
    assert torch.equal(cm.transpose(0, 1), tm)


def test_wrappers_run_plain_twins_on_cpu():
    pos, mom = _state(8, 3, seed=5)
    t = rosenbrock_nd()
    x = torch.from_numpy(pos)
    lp, g = t.batch_logp_and_grad(x)
    n_lf, n_ms = leapfrog_trajectory.launches, hmc_multistep.launches
    calls = hmc_multistep_plain.calls
    a = leapfrog_trajectory(t, x, torch.from_numpy(mom), g,
                            torch.tensor(0.02), 3)
    b = leapfrog_trajectory_plain(t, x, torch.from_numpy(mom), g,
                                  torch.tensor(0.02), 3)
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    hmc_multistep(t, x, lp, g, torch.full((2,), 0.02), 3, 1, 0)
    assert hmc_multistep_plain.calls == calls + 1
    assert (leapfrog_trajectory.launches, hmc_multistep.launches) == (n_lf,
                                                                      n_ms)


def test_functor_lookup_names_the_roadmap_item():
    assert _build.functor_id(rosenbrock_nd()) == 0
    # no built-in functor: the message names the user routes
    with pytest.raises(ValueError, match="Target.cuda_source"):
        _build.functor_id(Target(logp=rosenbrock_nd().logp))
    with pytest.raises(ValueError, match="unknown"):
        _build.functor_id(Target(logp=lambda p: p, cuda_functor="nope"))


def test_kernel_input_validation():
    x = torch.zeros((4, 3))
    tier = hmc_full.TIER
    check_state(x, torch.zeros(4), torch.zeros((4, 3)), tier=tier)
    with pytest.raises(ValueError, match="D in"):
        check_state(torch.zeros((4, 5)), tier=tier)
    with pytest.raises(ValueError, match="float32"):
        check_state(x, torch.zeros(4, dtype=torch.float64), tier=tier)
    with pytest.raises(ValueError, match="contiguous"):
        check_state(x, torch.zeros((3, 4)).t(), tier=tier)
    with pytest.raises(ValueError, match=r"\[C, D\]"):
        check_state(torch.zeros(4), tier=tier)
