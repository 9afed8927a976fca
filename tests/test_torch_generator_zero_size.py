"""Zero-size values in the C++ generator (``ops/kernels/user_density.py``):
a value of numel 0 carries no array and emits no loop, and a sum (or a
matmul) over an empty extent is ``S(0)``. The traced banded Gaussian at
D = 1, whose neighbour sum ``z[..., :-1] * z[..., 1:]`` is two empty
slices, built for the host with ``g++`` through ``csrc/host_shim.h`` (the
text nvcc compiles), against the JAX package's ``derive_logp_dc`` of the
same batch form, which calls the batch form itself; empty extents inside
a larger D; and the float64, int32 and coordinate-functor paths that
share the generator.

Tolerance: logp at rtol 1e-6 / atol 1e-6 (float32 on both sides, the same
operations in the same order); gradients, dual numbers against JAX's AD,
at rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_mcmc_torch.models import Target, derive_logp_dc
from mini_mcmc_torch.ops.kernels import user_density as U
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models.base import derive_grad_dc as jax_derive_grad_dc
from mini_mcmc_tpu.models.base import derive_logp_dc as jax_derive_logp_dc

LOGP_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _banded(xp, x, s):
    """tests/test_torch_cuda.py:_banded_gaussian's batch form, in ``xp``:
    ``z = x / s``, ``-z.z / 2 - sum(z_i z_(i+1)) / 4``."""
    z = x / s
    return (-0.5 * xp.sum(z * z, axis=-1)
            - 0.25 * xp.sum(z[..., :-1] * z[..., 1:], axis=-1))


def _inner_empty(xp, x):
    """A density at D = 4 with three empty extents inside it: a sum over
    an empty slice of the coordinates (the scalar branch), a sum over an
    empty trailing axis that keeps D outputs (the per-output branch) and
    a contraction of an empty slice against an empty constant."""
    inner = x[..., 2:2]
    per_coord = xp.sum(x[..., None, :0], axis=-1)  # [..., D] of zeros
    return (-0.5 * xp.sum(x * x, axis=-1) + xp.sum(inner * inner, axis=-1)
            + xp.sum(per_coord * x, axis=-1)
            + x[..., 1:1] @ xp.ones((0,), dtype=x.dtype))


def _pair(case: str, dim: int):
    """(port target, JAX batch form) of a case."""
    if case == "banded":
        s = np.linspace(0.5, 2.0, dim).astype(np.float32)
        st = torch.from_numpy(s)
        return (Target(logp=lambda x: _banded(torch, x, st.to(x.device))),
                lambda x: _banded(jnp, x, jnp.asarray(s)))
    return (Target(logp=lambda x: _inner_empty(torch, x)),
            lambda x: _inner_empty(jnp, x))


def _points(c, d, seed):
    return (np.random.default_rng(seed).standard_normal((c, d)) * 0.8
            ).astype(np.float32)


def _jax_dc(batch, x):
    """JAX's derive_logp_dc of ``batch`` and derive_grad_dc of that, at
    the rows of ``x``."""
    logp_dc = jax_derive_logp_dc(batch)
    xd = jnp.asarray(x.T)
    return (np.asarray(logp_dc(xd)),
            np.asarray(jax_derive_grad_dc(logp_dc)(xd)).T)


@pytest.mark.parametrize("case, dim", [("banded", 1), ("banded", 2),
                                       ("banded", 5), ("inner_empty", 4)])
def test_generated_source_builds_and_matches_jax_derive_logp_dc(case, dim):
    t, batch = _pair(case, dim)
    source, _ = derive_logp_dc(t, dim)
    # no loop over an empty extent, no array read that was never declared
    assert "i < 0" not in source and "r < 0" not in source
    if case == "inner_empty" or dim == 1:
        assert "S(0)" in source
    x = _points(64, dim, seed=dim)
    lp, g = U.probe(t, torch.from_numpy(x))  # g++ builds the source
    want_lp, want_g = _jax_dc(batch, x)
    np.testing.assert_allclose(lp.numpy(), want_lp, **LOGP_TOL)
    np.testing.assert_allclose(g.numpy(), want_g, **GRAD_TOL)
    if case == "banded" and dim == 1:  # the empty sum is 0: -z0^2 / 2
        np.testing.assert_allclose(lp.numpy(), -0.5 * (x[:, 0] / 0.5) ** 2,
                                   **LOGP_TOL)


def test_float64_instance_at_d1():
    """Kernel 1's float64 instance of the D = 1 banded Gaussian: traced at
    float64, read at double, against its batch form at 1e-12."""
    t, _ = _pair("banded", 1)
    source, _ = derive_logp_dc(t, 1, dtype=torch.float64)
    assert "S(0)" in source and "i < 0" not in source
    x = torch.from_numpy(_points(32, 1, seed=9).astype(np.float64))
    lp, g = U.probe(t, x)
    want_lp, want_g = t.batch_logp_and_grad(x)
    np.testing.assert_allclose(lp.numpy(), want_lp.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(g.numpy(), want_g.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_int32_value_instance_with_an_empty_sum():
    """Kernel 5's int32 value-only library: a Poisson-like pmf on int32
    states plus a sum over an empty slice, against its batch form."""

    def logp(k):
        kf = k.to(torch.float32)
        empty = torch.sum(kf[..., 1:1], dim=-1)
        return (torch.sum(kf * 1.2 - torch.lgamma(kf + 1.0), dim=-1)
                + empty)

    t = Target(logp=logp)
    source, _ = derive_logp_dc(t, 3, dtype=torch.int32)
    assert "S(0)" in source and "i < 0" not in source
    k = torch.from_numpy(np.random.default_rng(4).integers(
        0, 12, (40, 3)).astype(np.int32))
    lp, _ = U.probe(t, k, need_grad=False)
    np.testing.assert_allclose(lp.numpy(), t.batch_logp(k).numpy(),
                               rtol=1e-6, atol=1e-5)


def test_coordinate_functor_with_an_empty_sum():
    """derive_coord_dc shares reduce_sum: a tile form with a sum over an
    empty slice (0 on every coordinate partition), its generated functor
    built for the host against JAX's tile form and jax.grad per
    coordinate."""

    def tile(xp, x):
        return (xp.sum(-0.5 * x * x, axis=-1)
                + xp.sum(x[..., :0], axis=-1))

    t = Target(logp=lambda x: tile(torch, x),
               sep_form=(lambda x: tile(torch, x), ()))
    jt = jm.Target(logp=lambda x: tile(jnp, x),
                   sep_form=(lambda x: tile(jnp, x), ()))
    source, _ = U.derive_coord_dc(t)
    assert "S(0)" in source
    x = _points(32, 6, seed=11)
    lp, g = U.coord_probe(t, torch.from_numpy(x))
    jtile, _ = jt.sep_forms()
    want_lp = np.stack([np.asarray(jtile(jnp.asarray(x[:, d:d + 1])))
                        for d in range(6)], 1)
    want_g = np.stack([np.asarray(jax.grad(lambda v: jnp.sum(jtile(v)))(
        jnp.asarray(x[:, d:d + 1])))[:, 0] for d in range(6)], 1)
    np.testing.assert_allclose(lp.numpy(), want_lp, **LOGP_TOL)
    np.testing.assert_allclose(g.numpy(), want_g, **GRAD_TOL)
