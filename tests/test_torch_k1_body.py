"""Kernel 1's per-chain body (``csrc/hmc_leapfrog.cuh:leapfrog_chain``:
the L-step trajectory, then the logp at its end) built for the host with
g++ through ``csrc/host_shim.h``, as the user-density probes are, against
the JAX package's Pallas kernel in interpret mode on the same numpy
inputs.

Two instances: the built-in Rosenbrock at D = 3 and a user Rosenbrock at
D = 5 whose gradient is a dual pass (the C++ traced from its batch form),
at L = 0, 1 and 7. Tolerance: rtol 1e-3, atol 1e-4, as
tests/test_torch_hmc_kernels.py holds Kernel 1's twin (float32; the host
build contracts no FMAs, XLA fuses otherwise). At L = 0 the gradient
comes back as passed, bit for bit.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_mcmc_torch.examples import user_forms as F
from mini_mcmc_torch.ops.kernels import user_density
from mini_mcmc_tpu import models as jm
from mini_mcmc_tpu.models.base import Target as JaxTarget
from mini_mcmc_tpu.ops.pallas.hmc import make_pallas_leapfrog

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4

#: the host unit: the body over host rows, one instance
_UNIT = user_density._HOST_HEAD + """
#include "hmc_leapfrog.cuh"

using Inst = {inst};
static_assert(mm::has_logp_and_grad<Inst, {dim}>::value == {fused},
              "the instance's gradient is a dual pass");

extern "C" void k1_body_host(const float* pos, const float* mom,
                             const float* grad, float eps,
                             const float* params, int n_leapfrog, int rows,
                             float* pos_out, float* mom_out,
                             float* logp_out, float* grad_out) {{
  const Inst t(params);
  for (int r = 0; r < rows; ++r) {{
    float x[{dim}], m[{dim}], g[{dim}];
    for (int d = 0; d < {dim}; ++d) {{
      x[d] = pos[r * {dim} + d];
      m[d] = mom[r * {dim} + d];
      g[d] = grad[r * {dim} + d];
    }}
    logp_out[r] = mm::leapfrog_chain<Inst, {dim}>(t, x, m, g, eps,
                                                  n_leapfrog);
    for (int d = 0; d < {dim}; ++d) {{
      pos_out[r * {dim} + d] = x[d];
      mom_out[r * {dim} + d] = m[d];
      grad_out[r * {dim} + d] = g[d];
    }}
  }}
}}
"""


def _body(case):
    """``(run, JAX (grad_dc, logp_dc), D)``: ``run(pos, mom, grad, eps,
    L)`` the host-built body on numpy float32 rows."""
    if case == "builtin_rosenbrock3":
        d, source, inst, params, fused = 3, "", "mm::RosenbrockND", (), False
        jt = jm.rosenbrock_nd()
        jforms = (jt.grad_dc, jt.logp_dc)
    else:
        d, fused = 5, True
        forms = user_density.dc_forms(F.rosenbrock_user(hand=False), d)
        assert forms.grad == "derived"  # the dual pass
        source, params = forms.source, forms.params
        inst = user_density.instance_type(d, 0)
        logp_dc, grad_dc = JaxTarget(logp=jm.rosenbrock_nd().logp).dc_forms()
        jforms = (grad_dc, logp_dc)
    lib = user_density._host_load(_UNIT.format(
        source=source, inst=inst, dim=d, fused=str(fused).lower()))
    fn = lib.k1_body_host
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_float, p, ctypes.c_int, ctypes.c_int,
                   p, p, p, p]
    fn.restype = None
    par = np.asarray(params or (0.0,), np.float32)

    def run(pos, mom, grad, eps, n_leapfrog):
        c = pos.shape[0]
        outs = [np.empty_like(pos), np.empty_like(pos),
                np.empty(c, np.float32), np.empty_like(pos)]
        fn(pos.ctypes.data, mom.ctypes.data, grad.ctypes.data, eps,
           par.ctypes.data, n_leapfrog, c, *(o.ctypes.data for o in outs))
        return outs
    return run, jforms, d


@pytest.mark.parametrize("n_leapfrog", [0, 1, 7])
@pytest.mark.parametrize("case", ["builtin_rosenbrock3",
                                  "user_dual_rosenbrock5"])
def test_k1_body_matches_jax_pallas(case, n_leapfrog):
    run, (grad_dc, logp_dc), d = _body(case)
    g = np.random.default_rng(20 + d + n_leapfrog)
    pos = (g.standard_normal((64, d)) * 0.3 + 0.9).astype(np.float32)
    mom = g.standard_normal((64, d)).astype(np.float32)
    eps = 0.02
    jpos, jmom = jnp.asarray(pos), jnp.asarray(mom)
    jgrad = jnp.asarray(grad_dc(jpos.T)).T
    grad = np.array(jgrad, np.float32)
    want = make_pallas_leapfrog(grad_dc, logp_dc, eps, n_leapfrog,
                                interpret=True)(jpos, jmom, jgrad,
                                                jnp.float32(eps))
    got = run(pos, mom, grad, eps, n_leapfrog)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if n_leapfrog == 0:  # the gradient as passed, the logp at pos
        np.testing.assert_array_equal(got[3], grad)
        np.testing.assert_array_equal(got[0], pos)
        np.testing.assert_array_equal(got[1], mom)
