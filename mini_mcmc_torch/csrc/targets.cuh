// Built-in target densities for the hand-written kernels.
//
// The JAX package traces a Target's jnp chains-on-lanes forms
// (logp_dc/grad_dc, mini_mcmc_tpu/models/base.py:97-125) into its Pallas
// bodies. CUDA cannot take a Python density, so each built-in target the
// kernels support is a functor here, selected by the Target's
// `cuda_functor` name (mini_mcmc_torch/ops/kernels/_build.py maps names to
// the ids below). Densities supplied by users inside a kernel are later
// work (ROADMAP.md, Queue 1).
#pragma once

namespace mm {

enum TargetId : int { kRosenbrockND = 0 };

// models/rosenbrock.py:rosenbrock_nd, arithmetic in the JAX form's order:
// logp = -sum_i [100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2]
struct RosenbrockND {
  template <int D>
  __device__ __forceinline__ static void grad(const float (&x)[D],
                                              float (&g)[D]) {
#pragma unroll
    for (int i = 0; i < D; ++i) g[i] = 0.0f;
#pragma unroll
    for (int i = 0; i + 1 < D; ++i) {
      const float lo = x[i], hi = x[i + 1];
      const float d = hi - lo * lo;
      g[i] += 400.0f * d * lo + 2.0f * (1.0f - lo);
      g[i + 1] += -200.0f * d;
    }
  }

  template <int D>
  __device__ __forceinline__ static float logp(const float (&x)[D]) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i + 1 < D; ++i) {
      const float lo = x[i], hi = x[i + 1];
      const float d = hi - lo * lo;
      s += 100.0f * (d * d) + (1.0f - lo) * (1.0f - lo);
    }
    return -s;
  }
};

}  // namespace mm
