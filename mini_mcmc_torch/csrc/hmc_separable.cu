// Kernel 7: the L-step trajectory of the separable HMC tier.
//
// Replaces mini_mcmc_tpu/ops/pallas/hmc_bigd.py:make_pallas_hmc_separable
// (production form and its mom_input debug form). For a density that is a
// sum over coordinates, each coordinate's (position, momentum) follows the
// leapfrog alone, so the whole trajectory runs coordinate by coordinate in
// registers: momentum drawn in the kernel (paired Box-Muller, philox.cuh),
// the merged-kick leapfrog of hmc_bigd.py:147-165 (one half kick, L-1 full
// kicks, one half kick) with the coordinate functor's derivative
// (coord_targets.cuh), and per chain the sums logp(pos_prop), |mom_0|^2/2
// and |mom_L|^2/2. The accept runs outside, in PyTorch, as the JAX package
// leaves it to XLA (ops/hmc.py:_sep_step).
//
// Layout: one block per (chain, D-tile), threads along D. A thread owns
// kSepGroups quads of four consecutive coordinates (one Philox evaluation
// each); quad q = (tile * kSepGroups + j) * blockDim.x + threadIdx.x, so a
// warp's loads are consecutive 16-byte vectors. No [C, D] momentum or
// gradient ever reaches device memory: positions are read once and the
// proposal written once. The three sums are reduced over the block with
// warp shuffles and shared memory into per-tile partials parts[3, C, G],
// which the wrapper sums (no atomics, so the sums do not depend on the
// order in which blocks run).
//
// What bounds it on the H100: bytes at L = 10. At C = 1,024, D = 10,000 it
// moves 82 MB (24 us at 3.35 TB/s) against ~7e8 lane instructions (21 us):
// per coordinate two FMAs per leapfrog, the functor, and a quarter of a
// Philox-10 evaluation plus half a Box-Muller pair for the momentum. At
// L = 40 the instructions bound it (~1.3e9, 39 us). The design reads and
// writes each position once whatever L is; a chain's D-tiles are
// independent blocks, so 1,024 chains give 5,120 blocks of 256 threads.
//
// Under a diagonal metric (`scaled`) the functor is Scaled<F>
// (coord_targets.cuh): the scale is one more [D] table row, read once
// into registers beside F's own, so a thread holds up to two table rows
// for its 4 * kSepGroups coordinates.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "coord_targets.cuh"
#include "philox.cuh"

namespace {

constexpr int kSepMaxThreads = 256;
// quads per thread; ops/kernels/hmc_sep.py:SEP_GROUPS must match
constexpr int kSepGroups = 2;

// Four coordinates of quad q from `row`: one 16-byte load when `vec` (D is
// a multiple of four and every row, the second table row included, is
// 16-byte aligned), else element by element, `fill` past the end of the
// row.
__device__ __forceinline__ void load4(const float* __restrict__ row, int q,
                                      int dim, int vec, float fill,
                                      float (&v)[4]) {
  if (vec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row) + q);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = 4 * q + i < dim ? __ldg(row + 4 * q + i) : fill;
  }
}

__device__ __forceinline__ void store4(float* __restrict__ row, int q,
                                       int dim, int vec,
                                       const float (&v)[4]) {
  if (vec) {
    reinterpret_cast<float4*>(row)[q] = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (4 * q + i < dim) row[4 * q + i] = v[i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <class F>
__global__ void __launch_bounds__(kSepMaxThreads)
    hmc_separable_kernel(const float* __restrict__ pos,
                         const float* __restrict__ mom_in,
                         const float* __restrict__ eps_ptr,
                         const float* __restrict__ params,
                         const float* __restrict__ tables, int n_chains,
                         int dim, int n_tiles, int n_leapfrog, int vec,
                         uint32_t chain0, uint32_t k0, uint32_t k1,
                         uint32_t step, float* __restrict__ pos_out,
                         float* __restrict__ mom_out,
                         float* __restrict__ parts) {
  const int c = blockIdx.x / n_tiles;
  const int g = blockIdx.x - c * n_tiles;
  const F f(params);
  const float eps = __ldg(eps_ptr);
  const float half = eps * 0.5f;
  const long long row = (long long)c * dim;
  const int quads = (dim + 3) >> 2;
  const uint32_t chain = chain0 + (uint32_t)c;

  // padding coordinates (past D) hold x = 0, m = 0, tables (and so the
  // scale) 1: finite, and masked out of the sums
  float x[kSepGroups][4], m[kSepGroups][4];
  float t0[kSepGroups][4], t1[kSepGroups][4];
  int n_valid[kSepGroups];
  float ke0 = 0.0f;
#pragma unroll
  for (int j = 0; j < kSepGroups; ++j) {
    const int q = (g * kSepGroups + j) * blockDim.x + threadIdx.x;
    n_valid[j] = q < quads ? min(4, dim - 4 * q) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[j][i] = 0.0f;
      m[j][i] = 0.0f;
      t0[j][i] = 1.0f;
      t1[j][i] = 1.0f;
    }
    if (n_valid[j] == 0) continue;
    load4(pos + row, q, dim, vec, 0.0f, x[j]);
    if (F::kTables > 0) load4(tables, q, dim, vec, 1.0f, t0[j]);
    if (F::kTables > 1) load4(tables + dim, q, dim, vec, 1.0f, t1[j]);
    if (mom_in != nullptr) {
      load4(mom_in + row, q, dim, vec, 0.0f, m[j]);
    } else {
      mm::normals4_at(chain, step, (uint32_t)q, k0, k1, m[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n_valid[j]) {
        ke0 += m[j][i] * m[j][i];
      } else {
        m[j][i] = 0.0f;
      }
    }
  }

  // merged-kick leapfrog: a half kick, then L drifts each followed by a
  // full kick, the last by a half kick
#pragma unroll
  for (int j = 0; j < kSepGroups; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[j][i] += f.grad(x[j][i], t0[j][i], t1[j][i]) * half;
    }
  }
#pragma unroll 2
  for (int l = 0; l < n_leapfrog; ++l) {
    const float kick = l < n_leapfrog - 1 ? eps : half;
#pragma unroll
    for (int j = 0; j < kSepGroups; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[j][i] += eps * m[j][i];
        m[j][i] += f.grad(x[j][i], t0[j][i], t1[j][i]) * kick;
      }
    }
  }

  float pe = 0.0f, ke1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kSepGroups; ++j) {
    if (n_valid[j] == 0) continue;
    const int q = (g * kSepGroups + j) * blockDim.x + threadIdx.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n_valid[j]) {
        pe += f.logp(x[j][i], t0[j][i], t1[j][i]);
        ke1 += m[j][i] * m[j][i];
      }
    }
    store4(pos_out + row, q, dim, vec, x[j]);
    if (mom_out != nullptr) store4(mom_out + row, q, dim, vec, m[j]);
  }

  __shared__ float red[3][kSepMaxThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  pe = warp_sum(pe);
  ke0 = warp_sum(ke0);
  ke1 = warp_sum(ke1);
  if (lane == 0) {
    red[0][warp] = pe;
    red[1][warp] = ke0;
    red[2][warp] = ke1;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    pe = warp_sum(lane < n_warps ? red[0][lane] : 0.0f);
    ke0 = warp_sum(lane < n_warps ? red[1][lane] : 0.0f);
    ke1 = warp_sum(lane < n_warps ? red[2][lane] : 0.0f);
    if (lane == 0) {
      const long long plane = (long long)n_chains * n_tiles;
      const long long o = (long long)c * n_tiles + g;
      parts[o] = pe;
      parts[plane + o] = 0.5f * ke0;
      parts[2 * plane + o] = 0.5f * ke1;
    }
  }
}

}  // namespace

// One trajectory per chain of pos [C, D] (row-major, float32). `mom_in`
// null draws the momentum (production); otherwise it is the [C, D]
// momentum and `mom_out` receives the final one (the debug form). `eps`
// is a device float, `tables` [n_tables, D] (null without tables). Writes
// pos_out [C, D] and parts [3, C, G], G = ceil(ceil(D / 4) / (threads *
// kSepGroups)). `functor` is a CoordId (_build.SEP_FUNCTORS), run as
// Scaled<functor> when `scaled` (its scale the last table); any other
// returns cudaErrorInvalidValue, as do `threads` not a multiple of 32 in
// [32, 256] and a grid past 2^31 - 1 blocks.
extern "C" int mm_hmc_separable(const void* pos, const void* mom_in,
                                const void* eps, const void* params,
                                const void* tables, int n_chains, int dim,
                                int n_leapfrog, int functor, int scaled,
                                int threads, int vec, uint32_t chain0,
                                uint32_t seed_lo,
                                uint32_t seed_hi, uint32_t step, void* pos_out,
                                void* mom_out, void* parts, void* stream) {
  if (n_chains <= 0 || dim <= 0) return (int)cudaSuccess;
  if (threads < 32 || threads > kSepMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int quads = (dim + 3) / 4;
  const int per_tile = threads * kSepGroups;
  const int n_tiles = (quads + per_tile - 1) / per_tile;
  const long long blocks = (long long)n_chains * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
#define MM_SEP(F)                                                          \
  hmc_separable_kernel<F><<<(int)blocks, threads, 0, (cudaStream_t)stream>>>( \
      (const float*)pos, (const float*)mom_in, (const float*)eps,           \
      (const float*)params, (const float*)tables, n_chains, dim, n_tiles,   \
      n_leapfrog, vec, chain0, seed_lo, seed_hi, step, (float*)pos_out,     \
      (float*)mom_out, (float*)parts)
  if (scaled) {
    switch (functor) {
      case mm::kStandardNormal:
        MM_SEP(mm::Scaled<mm::StandardNormalCoord>);
        break;
      case mm::kIsotropicGaussianCoord:
        MM_SEP(mm::Scaled<mm::IsotropicGaussianCoord>);
        break;
      case mm::kSigmaTableNormal:
        MM_SEP(mm::Scaled<mm::SigmaTableNormalCoord>);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (functor) {
      case mm::kStandardNormal: MM_SEP(mm::StandardNormalCoord); break;
      case mm::kIsotropicGaussianCoord: MM_SEP(mm::IsotropicGaussianCoord); break;
      case mm::kSigmaTableNormal: MM_SEP(mm::SigmaTableNormalCoord); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef MM_SEP
  return (int)cudaGetLastError();
}
