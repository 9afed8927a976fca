// Kernel 7: the separable HMC tier's step, trajectory and accept in one
// launch.
//
// The kernel template and its launches, shared by the built-in library
// (hmc_separable.cu, which dispatches the built-in coordinate functors)
// and the per-functor libraries of user coordinate functors
// (ops/kernels/user_density.py, mm::UserCoord).
//
// Replaces mini_mcmc_tpu/ops/pallas/hmc_bigd.py:make_pallas_hmc_separable
// (production form and its mom_input debug form) together with the accept
// that the JAX package leaves to XLA (mini_mcmc_tpu/ops/hmc.py:_sep_step).
// For a density that is a sum over coordinates, each coordinate's
// (position, momentum) follows the leapfrog alone, so the whole trajectory
// runs coordinate by coordinate in registers: momentum drawn in the kernel
// (paired Box-Muller, philox.cuh), the merged-kick leapfrog of
// hmc_bigd.py:147-165 (one half kick, L-1 full kicks, one half kick) with
// the coordinate functor's derivative (coord_targets.cuh), and per chain
// the sums logp(pos_prop), |mom_0|^2/2 and |mom_L|^2/2. Each coordinate's
// constants come from the functor's prepare() once, before the loop: for
// the Gaussian functors a leapfrog is two FMAs and one multiply, with no
// division.
//
// A transformed target (coord_targets.cuh:TransformedCoord) also reads
// each coordinate's bijector code, offset and width from `bij` [3, D]
// (the soft-saturation constants after it) and, under a diagonal metric,
// its scale from `scale` [D]; the bijector's exp and sigmoid make that
// instance bound by its transcendental instructions, not by bytes.
//
// Layout: one block per (chain, D-tile), threads along D. A thread owns G
// quads of four consecutive coordinates (one Philox evaluation each);
// quad q = (tile * G + j) * blockDim.x + threadIdx.x, so a warp's loads
// are consecutive 16-byte vectors. The trajectory-only form also runs a
// D-slice of a state split over ranks: its rows are the slice's, and
// its momenta are keyed by global quad q0 + q (q0 = d0 / 4, the slice's
// first coordinate a multiple of 4), so the slices of a state draw the
// whole state's momenta. The fused form runs whole rows (q0 = 0) and never
// reads q0. No [C, D] momentum or gradient ever
// reaches device memory. Each block reduces its three sums with warp
// shuffles and shared memory.
//
// The fused form (kFused) launches a chain's n_tiles blocks as one
// thread-block cluster. After the trajectory each block leaves its three
// partials in its shared memory and the cluster synchronises; thread 0 of
// every block then reads all ranks' partials over distributed shared
// memory in rank order, so every block computes the same sums and the same
// decision: accept_logp = (-logp_in + ke0) - (-logp_prop + ke1) >= log(u),
// a NaN comparing false, u the word x of the Philox counter (chain, step,
// 0, 1). A second cluster barrier keeps each block's shared memory alive
// until its peers have read it, and hands the decision to the block's
// threads; each block then writes accept ? x_prop : x_in for its own
// coordinates (x_in held in registers). Rank 0 writes logp_out[c] and alpha_c[c] =
// exp(min(accept_logp, 0)), NaN -> 0. A cluster holds at most 16 blocks
// (more than 8 only with the non-portable size allowed), so at G = 2 and
// 256 threads the fused form covers D <= 32,768; past that the wrapper
// (ops/kernels/hmc_sep.py) launches the trajectory-only form, which
// writes per-tile partials parts[3, C, n_tiles], and accepts in PyTorch. The debug form (mom_in, mom_out) is always the
// trajectory-only form.
//
// What bounds it on the H100: bytes at L = 10. At C = 1,024, D = 10,000 it
// moves 82 MB (24 us at 3.35 TB/s) against ~6e8 lane instructions (18 us):
// per coordinate two FMAs and a multiply per leapfrog, the functor's
// prepare, and a quarter of a Philox-10 evaluation plus half a Box-Muller
// pair for the momentum. At L = 40 the instructions bound it. The design
// reads and writes each position once whatever L is, and the accept adds
// only [C] values and two cluster barriers; 1,024 chains give 5,120 blocks
// of 256 threads, clusters of 5.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "coord_targets.cuh"
#include "philox.cuh"

namespace mm {

namespace cg = cooperative_groups;

constexpr int kSepMaxThreads = 256;
// quads per thread; ops/kernels/hmc_sep.py:SEP_GROUPS must match
constexpr int kSepGroups = 2;
// the largest cluster the fused form launches (non-portable past 8)
constexpr int kSepMaxCluster = 16;

struct SepArgs {
  const float* pos;      // [C, D]
  const float* mom_in;   // [C, D] or null (drawn)
  const float* eps;      // one float
  const float* params;   // the functor's coefficients
  const float* tables;   // [n_tables, D] or null
  const float* bij;      // [3, D] code, offset, width; then 6 constants
  const float* scale;    // [D] (a transformed target under a metric)
  const float* logp_in;  // [C] (fused)
  const float* u_in;     // [C] or null (drawn; fused)
  int n_chains, dim, n_tiles, n_leapfrog, vec;
  uint32_t chain0, k0, k1, step;
  float* pos_out;    // [C, D]
  float* mom_out;    // [C, D] or null (trajectory form)
  float* parts;      // [3, C, n_tiles] (trajectory form)
  float* logp_out;   // [C] (fused)
  float* alpha_out;  // [C] (fused)
  uint32_t q0;       // the slice's first global quad (trajectory form)
};

// Four coordinates of quad q from `row`: one 16-byte load when `vec` (D is
// a multiple of four and every row, the second table row included, is
// 16-byte aligned), else element by element, `fill` past the end of the
// row. No launch writes what it reads, so the loads take the read-only
// path.
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

// The accept uniform of chain `chain` at `step`: word x of (chain, step,
// 0, 1) (philox.cuh's layout; the momenta take sub-draw 0).
__device__ __forceinline__ float accept_uniform(uint32_t chain, uint32_t step,
                                                uint32_t k0, uint32_t k1) {
  return uniform_at(chain, step, 0u, k0, k1, 1u);
}

// The functor of a launch: a transformed one also takes the bijector
// table's constants, after its [3, D] rows
template <class F>
__device__ __forceinline__ F make_functor(const SepArgs& a) {
  if constexpr (F::kTransformed) {
    return F(a.params, a.bij + 3 * (long long)a.dim);
  } else {
    return F(a.params);
  }
}

template <class F, bool kFused>
__global__ void __launch_bounds__(kSepMaxThreads)
    hmc_separable_kernel(const SepArgs a) {
  constexpr int G = kSepGroups;
  const int c = blockIdx.x / a.n_tiles;
  const int g = blockIdx.x - c * a.n_tiles;  // the cluster rank when fused
  const F f = make_functor<F>(a);
  const float eps = __ldg(a.eps);
  const float half = eps * 0.5f;
  const long long row = (long long)c * a.dim;
  const int quads = (a.dim + 3) >> 2;
  const uint32_t chain = a.chain0 + (uint32_t)c;

  // padding coordinates (past D) hold x = 0, m = 0 and the state of tables
  // (and so a scale) 1: finite, and masked out of the sums and stores
  float x[G][4], m[G][4], x_in[G][4];
  typename F::State k[G][4];
  int n_valid[G];
  float ke0 = 0.0f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int q = (g * G + j) * blockDim.x + threadIdx.x;
    n_valid[j] = q < quads ? min(4, a.dim - 4 * q) : 0;
    float t0[4] = {1.0f, 1.0f, 1.0f, 1.0f}, t1[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    // a transformed functor's bijector entries (padding: the identity)
    float bc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float bw[4] = {1.0f, 1.0f, 1.0f, 1.0f}, sc[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[j][i] = 0.0f;
      m[j][i] = 0.0f;
    }
    if (n_valid[j] > 0) {
      load4(a.pos + row, q, a.dim, a.vec, 0.0f, x[j]);
      if (F::kTables > 0) load4(a.tables, q, a.dim, a.vec, 1.0f, t0);
      if (F::kTables > 1) load4(a.tables + a.dim, q, a.dim, a.vec, 1.0f, t1);
      if constexpr (F::kTransformed) {
        load4(a.bij, q, a.dim, a.vec, 0.0f, bc);
        load4(a.bij + a.dim, q, a.dim, a.vec, 0.0f, bb);
        load4(a.bij + 2 * (long long)a.dim, q, a.dim, a.vec, 1.0f, bw);
        if constexpr (F::kScaledY) load4(a.scale, q, a.dim, a.vec, 1.0f, sc);
      }
      if (a.mom_in != nullptr) {
        load4(a.mom_in + row, q, a.dim, a.vec, 0.0f, m[j]);
      } else {
        // momenta keyed by global quad: the fused form's rows are whole
        const uint32_t qg = kFused ? (uint32_t)q : a.q0 + (uint32_t)q;
        normals4_at(chain, a.step, qg, a.k0, a.k1, m[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (F::kTransformed) {
        k[j][i] = f.prepare(t0[i], t1[i], bc[i], bb[i], bw[i], sc[i]);
      } else {
        k[j][i] = f.prepare(t0[i], t1[i]);
      }
      x_in[j][i] = x[j][i];
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
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) m[j][i] += f.grad(x[j][i], k[j][i]) * half;
  }
#pragma unroll 2
  for (int l = 0; l < a.n_leapfrog; ++l) {
    const float kick = l < a.n_leapfrog - 1 ? eps : half;
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[j][i] += eps * m[j][i];
        m[j][i] += f.grad(x[j][i], k[j][i]) * kick;
      }
    }
  }

  float pe = 0.0f, ke1 = 0.0f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n_valid[j]) {
        pe += f.logp(x[j][i], k[j][i]);
        ke1 += m[j][i] * m[j][i];
      }
    }
    if (!kFused && n_valid[j] > 0) {
      const int q = (g * G + j) * blockDim.x + threadIdx.x;
      store4(a.pos_out + row, q, a.dim, a.vec, x[j]);
      if (a.mom_out != nullptr) {
        store4(a.mom_out + row, q, a.dim, a.vec, m[j]);
      }
    }
  }

  constexpr int kWarps = kSepMaxThreads / 32;
  __shared__ float red[3][kWarps];
  __shared__ float part[3];
  __shared__ int decision;
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
      if (kFused) {
        part[0] = pe;
        part[1] = 0.5f * ke0;
        part[2] = 0.5f * ke1;
      } else {
        const long long plane = (long long)a.n_chains * a.n_tiles;
        const long long o = (long long)c * a.n_tiles + g;
        a.parts[o] = pe;
        a.parts[plane + o] = 0.5f * ke0;
        a.parts[2 * plane + o] = 0.5f * ke1;
      }
    }
  }
  if (!kFused) return;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partials are in its shared memory
  if (threadIdx.x == 0) {
    float lp = 0.0f, e0 = 0.0f, e1 = 0.0f;
    for (int r = 0; r < a.n_tiles; ++r) {  // rank order: the same sums
      const float* p = cluster.map_shared_rank(part, r);
      lp += p[0];
      e0 += p[1];
      e1 += p[2];
    }
    const float u = a.u_in != nullptr
                        ? a.u_in[c]
                        : accept_uniform(chain, a.step, a.k0, a.k1);
    const float lp_in = a.logp_in[c];
    const float accept_logp = (-lp_in + e0) - (-lp + e1);
    const bool accept = accept_logp >= logf(u);  // NaN compares false
    decision = accept;
    if (g == 0) {
      a.logp_out[c] = accept ? lp : lp_in;
      a.alpha_out[c] = isnan(accept_logp)
                           ? 0.0f
                           : expf(accept_logp < 0.0f ? accept_logp : 0.0f);
    }
  }
  cluster.sync();  // peers are done reading `part`; `decision` is set
  const bool accept = decision;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (n_valid[j] == 0) continue;
    const int q = (g * G + j) * blockDim.x + threadIdx.x;
    float v[4];  // selected element by element: the arrays stay registers
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = accept ? x[j][i] : x_in[j][i];
    store4(a.pos_out + row, q, a.dim, a.vec, v);
  }
}

// The launch configuration of the fused form: clusters of n_tiles blocks.
// A size past 8 needs the non-portable attribute, set on every launch (it
// acts on the current device's context).
template <class F>
cudaError_t fused_config(int n_chains, int n_tiles, int threads,
                         cudaStream_t stream, cudaLaunchConfig_t& cfg,
                         cudaLaunchAttribute& attr) {
  if (n_tiles > 8) {
    const cudaError_t set = cudaFuncSetAttribute(
        hmc_separable_kernel<F, true>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (set != cudaSuccess) return set;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(n_chains * n_tiles));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)n_tiles;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// The tiles of a launch at `threads` threads, or -1 for a block size the
// kernels do not take.
inline int sep_tiles(int dim, int threads) {
  if (threads < 32 || threads > kSepMaxThreads || threads % 32 != 0) {
    return -1;
  }
  const int per_tile = threads * kSepGroups;
  return ((dim + 3) / 4 + per_tile - 1) / per_tile;
}


// The raw arguments of the C entries (mm_hmc_separable,
// mm_hmc_separable_step; see hmc_separable.cu for each one's contract).
struct SepCall {
  const void* pos;
  const void* mom_in;
  const void* u_in;
  const void* logp_in;
  const void* eps;
  const void* params;
  const void* tables;
  const void* bij;
  const void* scale;
  int n_chains, dim, n_leapfrog, threads, vec;
  uint32_t chain0, seed_lo, seed_hi, step;
  void* pos_out;
  void* mom_out;
  void* parts;
  void* logp_out;
  void* alpha_out;
  void* stream;
  uint32_t d0;  // the slice's first coordinate (trajectory form; else 0)
};

inline SepArgs sep_args(const SepCall& c, int n_tiles) {
  SepArgs a{};
  a.pos = (const float*)c.pos;
  a.mom_in = (const float*)c.mom_in;
  a.eps = (const float*)c.eps;
  a.params = (const float*)c.params;
  a.tables = (const float*)c.tables;
  a.bij = (const float*)c.bij;
  a.scale = (const float*)c.scale;
  a.logp_in = (const float*)c.logp_in;
  a.u_in = (const float*)c.u_in;
  a.n_chains = c.n_chains;
  a.dim = c.dim;
  a.n_tiles = n_tiles;
  a.n_leapfrog = c.n_leapfrog;
  a.vec = c.vec;
  a.chain0 = c.chain0;
  a.k0 = c.seed_lo;
  a.k1 = c.seed_hi;
  a.step = c.step;
  a.pos_out = (float*)c.pos_out;
  a.mom_out = (float*)c.mom_out;
  a.parts = (float*)c.parts;
  a.logp_out = (float*)c.logp_out;
  a.alpha_out = (float*)c.alpha_out;
  a.q0 = c.d0 >> 2;
  return a;
}

// The trajectory-only form of instance F (mm_hmc_separable).
template <class F>
int sep_trajectory(const SepCall& c) {
  if (c.n_chains <= 0 || c.dim <= 0) return (int)cudaSuccess;
  const int n_tiles = sep_tiles(c.dim, c.threads);
  if (n_tiles < 0 || c.d0 % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)c.n_chains * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const SepArgs a = sep_args(c, n_tiles);
  hmc_separable_kernel<F, false>
      <<<(int)blocks, c.threads, 0, (cudaStream_t)c.stream>>>(a);
  return (int)cudaGetLastError();
}

// The fused form of instance F (mm_hmc_separable_step).
template <class F>
int sep_step(const SepCall& c) {
  if (c.n_chains <= 0 || c.dim <= 0) return (int)cudaSuccess;
  const int n_tiles = sep_tiles(c.dim, c.threads);
  if (n_tiles < 0 || n_tiles > kSepMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)c.n_chains * n_tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const SepArgs a = sep_args(c, n_tiles);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = fused_config<F>(c.n_chains, n_tiles, c.threads,
                                        (cudaStream_t)c.stream, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaLaunchKernelEx(&cfg, hmc_separable_kernel<F, true>, a);
}

// The clusters of instance F's fused form the current device holds at
// once (mm_hmc_separable_clusters).
template <class F>
int sep_clusters(int threads, int n_tiles, int* out) {
  *out = 0;
  if (n_tiles < 1 || n_tiles > kSepMaxCluster ||
      sep_tiles(1, threads) < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e =
      fused_config<F>(1, n_tiles, threads, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)hmc_separable_kernel<F, true>, &cfg);
}

}  // namespace mm
