// Kernel 4: a whole NUTS step per launch.
//
// The kernel template and its launch, shared by the built-in library
// (nuts_full.cu, every instance of MM_DISPATCH) and the per-density
// libraries of user targets (ops/kernels/user_density.py).
//
// Replaces mini_mcmc_tpu/ops/pallas/nuts_full.py:make_pallas_nuts_step
// with its contract: (pos [C, D], eps [C], depth_limit, key) ->
// (new_pos [C, D], alpha, n_alpha, diverged, depth [C] f32). Per chain
// (reference nuts.rs:550-674): momentum ~ N(0, 1), the slice
// logu = joint - Exp(1), then the doubling loop: a fair-coin direction,
// the 2^j-leaf subtree from that end of the trajectory (the leaf and merge
// rule of nuts_tree.cuh, shared with Kernel 3), the progressive accept
// u < min(1, n' / n) and the U-turn check between the trajectory's ends.
// Dual averaging stays outside, in PyTorch, as it stays in XLA. `depth` is
// the chain's own doubling count.
//
// Draws are Philox4x32-10 (philox.cuh) at (chain, step, draw, sub-draw)
// under the run's key, replacing the TPU hardware stream, one evaluation
// per four words the step uses plus at most one per doubling: draw 0 the
// momentum (box_muller_pair on words x, y) and the slice uniform (word z)
// at D <= 2, or draws 0..Q-1 the momenta four to an evaluation
// (normals4_at, Q = ceil(D / 4)) with draw Q's word x the slice at D > 2;
// draw 0x10000 + j, sub-draw 0, doubling j's direction coin
// (word x) and progressive-accept uniform (word y); sub-draw 1 + q its
// merge uniforms of ordinals 4q..4q+3, the merge at leaf i, cascade
// position k having ordinal i - popcount(i) + k. Every draw is a function
// of its place in the run, so the plain twin (ops/kernels/nuts_full.py)
// reproduces the kernel's draws exactly and a chain's result depends on
// (key, step, chain) alone: not on the grid, nor on which lane runs it.
//
// Lockstep warps on a persistent grid. A warp runs in lockstep: its active
// lanes share the doubling j and the leaf i, so the leaf body, the merge
// cascade (ctz(i + 1) merges) and its Philox evaluations run converged,
// and each doubling's coin, accept and end checks are paid once per warp.
// The price is that a warp runs its deepest chain's 2^J - 1 leaves (9.4 for
// chains that need 4.0 at the bench's equilibrium). A flat loop of one
// leaf per iteration, each lane refilling from the counter as its chain
// ends, balances the lanes (1.5 lane-iterations per leaf at 8 chains per
// lane) but runs every path's union each iteration, since a chain start or
// a doubling's turn is nearly as frequent as a leaf at depth ~2: 34-56 us
// per step against this form's 17 us (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md). The grid is sized to the resident blocks (occupancy x SMs);
// each warp takes the next 32 chains from a device counter until it passes
// the last, so no block waits for a second wave. The last block to finish
// resets the counter, so a step costs no extra call.
//
// The U-turn stack is rows addressed by the runtime height, so it cannot
// live in registers. A block is step_threads<D>() threads: 128 while a
// depth-10 stack of 128 fits in a block's 227 KB (every D <= 14), else
// 64, or one warp. In shared memory (a depth-10 stack is 35 KB a block
// at D = 2: 6 blocks a SM, 72 registers) a step took 17.0 us on that card,
// against 20.0 us with a per-thread array in local memory (8 blocks a SM
// at 64 registers, which spilled).
//
// What bounds it on the H100: device memory sees 16 bytes in and 24 out
// per chain per step at D = 2; the work is ~60 f32 operations per leaf,
// ~35 per merge and ~83 integer operations per Philox evaluation, and the
// leaves a warp runs for its deepest chain. Issue bounds it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hmc_common.cuh"
#include "nuts_tree.cuh"
#include "philox.cuh"

namespace mm {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kDoublingDraw = 0x10000u;

// A thread's U-turn stack in shared memory, structure-of-arrays rows
// indexed by thread, [row][field][thread], so a warp's accesses fall on 32
// banks: depth_limit rows (doubling j pushes leaf i at height popcount(i)
// <= j < depth_limit) of first_pos[D], first_mom[D], prop_pos[D] and n.
template <int D>
constexpr int kStepRow = 3 * D + 1;

template <int D>
__host__ __device__ constexpr size_t step_stack_bytes(int rows,
                                                      int threads) {
  return (size_t)rows * kStepRow<D> * threads * sizeof(float);
}

// The threads of a block: the most of 128, 64 and 32 whose depth-10 stack
// fits in a block's shared memory.
template <int D>
__host__ __device__ constexpr int step_threads() {
  return step_stack_bytes<D>(kMaxDepth, kThreads) <= kMaxBlockSmem
             ? kThreads
         : step_stack_bytes<D>(kMaxDepth, kThreads / 2) <= kMaxBlockSmem
             ? kThreads / 2
             : 32;
}

// The blocks a depth-10 stack leaves room for on an SM (6 at D = 2); the
// register cap they set costs no occupancy.
template <int D>
__host__ __device__ constexpr int step_min_blocks() {
  return (int)((228 * 1024) /
               (step_stack_bytes<D>(kMaxDepth, step_threads<D>()) + 1024));
}

template <int D>
__device__ __forceinline__ void swap_if(bool flip, float (&a)[D],
                                        float (&b)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float t = a[d];
    a[d] = flip ? b[d] : a[d];
    b[d] = flip ? t : b[d];
  }
}

template <class T, int D>
__global__ void __launch_bounds__(step_threads<D>(), step_min_blocks<D>())
    nuts_step_kernel(const float* __restrict__ pos,
                     const float* __restrict__ eps_in,
                     const float* __restrict__ params, int depth_limit,
                     uint32_t k0, uint32_t k1, uint32_t step, uint32_t chain0,
                     int n_chains, unsigned* __restrict__ counter,
                     unsigned long long* __restrict__ stats,
                     float* __restrict__ pos_out,
                     float* __restrict__ alpha_out,
                     float* __restrict__ n_alpha_out,
                     float* __restrict__ diverged_out,
                     float* __restrict__ depth_out) {
  static_assert(D >= 1 && D <= 16, "at most four quads of momenta");
  extern __shared__ float smem[];
  // row r of this thread's stack: field f at row(r)[f * S]
  float* const stack = smem + threadIdx.x;
  constexpr int S = step_threads<D>();
  const auto row = [stack](int r) {
    return stack + r * kStepRow<D> * S;
  };
  constexpr int kFirstPos = 0, kFirstMom = D, kProp = 2 * D, kN = 3 * D;

  const T t(params);
  const unsigned lane = threadIdx.x & 31u;
  // leaf iterations the warp ran (counted by its lowest active lane) and
  // leaves this lane integrated
  unsigned iterations = 0, leaves = 0;

  // each warp takes the next 32 chains until the counter passes the last
  while (true) {
    unsigned base = 0u;
    if (lane == 0) base = atomicAdd(counter, 32u);
    base = __shfl_sync(kFull, base, 0);
    if (base >= (unsigned)n_chains) break;
    const int c = (int)(base + lane);
    const bool valid = c < n_chains;
    const uint32_t chain = chain0 + (uint32_t)c;

    // the start: its gradient and logp, the momentum and the slice (one
    // Philox evaluation at D <= 2, ceil(D / 4) + 1 above)
    float xa[D], ma[D], ga[D], xo[D], mo[D], go[D], sel[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xa[d] = valid ? pos[(long long)c * D + d] : 0.0f;
    }
    const float eps = valid ? eps_in[c] : 0.0f;
    const float lp0 = value_and_grad<T, D>(t, xa, ga);
    float u_slice;
    if constexpr (D <= 4) {
      const U32x4 w = philox4x32_10(U32x4{chain, step, 0u, 0u}, k0, k1);
      if constexpr (D == 1) {
        ma[0] = box_muller(w.x, w.y);
      } else {
        float n4[4];
        box_muller_pair(w.x, w.y, n4[0], n4[1]);
        if constexpr (D > 2) box_muller_pair(w.z, w.w, n4[2], n4[3]);
#pragma unroll
        for (int d = 0; d < D; ++d) ma[d] = n4[d];
      }
      u_slice = D <= 2 ? unit_open(w.z)
                       : uniform_at(chain, step, 1u, k0, k1);
    } else {
      // draw q the momenta 4q..4q+3, draw Q's word x the slice
      constexpr int Q = (D + 3) / 4;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float n4[4];
        normals4_at(chain, step, (uint32_t)q, k0, k1, n4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * q + r < D) ma[4 * q + r] = n4[r];
        }
      }
      u_slice = uniform_at(chain, step, (uint32_t)Q, k0, k1);
    }
    float ke0 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ke0 += ma[d] * ma[d];
      xo[d] = sel[d] = xa[d];
      mo[d] = ma[d];
      go[d] = ga[d];
    }
    const float joint0 = lp0 - 0.5f * ke0;
    // logu = joint - Exp(1), Exp(1) = -ln U (nuts.rs:563-564)
    const float logu = joint0 + logf(u_slice);

    int n = 1, n_alpha = 0, j = 0;
    float alpha = 0.0f, v = 1.0f;
    bool s = valid, diverged = false;
    for (; j < depth_limit && s; ++j) {
      // doubling j: its direction and progressive-accept uniform, and the
      // end it extends (xa, ma, ga; xo, mo, go the other)
      const U32x4 w = philox4x32_10(
          U32x4{chain, step, kDoublingDraw + (uint32_t)j, 0u}, k0, k1);
      const float vj = unit_open(w.x) < 0.5f ? -1.0f : 1.0f;
      const float u_accept = unit_open(w.y);
      const bool flip = vj != v;
      swap_if<D>(flip, xa, xo);
      swap_if<D>(flip, ma, mo);
      swap_if<D>(flip, ga, go);
      v = vj;

      // the 2^j leaves: a warp's active lanes share (j, i), so the merge
      // cascades and their Philox evaluations run converged
      int st_n = 0, st_n_alpha = 0, mq = -1;
      float st_alpha = 0.0f;
      bool st_s = true, st_div = false;
      U32x4 mw{0u, 0u, 0u, 0u};
      for (int i = 0; i < (1 << j) && st_s; ++i) {
        if ((__activemask() & ((1u << lane) - 1u)) == 0u) ++iterations;
        ++leaves;
        const Leaf lf =
            leaf<T, D>(t, xa, ma, ga, eps * v, logu, joint0);
        st_n += lf.n ? 1 : 0;
        st_alpha += lf.alpha;
        st_n_alpha += 1;
        st_div |= !lf.s;
        st_s = lf.s;
        // push the leaf row at the binary counter's height, then the
        // ctz(i + 1) merges of its carries, ordinals i - popcount(i) + k
        const int sp = __popc(i);
        float* top = row(sp);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          top[(kFirstPos + d) * S] = xa[d];
          top[(kFirstMom + d) * S] = ma[d];
          top[(kProp + d) * S] = xa[d];
        }
        top[kN * S] = lf.n ? 1.0f : 0.0f;
        const int n_merges = __ffs(i + 1) - 1;
        for (int k = 0, o = i - sp; k < n_merges; ++k, ++o) {
          if ((o >> 2) != mq) {  // four merge uniforms to an evaluation
            mq = o >> 2;
            mw = philox4x32_10(
                U32x4{chain, step, kDoublingDraw + (uint32_t)j,
                          1u + (uint32_t)mq},
                k0, k1);
          }
          const int q = o & 3;
          const uint32_t bits =
              q == 0 ? mw.x : q == 1 ? mw.y : q == 2 ? mw.z : mw.w;
          float* a = row(sp - 1 - k);
          const float* b = row(sp - k);
          const float n_a = a[kN * S], n_b = b[kN * S];
          const bool take_b =
              unit_open(bits) < n_b / fmaxf(n_a + n_b, 1.0f);
          const bool ok = merge_no_uturn<D>(xa, ma, a + kFirstPos * S,
                                                a + kFirstMom * S, S, v);
          if (take_b) {
#pragma unroll
            for (int d = 0; d < D; ++d) {
              a[(kProp + d) * S] = b[(kProp + d) * S];
            }
          }
          a[kN * S] = n_a + n_b;
          st_s = st_s && ok;
        }
      }

      // the end on side v has moved (xa); progressive accept
      // u < min(1, n' / n) (nuts.rs:656-663), then the U-turn check
      // between the ends
      const float ratio = (float)st_n / (float)n;
      if (st_s && u_accept < fminf(1.0f, ratio)) {
        const float* root = row(0);
#pragma unroll
        for (int d = 0; d < D; ++d) sel[d] = root[(kProp + d) * S];
      }
      n += st_n;
      float dot_m = 0.0f, dot_p = 0.0f;
      const bool plus = v > 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float dd = plus ? xa[d] - xo[d] : xo[d] - xa[d];
        dot_m += dd * (plus ? mo[d] : ma[d]);
        dot_p += dd * (plus ? ma[d] : mo[d]);
      }
      alpha = st_alpha;
      n_alpha = st_n_alpha;
      diverged |= st_div;
      s = st_s && dot_m >= 0.0f && dot_p >= 0.0f;
    }

    if (valid) {
#pragma unroll
      for (int d = 0; d < D; ++d) pos_out[(long long)c * D + d] = sel[d];
      alpha_out[c] = alpha;
      n_alpha_out[c] = (float)n_alpha;
      diverged_out[c] = diverged ? 1.0f : 0.0f;
      depth_out[c] = (float)j;
    }
  }

  if (stats != nullptr) {
    // the warp's lane-iterations, and the leaves its lanes integrated
    const unsigned warp_iterations = __reduce_add_sync(kFull, iterations);
    const unsigned warp_leaves = __reduce_add_sync(kFull, leaves);
    if (lane == 0) {
      atomicAdd(stats, 32ull * warp_iterations);
      atomicAdd(stats + 1, (unsigned long long)warp_leaves);
    }
  }
  // the last block to finish resets the chain counter for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counter + 1, 1u) == gridDim.x - 1) {
      atomicExch(counter, 0u);
      atomicExch(counter + 1, 0u);
    }
  }
}

struct StepArgs {
  const void *pos, *eps, *params;
  int depth_limit;
  uint32_t k0, k1, step, chain0;
  int n_chains, blocks;
  void *counter, *stats, *pos_out, *alpha, *n_alpha, *diverged, *depth;
  int device;
  int* grid;  // when given: blocks per SM, SMs, the launch's blocks and
              // threads a block
  void* stream;
};

template <class T, int D>
int launch_step(const StepArgs& a) {
  constexpr int kT = step_threads<D>();
  static_assert(step_stack_bytes<D>(kMaxDepth, kT) <= kMaxBlockSmem,
                "the depth-10 stack does not fit a block of one warp");
  auto kernel = nuts_step_kernel<T, D>;
  // the deepest stack's limit, on every launch: it belongs to the current
  // device's context
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)step_stack_bytes<D>(kMaxDepth, kT));
  if (set != cudaSuccess) return (int)set;
  const size_t smem =
      step_stack_bytes<D>(a.depth_limit > 0 ? a.depth_limit : 1, kT);
  int per_sm = 0, sms = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kT,
                                                    smem);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               a.device);
  }
  if (e != cudaSuccess) return (int)e;
  int blocks = a.blocks > 0 ? a.blocks : per_sm * sms;
  if (blocks > (a.n_chains + kT - 1) / kT) {
    blocks = (a.n_chains + kT - 1) / kT;
  }
  if (blocks < 1) blocks = 1;
  if (a.grid != nullptr) {
    a.grid[0] = per_sm;
    a.grid[1] = sms;
    a.grid[2] = blocks;
    a.grid[3] = kT;
  }
  kernel<<<blocks, kT, smem, (cudaStream_t)a.stream>>>(
      (const float*)a.pos, (const float*)a.eps, (const float*)a.params,
      a.depth_limit, a.k0, a.k1, a.step, a.chain0, a.n_chains,
      (unsigned*)a.counter, (unsigned long long*)a.stats,
      (float*)a.pos_out, (float*)a.alpha, (float*)a.n_alpha,
      (float*)a.diverged, (float*)a.depth);
  return (int)cudaGetLastError();
}

}  // namespace mm
