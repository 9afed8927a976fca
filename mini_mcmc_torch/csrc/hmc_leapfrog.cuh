// Kernel 1: the L-step leapfrog trajectory at a runtime step size.
//
// The kernel template and its launch, shared by the built-in library
// (hmc_leapfrog.cu, every instance of MM_DISPATCH) and the per-density
// libraries of user targets (ops/kernels/user_density.py).
//
// Replaces mini_mcmc_tpu/ops/pallas/hmc.py:make_pallas_leapfrog, with its
// contract: (pos, mom, grad [C, D], eps) -> (pos', mom', grad' [C, D],
// logp' [C]). Momentum comes in and no accept happens here; the caller
// (ops/hmc.py, use_pallas=True) draws momentum and accepts.
//
// What bounds it on the H100, by row of PERF.md (tools/k1_times.py):
// - L = 1 and L = 8 on 65,536 chains (the MALA tuning path, the float64
//   tier's checks): bytes, (6 D + 1) scalars a chain against a few dozen
//   operations a step, and in a grid of one wave the latency of each
//   thread's loads before its first step. The TPU kernel moves [D, 8,
//   C/8] tiles; a CUDA thread holds one chain, so a row of [C, D] is
//   what a thread reads. A row of 8 bytes or a multiple of 16 (float D =
//   2, 4, 8, ...; double D = 2, 4, ...) moves as 8- or 16-byte vectors.
//   A double row of odd D (3, 5, ...) moves through shared memory: the
//   block's rows of each array are one span, copied in 16-byte pieces
//   (cp.async) and written back in 16-byte stores, each thread reading
//   and writing its own row there (odd stride: no bank conflict); strided
//   8-byte loads left the float64 user density at D = 5 at 2.4 times the
//   staged time. A float row of other D moves element by element: staged,
//   it ran slower at D = 3 and 10. With a pointer off 16 bytes (a view at
//   a row offset) each thread reads and writes its own row element by
//   element; the ragged last block's span is copied element by element.
// - L = 192 (the use_pallas=True flagship tier): operations, about 21
//   lane instructions a leapfrog at D = 3; the FP32 pipe and each chain's
//   dependent chain of operations set the time. FP64 issues at half the
//   FP32 rate and has no MUFU, so a float64 trajectory is bound by the
//   FP64 pipe (a funnel's or a bijector's exp and log1p are libm
//   sequences of some twenty FP64 operations).
// - The user densities at 4,096 chains (one block an SM): one warp's
//   dependent chain through the density (as measured for Kernel 4,
//   PERF.md). Taking the last logp from the last gradient's dual pass
//   (L passes where grad, then logp take L + 1) ran one of these rows
//   faster and two slower, and rounded the float32 dual forms' momenta
//   and gradients otherwise than the loop does, so every functor runs
//   the loop, then logp (leapfrog_chain).
// 128 threads a block, one chain a thread: 256 measured the same at L =
// 1, 64 and two chains a thread slower.
//
// The scalar S is the functor's (targets.cuh:scalar_t): float, or double
// in the float64 instances (mm_leapfrog_f64; the JAX kernel takes the
// state's dtype and runs float64 under jax_enable_x64).
#pragma once

#include "hmc_common.cuh"

namespace mm {

// One chain's trajectory: L leapfrog steps of the cached half-step
// gradient from (x, m, g), then the logp at the end. L = 0 leaves g as
// passed and returns the logp at x, as the JAX kernel does. A plain
// function of registers, so that host_shim.h's g++ build compiles it for
// the CPU tests; the kernel calls it from one site, so that every way a
// row moves runs the same instructions.
template <class T, int D, class S = scalar_t<T>>
__device__ __forceinline__ S leapfrog_chain(const T& t, S (&x)[D],
                                            S (&m)[D], S (&g)[D], S eps,
                                            int n_leapfrog) {
  leapfrog<T, D>(t, x, m, g, eps, n_leapfrog);
  return t.template logp<D>(x);
}

}  // namespace mm

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace mm {

// How a block moves its [C, D] rows, from (S, D): a row of 8 bytes or a
// multiple of 16 as 8- or 16-byte vectors a thread; a double row of odd
// D > 1 through shared memory; any other row element by element (one
// element: a warp's loads are one span already; the float rows of D = 3,
// 5, 6, ...: staged, most of them ran slower, PERF.md).
enum RowMode { kRowScalar, kRowVector, kRowStaged };

template <class S, int D>
__host__ __device__ constexpr int row_mode() {
  constexpr int bytes = (int)sizeof(S) * D;
  return D > 1 && (bytes == 8 || bytes % 16 == 0) ? kRowVector
         : D > 1 && sizeof(S) == 8                 ? kRowStaged
                                                   : kRowScalar;
}

// the piece a kRowVector row moves in: its bits, 8 or 16 bytes
template <class S, int D>
using row_piece_t = std::conditional_t<sizeof(S) * D == 8, uint2, uint4>;

// chain c's row of p, as vectors where the mode and `aligned` allow
template <class S, int D>
__device__ __forceinline__ void load_row(const S* __restrict__ p, int c,
                                         int aligned, S (&r)[D]) {
  if constexpr (row_mode<S, D>() == kRowVector) {
    if (aligned) {
      using V = row_piece_t<S, D>;
      constexpr int kPieces = (int)(sizeof(S) * D / sizeof(V));
      const V* src = reinterpret_cast<const V*>(p) + (size_t)c * kPieces;
      V v[kPieces];
#pragma unroll
      for (int k = 0; k < kPieces; ++k) v[k] = src[k];
      memcpy(r, v, sizeof(v));
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = p[(size_t)c * D + d];
}

template <class S, int D>
__device__ __forceinline__ void store_row(S* __restrict__ p, int c,
                                          int aligned, const S (&r)[D]) {
  if constexpr (row_mode<S, D>() == kRowVector) {
    if (aligned) {
      using V = row_piece_t<S, D>;
      constexpr int kPieces = (int)(sizeof(S) * D / sizeof(V));
      V v[kPieces];
      memcpy(v, r, sizeof(v));
      V* dst = reinterpret_cast<V*>(p) + (size_t)c * kPieces;
#pragma unroll
      for (int k = 0; k < kPieces; ++k) dst[k] = v[k];
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) p[(size_t)c * D + d] = r[d];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// The block's rows of one array, n scalars from g, into its shared span
// sm: a whole block (`whole`: every row there) in 16-byte asynchronous
// copies (L1 bypassed), a fixed count a thread; the ragged last block
// element by element
template <class S, int D>
__device__ __forceinline__ void stage_in(S* sm, const S* __restrict__ g,
                                         int n, bool whole) {
  constexpr int kPieces = kThreads * D * (int)sizeof(S) / 16;
  if (whole) {
#pragma unroll
    for (int k = 0; k < (kPieces + kThreads - 1) / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kPieces) {
        cp_async16(reinterpret_cast<uint4*>(sm) + i,
                   reinterpret_cast<const uint4*>(g) + i);
      }
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < n; i += kThreads) sm[i] = g[i];
  }
}

// the block's shared span sm out to g, as stage_in: 16-byte stores for a
// whole block
template <class S, int D>
__device__ __forceinline__ void stage_out(S* __restrict__ g, const S* sm,
                                          int n, bool whole) {
  constexpr int kPieces = kThreads * D * (int)sizeof(S) / 16;
  if (whole) {
#pragma unroll
    for (int k = 0; k < (kPieces + kThreads - 1) / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kPieces) {
        reinterpret_cast<uint4*>(g)[i] =
            reinterpret_cast<const uint4*>(sm)[i];
      }
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < n; i += kThreads) g[i] = sm[i];
  }
}

// One thread a chain, kThreads chains a block. `aligned`: every [C, D]
// pointer is 16-byte aligned, the same for the whole grid; without it a
// staged or vector row moves element by element, each thread its own.
template <class T, int D, class S = scalar_t<T>>
__global__ void __launch_bounds__(kThreads)
    leapfrog_kernel(const S* __restrict__ pos,
                    const S* __restrict__ mom,
                    const S* __restrict__ grad,
                    const S* __restrict__ eps,
                    const S* __restrict__ params, int n_leapfrog,
                    int n_chains, int aligned, S* __restrict__ pos_out,
                    S* __restrict__ mom_out,
                    S* __restrict__ logp_out,
                    S* __restrict__ grad_out) {
  const int c0 = blockIdx.x * kThreads, c = c0 + threadIdx.x;
  S x[D], m[D], g[D];
  if constexpr (row_mode<S, D>() == kRowStaged) {
    // aligned: the block's rows of pos, mom and grad, then of the outputs,
    // through shared memory; else each thread its own row. One call of
    // the chain's body for both.
    __shared__ __align__(16) S sm[3 * kThreads * D];
    constexpr int kSpan = kThreads * D;
    const int rows = min(kThreads, n_chains - c0), n = rows * D;
    const int r = threadIdx.x * D;
    const bool whole = rows == kThreads, live = c < n_chains;
    if (aligned) {
      stage_in<S, D>(sm, pos + (size_t)c0 * D, n, whole);
      stage_in<S, D>(sm + kSpan, mom + (size_t)c0 * D, n, whole);
      stage_in<S, D>(sm + 2 * kSpan, grad + (size_t)c0 * D, n, whole);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (live) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          x[d] = sm[r + d];
          m[d] = sm[kSpan + r + d];
          g[d] = sm[2 * kSpan + r + d];
        }
      }
    } else if (live) {
      load_row<S, D>(pos, c, 0, x);
      load_row<S, D>(mom, c, 0, m);
      load_row<S, D>(grad, c, 0, g);
    }
    if (live) {
      const T t(params);
      logp_out[c] = leapfrog_chain<T, D>(t, x, m, g, eps[0], n_leapfrog);
    }
    if (aligned) {
      // a thread's own rows: no other thread reads them
      if (live) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          sm[r + d] = x[d];
          sm[kSpan + r + d] = m[d];
          sm[2 * kSpan + r + d] = g[d];
        }
      }
      __syncthreads();
      stage_out<S, D>(pos_out + (size_t)c0 * D, sm, n, whole);
      stage_out<S, D>(mom_out + (size_t)c0 * D, sm + kSpan, n, whole);
      stage_out<S, D>(grad_out + (size_t)c0 * D, sm + 2 * kSpan, n, whole);
    } else if (live) {
      store_row<S, D>(pos_out, c, 0, x);
      store_row<S, D>(mom_out, c, 0, m);
      store_row<S, D>(grad_out, c, 0, g);
    }
    return;
  }
  if (c >= n_chains) return;
  load_row<S, D>(pos, c, aligned, x);
  load_row<S, D>(mom, c, aligned, m);
  load_row<S, D>(grad, c, aligned, g);
  const T t(params);
  logp_out[c] = leapfrog_chain<T, D>(t, x, m, g, eps[0], n_leapfrog);
  store_row<S, D>(pos_out, c, aligned, x);
  store_row<S, D>(mom_out, c, aligned, m);
  store_row<S, D>(grad_out, c, aligned, g);
}


struct LeapfrogArgs {
  const void *pos, *mom, *grad, *eps, *params;
  int n_leapfrog, n_chains, aligned;
  void *pos_out, *mom_out, *logp_out, *grad_out;
  void* stream;
};

template <class T, int D>
int launch_leapfrog(const LeapfrogArgs& a) {
  using S = scalar_t<T>;
  leapfrog_kernel<T, D><<<blocks_for(a.n_chains), kThreads, 0,
                          (cudaStream_t)a.stream>>>(
      (const S*)a.pos, (const S*)a.mom, (const S*)a.grad, (const S*)a.eps,
      (const S*)a.params, a.n_leapfrog, a.n_chains, a.aligned,
      (S*)a.pos_out, (S*)a.mom_out, (S*)a.logp_out, (S*)a.grad_out);
  return (int)cudaGetLastError();
}

}  // namespace mm
#endif  // __CUDACC__
