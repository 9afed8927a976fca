// Philox4x32-10 counter-based generator (Salmon et al., SC'11), device side.
//
// Replaces the TPU hardware PRNG helpers of mini_mcmc_tpu/ops/pallas/rng.py
// (`uniform`, `normals`, `bits_to_unit_open`). The TPU kernels seed one
// hardware stream per grid block; here every draw is a pure function of
// (key, counter), so the stream depends neither on the launch grid nor on
// the block size, and no generator state lives in memory.
//
// Key: the full 64-bit per-run seed as two words (folding it to 32 bits
// would birthday-collide after ~2^16 runs, see rng.py:key_to_seed).
// Counter: (chain index, global step, draw index, sub-draw). Two chains
// never share a counter, and neither do two steps of one chain.
//
// Draw indices, per kernel (D = the dimension):
//   HMC (Kernel 2) reads one word stream per (chain, step) (step_words,
//     below): W = 2 ceil(D / 2) + 1 words, momentum normals 2p and 2p + 1
//     the cosine and sine of box_muller_pair(w[2p], w[2p + 1]), the accept
//     uniform word 2 ceil(D / 2): one evaluation a step at D <= 2, two at
//     D = 3, 4.
//   NUTS step (Kernel 4), one evaluation per four words the step uses
//     plus at most one per doubling: draw 0 the momentum (box_muller_pair
//     on words x, y) and the Exp(1) uniform of the slice (word z) at
//     D <= 2; at D > 2 draws 0..Q-1 the momenta four to an evaluation
//     (normals4_at: draw q, words x, y the cosine and sine of momenta
//     4q, 4q + 1, words z, w of 4q + 2, 4q + 3; Q = ceil(D / 4), one at
//     D = 3, 4) and draw Q's word x the slice. Draw 0x10000 + j is
//     doubling j: sub-draw 0 its direction coin (word x) and
//     progressive-accept uniform (word y), sub-draw 1 + q its merge
//     uniforms of ordinals 4q..4q+3 (words x, y, z, w), the merge at
//     leaf i, cascade position k having ordinal i - popcount(i) + k
//     (the merges of a doubling's 2^j leaves take ordinals 0..2^j - 2).
//   NUTS subtree seeds (use_pallas=True tier, ops/nuts.py): chain 0,
//     draw 0x20000 + j gives the two words of doubling j's hash seed;
//     chain 0, draw 0x30000 seeds the step's torch.Generator (the
//     use_pallas=False and True tiers).
//   MH (Kernel 5) and Gibbs (Kernel 6) read one word stream per (chain,
//     step): the words of the counters (chain, step, q, 0), q = 0, 1, ...,
//     ceil(W / 4) - 1, in order (step_words), W the words the step uses.
//     An isotropic Gaussian walk at D takes normals 2p and 2p + 1 from the
//     cosine and sine of box_muller_pair(w[2p], w[2p + 1]), p <
//     ceil(D / 2), and its accept uniform from word 2 ceil(D / 2): at
//     D = 2 words x, y the normals and z the accept, one evaluation; at
//     D = 3 draw 0's four words the normals (the last sine unused) and
//     draw 1's word x the accept, two. The +-1 integer walk takes coin d
//     from the top bit of word d (clear meaning +1) and the accept from
//     word D. The Gibbs mixture takes x's normal from box_muller(w[0],
//     w[1]) (the cosine) and z's uniform from word 2: one evaluation a
//     sweep.
//   Separable HMC (Kernel 7): draw q, sub-draw 0, gives the momenta of
//     coordinates 4q..4q+3 by paired Box-Muller (normals4_at): words x, y
//     the cosine and sine of one pair (4q, 4q+1), words z, w of the next
//     (4q+2, 4q+3). One evaluation per four coordinates, the least a step
//     needs. Draw 0, sub-draw 1, word x is the chain's accept uniform
//     (both the fused and the two-pass form).
//   Parallel tempering (Kernel 8), one evaluation per (chain, rung, step,
//     sweep): draw t, sub-draw i gives rung t's sweep i, words x, y its
//     proposal normal (box_muller at D = 1, box_muller_pair at D = 2),
//     word z its accept uniform, and at i = 0 word w the swap uniform of
//     pair (t, t+1).
// Every draw is then a function of its place in the run alone.
//
// The plain PyTorch twin (mini_mcmc_torch/ops/kernels/rng.py) computes the
// same rounds in int64 arithmetic and gives the same bits.
#pragma once

#include <stdint.h>

namespace mm {

struct U32x4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U32x4 philox4x32_10(U32x4 c, uint32_t k0,
                                               uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = U32x4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// rng.py:bits_to_unit_open: the top 24 bits to (0, 1), never 0. The
// product is by a power of two, so it is exact and an FMA contraction
// rounds exactly as the separate multiply and add do.
__device__ __forceinline__ float unit_open(uint32_t bits) {
  return (float)(int)(bits >> 8) * (1.0f / 16777216.0f) +
         (1.0f / 33554432.0f);
}

// rng.py:normals: Box-Muller, cos branch, from two words of one draw.
// Full-precision logf/sqrtf/cosf: the fast intrinsics would move the tails.
__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const float u1 = unit_open(a);
  const float u2 = unit_open(b);
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.283185307179586f * u2);
}

// rng.py:normals_paired: both Box-Muller outputs of one angle, the cosine
// into c and the sine into s.
__device__ __forceinline__ void box_muller_pair(uint32_t a, uint32_t b,
                                                float& c, float& s) {
  const float r = sqrtf(-2.0f * logf(unit_open(a)));
  float sn, cs;
  sincosf(6.283185307179586f * unit_open(b), &sn, &cs);
  c = r * cs;
  s = r * sn;
}

// Four normals from one evaluation (the separable kernel's momenta).
__device__ __forceinline__ void normals4_at(uint32_t chain, uint32_t step,
                                            uint32_t draw, uint32_t k0,
                                            uint32_t k1, float (&n)[4]) {
  const U32x4 w = philox4x32_10(U32x4{chain, step, draw, 0u}, k0, k1);
  box_muller_pair(w.x, w.y, n[0], n[1]);
  box_muller_pair(w.z, w.w, n[2], n[3]);
}

__device__ __forceinline__ float uniform_at(uint32_t chain, uint32_t step,
                                            uint32_t draw, uint32_t k0,
                                            uint32_t k1, uint32_t sub = 0u) {
  const U32x4 w = philox4x32_10(U32x4{chain, step, draw, sub}, k0, k1);
  return unit_open(w.x);
}

// The Philox evaluations a step of W words takes, and its word stream's
// length.
template <int W>
__host__ __device__ constexpr int stream_evals() {
  return (W + 3) / 4;
}

// One (chain, step)'s word stream (Kernels 2, 5 and 6): word 4q + j is
// word j of the counter (chain, step, q, 0).
template <int W>
__device__ __forceinline__ void step_words(
    uint32_t chain, uint32_t step, uint32_t k0, uint32_t k1,
    uint32_t (&w)[4 * stream_evals<W>()]) {
#pragma unroll
  for (int q = 0; q < stream_evals<W>(); ++q) {
    const U32x4 r = philox4x32_10(U32x4{chain, step, (uint32_t)q, 0u}, k0,
                                  k1);
    w[4 * q] = r.x;
    w[4 * q + 1] = r.y;
    w[4 * q + 2] = r.z;
    w[4 * q + 3] = r.w;
  }
}

}  // namespace mm
