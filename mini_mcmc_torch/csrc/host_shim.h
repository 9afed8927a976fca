// Host build of the device headers that a user form needs
// (user_density.cuh, targets.cuh, proposals.cuh, conditionals.cuh,
// coord_targets.cuh, philox.cuh), for the CPU tests only: g++ compiles a
// density's, proposal's, conditional's or coordinate functor's source with
// the same text as nvcc, and the tests run its probe through ctypes
// (ops/kernels/user_density.py:host_probe_lib, _host_load). No
// sampler uses this build. It defines the CUDA qualifiers and the few
// intrinsics those headers name, as the plain host operations they round
// like; the one block of a host "launch" has one thread.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

struct HostDim3 {
  unsigned x;
};
static const HostDim3 threadIdx{0u};
static const HostDim3 blockDim{1u};

inline void __syncthreads() {}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline int max(int a, int b) { return a < b ? b : a; }
inline int min(int a, int b) { return a < b ? a : b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}
