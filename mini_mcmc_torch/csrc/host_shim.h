// Host build of the device headers that a user density needs
// (user_density.cuh, targets.cuh), for the CPU tests only: g++ compiles a
// density's source with the same text as nvcc, and the tests run its
// probe through ctypes (ops/kernels/user_density.py:host_probe_lib). No
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
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}
