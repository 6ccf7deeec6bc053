// Helpers shared by the kernels of dis_tpu_torch.
#pragma once

#include <cuda_runtime.h>

// Q10 tap base: ceil(v + 1e-5f) in float32, clipped to +-1e6 before the
// int cast so that far out-of-range (frozen) positions stay defined; the
// plain version is ops/iclk.py::_ceil_coord.
__device__ __forceinline__ int dis_ceil_coord(float v) {
  const float c = ceilf(v + 1e-5f);
  return (int)fminf(fmaxf(c, -1e6f), 1e6f);
}

// An asynchronous 4-byte copy from device to shared memory (cached in L1
// too, so that neighbouring windows read again from there), and the waits.
// S1 and S4 (scale_glue.cu), K1 (iclk.cu) and K2/K2c (extract_group.cuh)
// stage with them.
__device__ __forceinline__ void dis_cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void dis_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void dis_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Sum of a patch's taps held by a group of G lanes, K taps a lane (taps
// past the patch are zero): the in-lane pair tree, then the xor butterfly
// over the G lanes of the group (offsets below G stay inside the group).
// That is the balanced pair tree of ops/iclk.py::pairwise_sum over the
// taps zero-padded to G * K, and float addition is commutative, so every
// lane of the group holds the same bits.  K1 (iclk.cu) and S1 and S3
// (scale_glue.cu) sum with it; every lane of the warp must call it.
template <int K, int G>
__device__ __forceinline__ float dis_group_sum(const float (&v)[K]) {
  float t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = v[k];
#pragma unroll
  for (int width = K; width > 1; width >>= 1) {
#pragma unroll
    for (int k = 0; k < width / 2; ++k) t[k] = t[2 * k] + t[2 * k + 1];
  }
  float s = t[0];
#pragma unroll
  for (int off = 1; off < G; off <<= 1) s = s + __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The dynamic shared memory a family of kernels may take on this device:
// the opt-in maximum less a kernel's static shared memory, granted to each
// of fns once per device (never per shape, so that a later launch never
// lowers it).  The least of them; 0 on an error.  S1 and S4
// (scale_glue.cu) and R23 (variational.cu) ask through it.
template <int N>
int dis_shared_limit(int (&granted)[64], const void* const (&fns)[N]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (granted[dev] == 0) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
      return 0;
    int least = optin;
    for (const void* fn : fns) {
      cudaFuncAttributes attr;
      if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return 0;
      const int dynamic = optin - (int)attr.sharedSizeBytes;
      if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic) !=
          cudaSuccess)
        return 0;
      least = dynamic < least ? dynamic : least;
    }
    granted[dev] = least;
  }
  return granted[dev];
}
