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
