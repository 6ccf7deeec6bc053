// K2: per-patch sampling regions for one scale.
//
// Replaces the TPU kernel dis_tpu/ops/pallas/extract_kernel.py::
// extract_regions_pallas (kernel body `kern`).  For each patch it copies the
// rc x rc window (rc = 2 ps + 3) of the padded level plane at
//   base = clip(ceil(pos0 + 1e-5f) + pad - ps - 2, 0, dim - rc)
// (the Q10 tap base in float32, clipped to +-1e6 before the int cast; a
// stripe's row0, the global row of the plane's first row, is subtracted
// from the y base only) and writes the bases.  A pure copy: equal to the
// plain PyTorch version bitwise.
//
// Bound on the H100: memory.  At the 1080p finest scale it writes 82,944 x
// 361 floats (about 120 MB) and reads the same windows, which overlap and
// mostly hit L2.  One warp per patch computes the base itself (no separate
// pass over pos0) and walks the window with consecutive lanes on consecutive
// region elements, so the stores of a warp are one contiguous run.  The
// TPU kernel's aligned slabs and rolls have no counterpart: any base is
// addressed directly.  N = 0 launches nothing.
//
// K2b, the batched form (replaces _run_vmap / kern_batched of the same TPU
// file): nb pairs are one launch over nb * n warps, one warp per (pair,
// patch), pair-major; warp g reads plane g / n.  The TPU kernel's copy of
// each pair's plane into VMEM has no counterpart (the plane is read from
// device memory through L2).  nb = 1 is K2; the math is the same lines.
// Offsets are size_t: at 1080p with 8 pairs the regions buffer holds
// 663,552 x 361 floats.

#include <cuda_runtime.h>

#include "dis_common.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
extract_kernel(const float* __restrict__ img, int th, int tw, const float* __restrict__ pos0,
               long long total, int n, int ps, int pad, int row0, float* __restrict__ regions,
               int* __restrict__ base_y, int* __restrict__ base_x) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);  // pair * n + patch
  if (i >= total) return;
  const long long pair = i / n;
  const int rc = 2 * ps + 3;
  const int by = min(max(dis_ceil_coord(pos0[2 * i + 1]) + pad - row0 - ps - 2, 0), th - rc);
  const int bx = min(max(dis_ceil_coord(pos0[2 * i]) + pad - ps - 2, 0), tw - rc);
  if (lane == 0) {
    base_y[i] = by;
    base_x[i] = bx;
  }
  const float* src = img + ((size_t)pair * th + by) * tw + bx;
  float* dst = regions + (size_t)i * rc * rc;
  for (int e = lane; e < rc * rc; e += 32) {
    const int r = e / rc;
    dst[e] = src[(size_t)r * tw + (e - r * rc)];
  }
}

}  // namespace

// img [nb, th, tw] padded level planes whose first row is global row
// row0; pos0 [nb, n, 2] (x, y) start positions; regions [nb, n, rc, rc];
// base_y, base_x [nb, n] int32.
extern "C" int dis_extract_regions(const float* img, int nb, int th, int tw, const float* pos0,
                                   int n, int ps, int pad, int row0, float* regions,
                                   int* base_y, int* base_x, cudaStream_t stream) {
  const long long total = (long long)nb * n;
  if (total > 0)
    extract_kernel<<<(unsigned)((total + WARPS - 1) / WARPS), WARPS * 32, 0, stream>>>(
        img, th, tw, pos0, total, n, ps, pad, row0, regions, base_y, base_x);
  return (int)cudaGetLastError();
}
