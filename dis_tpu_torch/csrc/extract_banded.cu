// K2c: per-patch sampling regions, column-banded (4K frames and stripes).
//
// Replaces the TPU kernel dis_tpu/ops/pallas/extract_kernel.py::
// extract_regions_banded (kernel body `kern`).  Same function as K2: each
// patch's rc x rc window (rc = 2 ps + 3) of the padded level plane at
//   base = clip(ceil(pos0 + 1e-5f) + pad - ps - 2, 0, dim - rc)
// (Q10 tap base in float32; a stripe's row0, the global row of the plane's
// first row, is subtracted from the y base only), and the bases.  A pure
// copy: equal bitwise to the plain PyTorch version and to K2.
//
// The TPU kernel DMAs a full-height [th, 384] column band into VMEM per
// grid column; a 4K band is 3.3 MB and a Hopper block has at most 227 KB of
// shared memory, so the band does not carry over.  Here the patches are
// x-outer, so a grid column (one center x, every y) is contiguous, and its
// bases spread in x only by the bounded init flow.  One block per (pair,
// grid column, group of `group` consecutive patches of the column):
//   1. warp 0 computes the group's bases, writes them, and reduces them to
//      their bounding box (min and max are order-free, so this is exact);
//   2. the block stages that box of the plane into dynamic shared memory
//      with row-contiguous (coalesced) loads;
//   3. each warp copies its patches' windows out of shared memory with the
//      contiguous stores of K2.
// The shared memory is sized by the caller from the static init bound the
// route checks (rows_cap x cols_cap), so under the Q9 policing chain every
// window lies in the staged box.  The result never depends on that: a box
// larger than the capacity is staged in part, and a patch whose window
// falls outside the staged part is copied from device memory by its warp
// (and counted in *outside when the caller passes a counter).
//
// Bound on the H100: memory, as K2 (at the 4K finest scale it writes
// 331,776 x 361 floats, about 479 MB).  The box a block stages is read from
// device memory once, instead of once per overlapping window.  nb = 0,
// num_w = 0 or num_h = 0 launches nothing.

#include <cuda_runtime.h>

#include <climits>

#include "dis_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
banded_kernel(const float* __restrict__ img, int th, int tw, const float* __restrict__ pos0,
              int num_w, int num_h, int group, int ps, int pad, int row0, int rows_cap,
              int cols_cap, float* __restrict__ regions, int* __restrict__ base_y,
              int* __restrict__ base_x, int* __restrict__ outside) {
  extern __shared__ int smem[];
  int* sby = smem;                  // [group] bases of the block's patches
  int* sbx = smem + group;
  int* box = smem + 2 * group;      // y0, x0, rows, cols of the staged box
  float* tile = reinterpret_cast<float*>(smem + 2 * group + 4);

  const int groups = (num_h + group - 1) / group;
  const int col = blockIdx.x / groups;
  const int first = (blockIdx.x - col * groups) * group;
  const int cnt = min(group, num_h - first);
  const int rc = 2 * ps + 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Flat index (pair * n + patch) of the block's first patch.
  const size_t p0 = (size_t)blockIdx.y * num_w * num_h + (size_t)col * num_h + first;
  const float* plane = img + (size_t)blockIdx.y * th * tw;

  if (warp == 0) {
    int ylo = INT_MAX, xlo = INT_MAX, yhi = INT_MIN, xhi = INT_MIN;
    if (lane < cnt) {
      const size_t i = p0 + lane;
      const int by = min(max(dis_ceil_coord(pos0[2 * i + 1]) + pad - row0 - ps - 2, 0), th - rc);
      const int bx = min(max(dis_ceil_coord(pos0[2 * i]) + pad - ps - 2, 0), tw - rc);
      base_y[i] = by;
      base_x[i] = bx;
      sby[lane] = by;
      sbx[lane] = bx;
      ylo = yhi = by;
      xlo = xhi = bx;
    }
    for (int off = 16; off > 0; off >>= 1) {
      ylo = min(ylo, __shfl_xor_sync(FULL, ylo, off));
      xlo = min(xlo, __shfl_xor_sync(FULL, xlo, off));
      yhi = max(yhi, __shfl_xor_sync(FULL, yhi, off));
      xhi = max(xhi, __shfl_xor_sync(FULL, xhi, off));
    }
    if (lane == 0) {
      box[0] = ylo;
      box[1] = xlo;
      box[2] = min(yhi - ylo + rc, rows_cap);
      box[3] = min(xhi - xlo + rc, cols_cap);
    }
  }
  __syncthreads();
  const int y0 = box[0], x0 = box[1], rows = box[2], cols = box[3];
  for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
    const int r = e / cols;
    tile[e] = plane[(size_t)(y0 + r) * tw + x0 + (e - r * cols)];
  }
  __syncthreads();

  for (int t = warp; t < cnt; t += WARPS) {
    const int dy = sby[t] - y0, dx = sbx[t] - x0;
    float* dst = regions + (p0 + t) * rc * rc;
    if (dy + rc <= rows && dx + rc <= cols) {
      const float* src = tile + dy * cols + dx;
      for (int e = lane; e < rc * rc; e += 32) {
        const int r = e / rc;
        dst[e] = src[r * cols + (e - r * rc)];
      }
    } else {
      const float* src = plane + (size_t)sby[t] * tw + sbx[t];
      for (int e = lane; e < rc * rc; e += 32) {
        const int r = e / rc;
        dst[e] = src[(size_t)r * tw + (e - r * rc)];
      }
      if (lane == 0 && outside != nullptr) atomicAdd(outside, 1);
    }
  }
}

// Lets the kernel take more than 48 KB of dynamic shared memory, once per
// device (before any stream capture: the first launch runs eagerly).
int allow_smem(int bytes) {
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || bytes <= allowed[dev]) return 0;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  allowed[dev] = optin;
  return 0;
}

}  // namespace

// img [nb, th, tw] padded level planes whose first row is global row row0;
// pos0 [nb, n, 2] (x, y) start positions of an x-outer grid, n = num_w *
// num_h; regions [nb, n, rc, rc]; base_y, base_x [nb, n] int32.  A block
// takes `group` (1..32) consecutive patches of one grid column and stages
// at most rows_cap x cols_cap floats of the plane.  outside, when not null,
// gets the count of patches copied from device memory.  Returns
// cudaGetLastError() after the launch.
extern "C" int dis_extract_banded(const float* img, int nb, int th, int tw, const float* pos0,
                                  int num_w, int num_h, int group, int ps, int pad, int row0,
                                  int rows_cap, int cols_cap, float* regions, int* base_y,
                                  int* base_x, int* outside, cudaStream_t stream) {
  const int rc = 2 * ps + 3;
  if (group < 1 || group > 32 || rows_cap < rc || cols_cap < rc || nb > 65535)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || num_w <= 0 || num_h <= 0) return (int)cudaGetLastError();
  const long long blocks = (long long)num_w * ((num_h + group - 1) / group);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(2 * group + 4) * sizeof(int)
                       + (size_t)rows_cap * cols_cap * sizeof(float);
  if (bytes > (size_t)INT_MAX) return (int)cudaErrorInvalidValue;
  const int err = allow_smem((int)bytes);
  if (err != 0) return err;
  banded_kernel<<<dim3((unsigned)blocks, (unsigned)nb), THREADS, bytes, stream>>>(
      img, th, tw, pos0, num_w, num_h, group, ps, pad, row0, rows_cap, cols_cap, regions,
      base_y, base_x, outside);
  return (int)cudaGetLastError();
}
