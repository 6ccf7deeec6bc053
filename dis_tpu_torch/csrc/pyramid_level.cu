// K3: one gradient-magnitude pyramid level in one pass.
//
// Replaces the TPU kernel dis_tpu/ops/pallas/pyramid_kernel.py::_level_kernel
// (driven by pyramid_level_pallas).  Writes the level's three padded planes
// [h + 2p, w + 2p]: the level image replicate-padded, and its Sobel dx, dy
// (3x3, x1/8, reflect-101) zero-padded.  The level image is
//   base:     the Sobel magnitude of the raw [h, w] image (quirk Q1);
//   decimate: the x0.5 box mean ((a + c) + (b + d)) * 0.25 of the finer
//             level's padded image plane, fused in (the TPU kernel left it
//             to XLA).
// Every stencil keeps the operation order of dis_tpu_torch/ops/image.py and
// the build passes -fmad=false, so no multiply-add is contracted and the
// planes equal the plain PyTorch version bitwise.  The magnitude's own
// border is reflect-101 of the magnitude index, as the plain version's
// sobel3(gradient_magnitude(img)) sees it.
//
// Bound on the H100: memory.  It reads one plane and writes three (about
// 8 + 3 x 8.5 MB for a 1080p base level).  Each 32 x 8 block stages the
// level values of its outputs plus a 1-pixel halo in shared memory, so each
// level value (a 3x3 Sobel magnitude at the base level) is computed about
// 1.3 times instead of 9; output rows are written coalesced.  It runs at any
// size: nothing depends on the frame fitting on chip.
//
// A batch of planes (the pair axis of batched flow) is one launch: blockIdx.z
// picks the plane, and every plane is computed exactly as it is alone.  The
// TPU side has no batched Pallas kernel here: its vmap rule routes batches
// through XLA.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// Sobel magnitude of the raw image s[h, w] at (y, x), reflect-101 border.
__device__ __forceinline__ float sobel_magnitude(const float* __restrict__ s,
                                                 int h, int w, int y, int x) {
  const int ym = reflect101(y - 1, h), yp = reflect101(y + 1, h);
  const int xm = reflect101(x - 1, w), xp = reflect101(x + 1, w);
  const float* rm = s + (size_t)ym * w;
  const float* r0 = s + (size_t)y * w;
  const float* rp = s + (size_t)yp * w;
  const float gx = (((rm[xp] - rm[xm]) + 2.0f * (r0[xp] - r0[xm])) + (rp[xp] - rp[xm])) * 0.125f;
  const float gy = (((rp[xm] - rm[xm]) + 2.0f * (rp[x] - rm[x])) + (rp[xp] - rm[xp])) * 0.125f;
  return sqrtf(gx * gx + gy * gy);
}

// Level value at (y, x): base -> magnitude of src[h, w]; decimate -> box mean
// of the finer padded plane src (row stride src_w, interior at offset p).
template <bool BASE>
__device__ __forceinline__ float level_value(const float* __restrict__ src, int src_w,
                                             int h, int w, int p, int y, int x) {
  if (BASE) return sobel_magnitude(src, h, w, y, x);
  const float* r0 = src + (size_t)(p + 2 * y) * src_w + p + 2 * x;
  const float* r1 = r0 + src_w;
  return ((r0[0] + r1[0]) + (r0[1] + r1[1])) * 0.25f;
}

template <bool BASE>
__global__ void __launch_bounds__(TX * TY)
level_kernel(const float* __restrict__ src, int src_h, int src_w, float* __restrict__ img,
             float* __restrict__ dx, float* __restrict__ dy, int h, int w, int p) {
  __shared__ float tile[TY + 2][TX + 2];
  const size_t out_plane = (size_t)(h + 2 * p) * (w + 2 * p);
  src += (size_t)blockIdx.z * src_h * src_w;
  img += blockIdx.z * out_plane;
  dx += blockIdx.z * out_plane;
  dy += blockIdx.z * out_plane;
  const int ox0 = blockIdx.x * TX, oy0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int e = tid; e < (TY + 2) * (TX + 2); e += TX * TY) {
    const int ty = e / (TX + 2), tx = e - ty * (TX + 2);
    const int y = reflect101(oy0 - p - 1 + ty, h);
    const int x = reflect101(ox0 - p - 1 + tx, w);
    tile[ty][tx] = level_value<BASE>(src, src_w, h, w, p, y, x);
  }
  __syncthreads();

  const int ow = w + 2 * p;
  const int ox = ox0 + threadIdx.x, oy = oy0 + threadIdx.y;
  if (ox >= ow || oy >= h + 2 * p) return;
  const int y = oy - p, x = ox - p;
  const size_t o = (size_t)oy * ow + ox;
  if (y < 0 || y >= h || x < 0 || x >= w) {
    img[o] = level_value<BASE>(src, src_w, h, w, p, min(max(y, 0), h - 1),
                               min(max(x, 0), w - 1));
    dx[o] = 0.0f;
    dy[o] = 0.0f;
    return;
  }
  const int ty = threadIdx.y, tx = threadIdx.x;
  const float a00 = tile[ty][tx], a01 = tile[ty][tx + 1], a02 = tile[ty][tx + 2];
  const float a10 = tile[ty + 1][tx], a12 = tile[ty + 1][tx + 2];
  const float a20 = tile[ty + 2][tx], a21 = tile[ty + 2][tx + 1], a22 = tile[ty + 2][tx + 2];
  img[o] = tile[ty + 1][tx + 1];
  dx[o] = (((a02 - a00) + 2.0f * (a12 - a10)) + (a22 - a20)) * 0.125f;
  dy[o] = (((a20 - a00) + 2.0f * (a21 - a01)) + (a22 - a02)) * 0.125f;
}

}  // namespace

// nplanes planes, each contiguous.  base != 0: src is the raw [nplanes, h, w]
// image.  base == 0: src is the finer level's padded image plane
// [nplanes, 2h + 2p, 2w + 2p].  Outputs are [nplanes, h + 2p, w + 2p] each.
// nplanes <= 65535.  Returns cudaGetLastError() after the launch.
extern "C" int dis_pyramid_level(const float* src, int src_h, int src_w, float* img,
                                 float* dx, float* dy, int nplanes, int h, int w, int p,
                                 int base, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((w + 2 * p + TX - 1) / TX, (h + 2 * p + TY - 1) / TY, nplanes);
  if (base)
    level_kernel<true><<<grid, block, 0, stream>>>(src, src_h, src_w, img, dx, dy, h, w, p);
  else
    level_kernel<false><<<grid, block, 0, stream>>>(src, src_h, src_w, img, dx, dy, h, w, p);
  return (int)cudaGetLastError();
}

extern "C" const char* dis_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
