// K3: the gradient-magnitude pyramid, every level of it in one launch.
//
// Replaces the TPU kernel dis_tpu/ops/pallas/pyramid_kernel.py::_level_kernel
// (driven by pyramid_level_pallas, one call per level).  For each of
// `levels` consecutive levels it writes the three padded planes
// [h_s + 2p, w_s + 2p]: the level image M_s replicate-padded, and its Sobel
// dx, dy (3x3, x1/8, reflect-101) zero-padded.  The first level of a launch
// is
//   base:     the Sobel magnitude of the raw [h, w] image (quirk Q1);
//   decimate: the x0.5 box mean ((a + c) + (b + d)) * 0.25 of the finer
//             level's padded image plane (a chained launch);
// each further level is the box mean of the level before.  Every stencil
// keeps the operation order of dis_tpu_torch/ops/image.py and the build
// passes -fmad=false, so no multiply-add is contracted and the planes equal
// the plain chain of ops/pyramid.py::pyramid_level_plain bitwise.
//
// Tiles: a block owns a TL x TL tile of the launch's coarsest level and the
// footprint beneath it, 64 x 64 at the first level (TL = 64 >> (levels - 1),
// so 8 x 8 for four levels).  At level s of the launch it holds M_s on the
// tile plus a halo of e_s = 2^(L - s) (L = levels - 1) in shared memory: one
// ring for the level's own 3x3 Sobel, and what the coarser levels' halos
// decimate from.  An index outside the frame stands for its reflect-101
// image at its own level (the Sobel border of every level is reflect-101 of
// that level's index, quirk Q1 for the magnitude), and that image always
// lies inside the tile's range, so each entry is computed from the level
// before at in-frame indices.  A base launch first stages the raw image
// with the 80 + 2 halo rows and columns that the magnitude's 3x3 stencil
// needs (82 x 82 floats for four levels), by cp.async so that all of a
// thread's loads are in flight at once.  Halo entries are recomputed by the
// neighbouring tiles; each output pixel is written by exactly one block
// (edge tiles also write the pad border), so the result is deterministic
// and does not depend on the tile shape.  A tile whose staged range lies in
// the frame (most of them) takes a path without the reflect and clamp
// index arithmetic and without the pad-border test.
//
// Shared memory: the raw stage (R + 2)^2 floats and M_0 R^2, R = (TL + 2) *
// 2^L; the coarser levels reuse the raw stage.  Four levels: 13,124 floats,
// 52.5 KB (over 48 KB, so the first launch raises the kernel's dynamic
// shared-memory limit, before any capture), which lets 4 blocks of 256
// threads share an SM.  At most MAX_LEVELS = 4 levels a launch: five
// (coarsest_scale 4, DIS_FULL) would need 160 x 160 tiles, over 200 KB; the
// wrapper chains a decimate launch for levels past four.
//
// Bound on the H100: memory, in principle.  A base launch must read the raw
// image once and write every level's three padded planes once (1080p, four
// levels: 8.3 MB read, 34.4 MB written, 0.013 ms at 3.35 TB/s).  It replaces
// four launches per pyramid that re-read each finer image plane from device
// memory, ran a level-3 grid of a few dozen blocks, and made 8 global loads
// per magnitude: those took about 0.038 ms of device time per 1080p pyramid
// and 0.14 ms per 4K pyramid, this kernel about 0.037 and 0.113 (H100 80GB
// HBM3 at 700 W, chip_smoke.py --kernel-times; each launch's host work
// comes on top, four times before, once now).  It moves its bytes at about
// 35-45% of the HBM3 peak: a block runs its phases (stage, magnitudes, each
// level's stencils and stores) between barriers, and the halo costs
// (80/64)^2 = 1.56x the magnitudes of the base tile.  Smaller tiles, which
// would put more blocks on an SM, lose more to the halo than they gain;
// more threads per block, or computing the magnitudes from L1 instead of
// the stage, were slower too (a sweep on the H100).
//
// A batch of planes (the pair axis of batched flow) is one launch:
// blockIdx.z picks the plane, and every plane is computed exactly as it is
// alone.  The TPU side has no batched Pallas kernel here: its vmap rule
// routes batches through XLA.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 4;
constexpr int BASE_TILE = 64;

struct Outs {
  float* img[MAX_LEVELS];
  float* dx[MAX_LEVELS];
  float* dy[MAX_LEVELS];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// Frame index of index i at a level of n rows (or columns): its reflect-101
// image, after clamping i to lim (an entry past h + e, in a ragged last
// tile, feeds no output).  INNER: the block's ranges lie in the frame, where
// both are the identity.
template <bool INNER>
__device__ __forceinline__ int frame_index(int i, int lim, int n) {
  return INNER ? i : reflect101(min(i, lim), n);
}

// Writes level s's padded planes for the block's tile from M (the level's
// values on [b, b + R) x [bx, bx + R) of level indices, row stride R).
// INNER: the tile has no pad border to write.
template <bool INNER>
__device__ __forceinline__ void write_level(const float* M, int R, int b, int bx, int oy, int ox,
                                            int T, int h, int w, int p, float* __restrict__ img,
                                            float* __restrict__ dx, float* __restrict__ dy) {
  const int y0 = oy == 0 ? 0 : oy + p, y1 = oy + T >= h ? h + 2 * p : oy + T + p;
  const int x0 = ox == 0 ? 0 : ox + p, x1 = ox + T >= w ? w + 2 * p : ox + T + p;
  const int pw = w + 2 * p, lane = threadIdx.x & 31;
  for (int py = y0 + (threadIdx.x >> 5); py < y1; py += WARPS)
  for (int px = x0 + lane; px < x1; px += 32) {
    const int y = py - p, x = px - p;
    const size_t o = (size_t)py * pw + px;
    if (!INNER && (y < 0 || y >= h || x < 0 || x >= w)) {
      img[o] = M[(min(max(y, 0), h - 1) - b) * R + min(max(x, 0), w - 1) - bx];
      dx[o] = 0.0f;
      dy[o] = 0.0f;
      continue;
    }
    const float* m = M + (y - b) * R + (x - bx);
    const float a00 = m[-R - 1], a01 = m[-R], a02 = m[-R + 1];
    const float a10 = m[-1], a12 = m[1];
    const float a20 = m[R - 1], a21 = m[R], a22 = m[R + 1];
    img[o] = m[0];
    dx[o] = (((a02 - a00) + 2.0f * (a12 - a10)) + (a22 - a20)) * 0.125f;
    dy[o] = (((a20 - a00) + 2.0f * (a21 - a01)) + (a22 - a02)) * 0.125f;
  }
}

// The block's work: every level of its tile.  plane: the raw [h0, w0] image
// (BASE) or the finer padded image plane of row stride src_w.
template <bool BASE, bool INNER>
__device__ __forceinline__ void build(float* smem, const float* __restrict__ plane, int src_w,
                                      const Outs& outs, size_t z, int L, int h0, int w0, int p) {
  const int TL = BASE_TILE >> L;
  const int R0 = (TL + 2) << L;  // the first level's range, halo included
  float* stage = smem;           // raw stage, then levels >= 1
  float* M0 = smem + (R0 + 2) * (R0 + 2);

  // Level s's range starts at b = o - e (rows) and bx (columns): o is the
  // tile's first row at that level, e = 2^(L - s) its halo.
  const int oy0 = blockIdx.y * BASE_TILE, ox0 = blockIdx.x * BASE_TILE;
  const int e0 = 1 << L;
  const int by0 = oy0 - e0, bx0 = ox0 - e0;
  const int ylim = h0 + e0 - 1, xlim = w0 + e0 - 1;

  // Loops below: a warp per row, a lane per column (no index division;
  // row-contiguous device memory and shared memory accesses).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (BASE) {
    // Stage the raw rows with cp.async: every load of the thread is in
    // flight at once instead of one load-to-store round trip each.
    const int S = R0 + 2;
    for (int r = warp; r < S; r += WARPS) {
      const float* grow = plane + (size_t)frame_index<INNER>(by0 - 1 + r, h0, h0) * w0;
      for (int c = lane; c < S; c += 32)
        __pipeline_memcpy_async(stage + r * S + c, grow + frame_index<INNER>(bx0 - 1 + c, w0, w0),
                                sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int r = warp; r < R0; r += WARPS) {
      // Stage index of level index v is v - (b0 - 1); the neighbours are
      // staged as their own reflect-101 images.
      const int sy = frame_index<INNER>(by0 + r, ylim, h0) - by0 + 1;
      for (int c = lane; c < R0; c += 32) {
        const int sx = frame_index<INNER>(bx0 + c, xlim, w0) - bx0 + 1;
        const float* rm = stage + (sy - 1) * S + sx;
        const float* r0 = rm + S;
        const float* rp = r0 + S;
        const float gx = (((rm[1] - rm[-1]) + 2.0f * (r0[1] - r0[-1])) + (rp[1] - rp[-1])) * 0.125f;
        const float gy = (((rp[-1] - rm[-1]) + 2.0f * (rp[0] - rm[0])) + (rp[1] - rm[1])) * 0.125f;
        M0[r * R0 + c] = sqrtf(gx * gx + gy * gy);
      }
    }
  } else {
    for (int r = warp; r < R0; r += WARPS) {
      const int y = frame_index<INNER>(by0 + r, ylim, h0);
      const float* grow = plane + (size_t)(p + 2 * y) * src_w + p;
      for (int c = lane; c < R0; c += 32) {
        const float* r0 = grow + 2 * frame_index<INNER>(bx0 + c, xlim, w0);
        const float* r1 = r0 + src_w;
        M0[r * R0 + c] = ((r0[0] + r1[0]) + (r0[1] + r1[1])) * 0.25f;
      }
    }
  }
  __syncthreads();
  const size_t plane0 = (size_t)(h0 + 2 * p) * (w0 + 2 * p);
  write_level<INNER>(M0, R0, by0, bx0, oy0, ox0, BASE_TILE, h0, w0, p, outs.img[0] + z * plane0,
                     outs.dx[0] + z * plane0, outs.dy[0] + z * plane0);

  const float* fine = M0;
  int Rf = R0, byf = by0, bxf = bx0;
  float* next = stage;
  for (int s = 1; s <= L; ++s) {
    const int h = h0 >> s, w = w0 >> s, e_s = 1 << (L - s);
    const int R = (TL + 2) << (L - s);
    const int oy = oy0 >> s, ox = ox0 >> s, by = oy - e_s, bx = ox - e_s;
    const int yl = h + e_s - 1, xl = w + e_s - 1;
    float* M = next;
    for (int r = warp; r < R; r += WARPS) {
      const float* frow = fine + (2 * frame_index<INNER>(by + r, yl, h) - byf) * Rf - bxf;
      for (int c = lane; c < R; c += 32) {
        const float* r0 = frow + 2 * frame_index<INNER>(bx + c, xl, w);
        const float* r1 = r0 + Rf;
        M[r * R + c] = ((r0[0] + r1[0]) + (r0[1] + r1[1])) * 0.25f;
      }
    }
    __syncthreads();
    const size_t plane_out = (size_t)(h + 2 * p) * (w + 2 * p);
    write_level<INNER>(M, R, by, bx, oy, ox, BASE_TILE >> s, h, w, p, outs.img[s] + z * plane_out,
                       outs.dx[s] + z * plane_out, outs.dy[s] + z * plane_out);
    fine = M;
    Rf = R;
    byf = by;
    bxf = bx;
    next = M + R * R;
  }
}

// One block: the tile (blockIdx.x, blockIdx.y) of plane blockIdx.z, every
// level.  BASE: src is the raw [h0, w0] image; else the finer padded image
// plane [2 h0 + 2p, 2 w0 + 2p] (the first level decimates its interior).
// A tile whose staged range (one row and column past the first level's
// halo) lies in the frame takes the INNER path: at every level its ranges
// then lie in the frame and it writes no pad border.
template <bool BASE>
__global__ void __launch_bounds__(THREADS)
pyramid_kernel(const float* __restrict__ src, int src_h, int src_w, Outs outs, int levels,
               int h0, int w0, int p) {
  extern __shared__ float smem[];
  const int L = levels - 1, R0 = ((BASE_TILE >> L) + 2) << L, e0 = 1 << L;
  const int by0 = (int)blockIdx.y * BASE_TILE - e0, bx0 = (int)blockIdx.x * BASE_TILE - e0;
  const float* plane = src + (size_t)blockIdx.z * src_h * src_w;
  if (by0 >= 1 && bx0 >= 1 && by0 + R0 + 1 <= h0 && bx0 + R0 + 1 <= w0)
    build<BASE, true>(smem, plane, src_w, outs, blockIdx.z, L, h0, w0, p);
  else
    build<BASE, false>(smem, plane, src_w, outs, blockIdx.z, L, h0, w0, p);
}

int smem_bytes(int levels) {
  const int R0 = ((BASE_TILE >> (levels - 1)) + 2) << (levels - 1);
  return ((R0 + 2) * (R0 + 2) + R0 * R0) * (int)sizeof(float);
}

// Lets both instances take more than 48 KB of dynamic shared memory, once
// per device (before any stream capture: the first launch runs eagerly).
int allow_smem(int bytes) {
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || bytes <= allowed[dev]) return 0;
  const int need = smem_bytes(MAX_LEVELS);
  err = cudaFuncSetAttribute(pyramid_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             need);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(pyramid_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             need);
  if (err != cudaSuccess) return (int)err;
  allowed[dev] = need;
  return 0;
}

}  // namespace

// nplanes planes, each contiguous, `levels` (1..4) levels of h0 x w0 >> s.
// base != 0: src is the raw [nplanes, h0, w0] image.  base == 0: src is the
// finer level's padded image plane [nplanes, 2 h0 + 2p, 2 w0 + 2p].  outs is
// a host array of 3 * levels device pointers, (img, dx, dy) for each level,
// each [nplanes, (h0 >> s) + 2p, (w0 >> s) + 2p].  h0 and w0 must be
// divisible by 2^(levels - 1) with the coarsest level at least 1 x 1;
// nplanes <= 65535.  Returns cudaGetLastError() after the launch.
extern "C" int dis_pyramid(const float* src, int src_h, int src_w, float* const* outs,
                           int nplanes, int levels, int h0, int w0, int p, int base,
                           cudaStream_t stream) {
  if (levels < 1 || levels > MAX_LEVELS || nplanes < 1 || nplanes > 65535 || p < 0)
    return (int)cudaErrorInvalidValue;
  const int L = levels - 1;
  if ((h0 >> L) << L != h0 || (w0 >> L) << L != w0 || (h0 >> L) < 1 || (w0 >> L) < 1)
    return (int)cudaErrorInvalidValue;
  Outs o{};
  for (int s = 0; s < levels; ++s) {
    o.img[s] = outs[3 * s];
    o.dx[s] = outs[3 * s + 1];
    o.dy[s] = outs[3 * s + 2];
  }
  const int bytes = smem_bytes(levels);
  const int err = allow_smem(bytes);
  if (err != 0) return err;
  const int TL = BASE_TILE >> L;
  const dim3 grid(((w0 >> L) + TL - 1) / TL, ((h0 >> L) + TL - 1) / TL, nplanes);
  if (base)
    pyramid_kernel<true><<<grid, THREADS, bytes, stream>>>(src, src_h, src_w, o, levels, h0, w0, p);
  else
    pyramid_kernel<false><<<grid, THREADS, bytes, stream>>>(src, src_h, src_w, o, levels, h0, w0, p);
  return (int)cudaGetLastError();
}

extern "C" const char* dis_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
