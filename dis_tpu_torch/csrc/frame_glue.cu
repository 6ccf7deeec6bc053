// F1-F3: the frame's device glue around the pipeline, one launch each.
//
// No Pallas kernel backs these: on the TPU they are jnp code that XLA
// fuses.  They replace
//   F1 dis_frame_pad         the divisibility padding of both images,
//                            dis_tpu/ops/image.py:146 pad_divisible (and
//                            dis_tpu/models/dis.py:466-467);
//   F2 dis_intensity_levels  the raw-intensity chain of the refinement's
//                            planes, levels 1..coarsest of both images,
//                            dis_tpu/ops/pyramid.py:162 intensity_pyramid;
//   F3 dis_frame_finish      the finest-scale flow's scaling, bilinear
//                            upsample and crop, dis_tpu/models/dis.py:468-472.
// Their plain versions are frame_pad_plain and frame_finish_plain in
// dis_tpu_torch/ops/image.py and intensity_levels_plain in
// dis_tpu_torch/ops/pyramid.py.  Each keeps the plain version's float32
// operations in their order (the build passes -fmad=false), so each equals
// it bitwise; F1 only copies.
//
// F1: one thread per output pixel of both padded images (out [2, nb, H,
// W]), each the input pixel at the clamped source index (replicate), a
// block per output row.  The inputs may be strided (a view): their
// strides come in elements.
//
// F2: a block of 16 x 16 threads owns a 16 x 16 tile of level 1 of one
// image plane (blockIdx.z: image * nb + plane), each thread one pixel: the
// 2x2 box mean ((a + c) + (b + d)) * 0.25 of resize_half (rows first), from
// the level below in device memory.  The coarser levels of the tile are
// built in shared memory, level s by the threads of the top-left (16 >>
// (s - 1))^2 corner, up to 5 levels a launch (16 x 16 down to 1 x 1); the
// wrapper chains a launch for levels past five.  The padded frame's dims
// divide by 2^coarsest, so each 2^s x 2^s block of the input reduces alone
// and a tile's edge never cuts one.  Out: level s as [2, nb, h >> s, w >> s].
//
// F3: one thread per output pixel of the cropped flow (out [nb, H, W, 2];
// a block per output row, whose source rows and row weight it shares),
// the scaled flow sampled bilinearly at (y + top, x + left) of the padded
// frame as ops/image.py::resize_bilinear samples it: the source coordinate
// ((X + 0.5) * s) - 0.5 in float32 with s = in / out = 2^-finest (exact),
// the weights' floor and clamp, each tap the flow value times 2^finest,
// then top * (1 - ay) + bot * ay of the rows' top = r0 * (1 - ax) + r1 *
// ax.  Only the cropped pixels are computed.
//
// Bound on the H100: memory; each moves its bytes once and does a few
// operations a byte (F1 none, F2 four a level pixel, F3 about 15 an output
// value).  The coalesced rows are the whole design: consecutive threads on
// consecutive columns (F3's taps read from L1, F2's 2x2 reads two adjacent
// floats of two rows).  Measured (H100 80GB HBM3 at 700 W, chip_smoke.py
// phase 1g): F1 0.033 ms on a KITTI batch of 8 (55% of its 0.018 ms
// bound; one F.pad of both images 0.037; a thread a pixel over a 1-D
// grid, with 64-bit divisions, took 0.043), F2 0.017 ms at 1080p (40% of
// 0.0066), F3 0.023 ms on the KITTI batch (49% of 0.011; F.interpolate of
// the uncropped frame 0.039).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int LEVEL_TILE = 16;         // F2: level-1 tile side
constexpr int MAX_LEVELS = 5;          // F2: 16 x 16 down to 1 x 1

// Blocks along a row of w pixels (F1, F3: blockIdx.y is the row).
int row_blocks(int w) { return (w + THREADS - 1) / THREADS; }

// ---------------------------------------------------------------------------
// F1
struct Strides {
  int64_t b, y, x;
};

// A block per output row (blockIdx.y) of a plane (blockIdx.z: image * nb +
// plane), its threads along the row: the source row is the block's.
__global__ void __launch_bounds__(THREADS)
pad_kernel(const float* __restrict__ a, const float* __restrict__ b, Strides sa, Strides sb,
           int nb, int h, int w, int H, int W, int top, int left, float* __restrict__ out) {
  const int z = blockIdx.z, img = z >= nb, pb = z - (img ? nb : 0);
  const int y = min(max((int)blockIdx.y - top, 0), h - 1);
  const float* src = img ? b + pb * sb.b + y * sb.y : a + pb * sa.b + y * sa.y;
  const int64_t sx = img ? sb.x : sa.x;
  float* dst = out + ((int64_t)z * H + blockIdx.y) * W;
  for (int X = blockIdx.x * THREADS + threadIdx.x; X < W; X += gridDim.x * THREADS)
    dst[X] = src[min(max(X - left, 0), w - 1) * sx];
}

// ---------------------------------------------------------------------------
// F2
struct Levels {
  float* out[MAX_LEVELS];
};

__global__ void __launch_bounds__(LEVEL_TILE * LEVEL_TILE)
levels_kernel(const float* __restrict__ src1, const float* __restrict__ src2, int nb, int h0,
              int w0, int levels, Levels outs) {
  __shared__ float tile[LEVEL_TILE][LEVEL_TILE + 1];
  const int img = blockIdx.z / nb;
  const int64_t z = blockIdx.z;   // image * nb + plane: the plane of out
  const int ty = threadIdx.x / LEVEL_TILE, tx = threadIdx.x % LEVEL_TILE;
  int h = h0 >> 1, w = w0 >> 1;
  int y = blockIdx.y * LEVEL_TILE + ty, x = blockIdx.x * LEVEL_TILE + tx;
  float v = 0.0f;
  if (y < h && x < w) {
    const float* r0 = (img ? src2 : src1) + (z % nb) * h0 * w0 + (int64_t)(2 * y) * w0 + 2 * x;
    const float* r1 = r0 + w0;
    v = ((r0[0] + r1[0]) + (r0[1] + r1[1])) * 0.25f;
    outs.out[0][(z * h + y) * w + x] = v;
  }
  tile[ty][tx] = v;   // outside the level: feeds only pixels outside the coarser ones
  for (int s = 1, t = LEVEL_TILE / 2; s < levels; ++s, t >>= 1) {
    __syncthreads();
    h >>= 1;
    w >>= 1;
    const bool mine = ty < t && tx < t;
    if (mine)
      v = ((tile[2 * ty][2 * tx] + tile[2 * ty + 1][2 * tx]) +
           (tile[2 * ty][2 * tx + 1] + tile[2 * ty + 1][2 * tx + 1])) * 0.25f;
    __syncthreads();
    if (mine) {
      tile[ty][tx] = v;
      y = blockIdx.y * t + ty;
      x = blockIdx.x * t + tx;
      if (y < h && x < w) outs.out[s][(z * h + y) * w + x] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// F3: flow [nb, fh, fw, 2] at the finest scale of a padded frame; out
// [nb, H, W, 2], the crop at (top, left) of the upsampled frame.
// A block per output row (blockIdx.y) of a flow (blockIdx.z), its threads
// along the row: the two source rows and their weight are the block's.
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ flow, int fh, int fw, int H, int W, int top, int left,
              float scale, float step, float* __restrict__ out) {
  const int64_t b = blockIdx.z;
  const float ys = ((float)((int)blockIdx.y + top) + 0.5f) * step - 0.5f;
  const float y0f = floorf(ys);
  const int y0 = (int)y0f;
  const float ay = y0 < 0 ? 0.0f : ys - y0f;
  const float by = 1.0f - ay;
  const int y0c = min(max(y0, 0), fh - 1), y1c = min(max(y0 + 1, 0), fh - 1);
  const float* row0 = flow + ((b * fh + y0c) * fw) * 2;
  const float* row1 = flow + ((b * fh + y1c) * fw) * 2;
  float* dst = out + ((b * H + blockIdx.y) * W) * 2;
  for (int x = blockIdx.x * THREADS + threadIdx.x; x < W; x += gridDim.x * THREADS) {
    const float xs = ((float)(x + left) + 0.5f) * step - 0.5f;
    const float x0f = floorf(xs);
    const int x0 = (int)x0f;
    const float ax = x0 < 0 ? 0.0f : xs - x0f;
    const float bx = 1.0f - ax;
    const int x0c = min(max(x0, 0), fw - 1), x1c = min(max(x0 + 1, 0), fw - 1);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float t = (row0[2 * x0c + c] * scale) * bx + (row0[2 * x1c + c] * scale) * ax;
      const float u = (row1[2 * x0c + c] * scale) * bx + (row1[2 * x1c + c] * scale) * ax;
      dst[2 * x + c] = t * by + u * ay;
    }
  }
}

}  // namespace

// img1, img2 [nb, h, w] of strides s1 and s2 (elements: plane, row,
// column); out [2, nb, H, W], each image replicate-padded by top rows
// above and left columns before it.
extern "C" int dis_frame_pad(const float* img1, const float* img2, const int64_t* s1,
                             const int64_t* s2, int nb, int h, int w, int H, int W, int top,
                             int left, float* out, cudaStream_t stream) {
  if (nb < 1 || 2 * nb > 65535 || h < 1 || w < 1 || H < h || W < w || H > 65535 ||
      top < 0 || left < 0 || top > H - h || left > W - w)
    return (int)cudaErrorInvalidValue;
  const Strides sa = {s1[0], s1[1], s1[2]}, sb = {s2[0], s2[1], s2[2]};
  const dim3 grid(row_blocks(W), H, 2 * nb);
  pad_kernel<<<grid, THREADS, 0, stream>>>(img1, img2, sa, sb, nb, h, w, H, W, top, left, out);
  return (int)cudaGetLastError();
}

// src1, src2 [nb, h, w] (h, w divisible by 2^levels); outs[s - 1] the level
// s [2, nb, h >> s, w >> s], s = 1..levels, levels <= 5.
extern "C" int dis_intensity_levels(const float* src1, const float* src2, int nb, int h, int w,
                                    int levels, float* const* outs, cudaStream_t stream) {
  if (nb < 1 || 2 * nb > 65535 || levels < 1 || levels > MAX_LEVELS ||
      h % (1 << levels) || w % (1 << levels) || h < 2 || w < 2)
    return (int)cudaErrorInvalidValue;
  Levels o = {};
  for (int s = 0; s < levels; ++s) o.out[s] = outs[s];
  const int h1 = h / 2, w1 = w / 2;
  const dim3 grid((w1 + LEVEL_TILE - 1) / LEVEL_TILE, (h1 + LEVEL_TILE - 1) / LEVEL_TILE,
                  2 * nb);
  levels_kernel<<<grid, LEVEL_TILE * LEVEL_TILE, 0, stream>>>(src1, src2, nb, h, w, levels, o);
  return (int)cudaGetLastError();
}

// flow [nb, fh, fw, 2]; out [nb, H, W, 2]: the flow times scale, sampled
// at ((X + 0.5) * step - 0.5, (Y + 0.5) * step - 0.5) of the frame for X =
// x + left, Y = y + top.
extern "C" int dis_frame_finish(const float* flow, int nb, int fh, int fw, int H, int W,
                                int top, int left, float scale, float step, float* out,
                                cudaStream_t stream) {
  if (nb < 1 || nb > 65535 || fh < 1 || fw < 1 || H < 1 || W < 1 || H > 65535 || top < 0 ||
      left < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(row_blocks(W), H, nb);
  finish_kernel<<<grid, THREADS, 0, stream>>>(flow, fh, fw, H, W, top, left, scale, step, out);
  return (int)cudaGetLastError();
}
