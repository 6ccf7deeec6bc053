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
// F2: a block of four warps owns a tile of 16 rows x 128 columns of level
// 1 of one image plane (blockIdx.z: image * nb + plane), the 2x2 box mean
// ((a + c) + (b + d)) * 0.25 of resize_half (rows first).  Each thread
// loads float4s of two input rows (a warp load is 512 contiguous bytes),
// all sixteen of them before any arithmetic, and computes four level-1
// pixels of each of four rows, stored as float2 pairs; its level-2 pixels
// are box means of its own level-1 pixels, and level 3 takes each column
// pair across two lanes by a shuffle, so levels 1-3 (all of DIS_MEDIUM's)
// run in registers, with no shared memory and no barrier, every level's
// rows stored by whole warps.  Levels 4 and 5 reduce the tile's level 3 in
// shared memory; the wrapper chains a launch for levels past five.  The
// padded frame's dims divide by 2^coarsest, so each 2^s x 2^s block of the
// input reduces alone and a tile's edge never cuts one.  Out: level s as
// [2, nb, h >> s, w >> s].  A row width that is not a multiple of 4 floats
// (or an unaligned plane) takes the same code with scalar loads and stores.
//
// F3: the cropped flow (out [nb, H, W, 2]), the scaled flow sampled
// bilinearly at (y + top, x + left) of the padded frame as
// ops/image.py::resize_bilinear samples it: the source coordinate ((X +
// 0.5) * s) - 0.5 in float32 with s = in / out = 2^-finest (exact), the
// weights' floor and clamp, each tap the flow value times 2^finest, then
// top * (1 - ay) + bot * ay of the rows' top = r0 * (1 - ax) + r1 * ax.
// The 2^finest columns of a run share their four taps, so a thread loads
// them once, as float2s (u and v are adjacent), and writes the run's
// outputs as float4 pairs; a warp takes one output row (its source rows
// and row weight), a lane four runs 32 apart, a block eight rows.  Only
// the cropped pixels are computed.
//
// Bound on the H100: memory; each moves its bytes once and does a few
// operations a byte (F1 none, F2 four a level pixel, F3 about 15 an output
// value).  Coalesced rows and vector accesses are the whole design.
// Measured (H100 80GB HBM3 at 700 W, chip_smoke.py phase 1g): F1 0.033 ms
// on a KITTI batch of 8 (55% of its 0.018 ms bound; one F.pad of both
// images 0.037; a thread a pixel over a 1-D grid, with 64-bit divisions,
// took 0.043).  F2 and F3 are redesigned: PERF.md section 6 holds their
// times beside the earlier designs' (F2 a 16 x 16 level-1 tile of scalar
// loads, 0.017 ms at 1080p, 40% of 0.0066; F3 a block per output row of
// scalar taps, 0.023 ms on the KITTI batch, 49% of 0.011).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int LEVEL_WARPS = 4;                   // F2: warps a block
constexpr int LEVEL_THREADS = 32 * LEVEL_WARPS;
constexpr int L1_ROWS = 4 * LEVEL_WARPS;         // F2: a level-1 tile of 16 rows
constexpr int L1_COLS = 128;                     //     x 128 columns
constexpr int MAX_LEVELS = 5;                    // F2: the tile's rows down to 1
constexpr int FINISH_ROWS = THREADS / 32;        // F3: output rows a block, a warp each
constexpr int FINISH_RUNS = 4;                   // F3: runs of columns a thread

// Blocks along a row of w pixels (F1: blockIdx.y is the row).
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

// Level-1 pixels (2x2 box means) k = 2 * half + {0, 1} of a thread's row
// from the input row pair (t, b): ((a + c) + (b + d)) * 0.25, rows first.
__device__ __forceinline__ void box_pair(const float4& t, const float4& b, float* v) {
  v[0] = ((t.x + b.x) + (t.y + b.y)) * 0.25f;
  v[1] = ((t.z + b.z) + (t.w + b.w)) * 0.25f;
}

// The input floats [c, c + 4) of a row, zeros past its end w0.  VEC: the
// row and c are 16-byte aligned and c < w0 means c + 3 < w0.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int w0) {
  if (VEC) return c < w0 ? *reinterpret_cast<const float4*>(row + c) : make_float4(0, 0, 0, 0);
  float4 v;
  v.x = c < w0 ? row[c] : 0.0f;
  v.y = c + 1 < w0 ? row[c + 1] : 0.0f;
  v.z = c + 2 < w0 ? row[c + 2] : 0.0f;
  v.w = c + 3 < w0 ? row[c + 3] : 0.0f;
  return v;
}

// A block of LEVEL_WARPS warps owns a tile of L1_ROWS x L1_COLS level-1
// pixels of one image plane (blockIdx.z: image * nb + plane); warp wy the
// level-1 rows 4 wy .. 4 wy + 3 of the tile, lane l the columns 2l, 2l + 1
// and 64 + 2l, 64 + 2l + 1 (input float4s at 4l and 128 + 4l: each warp
// load reads 512 contiguous bytes).  Levels 1-3 stay in registers: a
// thread's level-2 pixels (rows 2 wy, 2 wy + 1, columns l and 32 + l) are
// the box means of its own level-1 pixels, and level 3 (row wy) takes the
// column pair across lanes l and l ^ 1 by a shuffle, even lanes columns
// 0-15, odd lanes 16-31, so every store of levels 2 and 3 is a whole warp's
// 128 contiguous bytes.  Levels 4 and 5 (DIS_FULL, a deeper chain) reduce
// level 3 in shared memory.  Tiles past the level's edge compute values
// that no in-level pixel reads (the frame divides by 2^levels), and store
// none of them.
template <bool VEC>
__global__ void __launch_bounds__(LEVEL_THREADS)
levels_kernel(const float* __restrict__ src1, const float* __restrict__ src2, int nb, int h0,
              int w0, int levels, Levels outs) {
  __shared__ float t3[LEVEL_WARPS][32];
  __shared__ float t4[LEVEL_WARPS / 2][16];
  const int64_t z = blockIdx.z;   // image * nb + plane: the plane of out
  const int img = (int)z >= nb;
  const float* src = (img ? src2 : src1) + (z - (img ? nb : 0)) * h0 * w0;
  const int wy = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int h1 = h0 >> 1, w1 = w0 >> 1;
  const int y1 = blockIdx.y * L1_ROWS + 4 * wy;   // the warp's first level-1 row
  const int xin = blockIdx.x * 2 * L1_COLS;        // the tile's first input column

  // Every load of the thread first, then the box means.
  float4 ld[4][2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = y1 + i < h1;
    const float* r0 = src + (int64_t)(2 * (y1 + i)) * w0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = xin + half * 2 * 64 + 4 * l;
      ld[i][0][half] = in ? load4<VEC>(r0, c, w0) : make_float4(0, 0, 0, 0);
      ld[i][1][half] = in ? load4<VEC>(r0 + w0, c, w0) : make_float4(0, 0, 0, 0);
    }
  }
  float v1[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    box_pair(ld[i][0][0], ld[i][1][0], v1[i]);
    box_pair(ld[i][0][1], ld[i][1][1], v1[i] + 2);
    const int y = y1 + i;
    if (y >= h1) continue;
    float* row = outs.out[0] + (z * h1 + y) * w1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = blockIdx.x * L1_COLS + half * 64 + 2 * l;
      if (VEC) {   // w1 is even: the pair is in the level or out of it
        if (x < w1) *reinterpret_cast<float2*>(row + x) = make_float2(v1[i][2 * half], v1[i][2 * half + 1]);
      } else {
        if (x < w1) row[x] = v1[i][2 * half];
        if (x + 1 < w1) row[x + 1] = v1[i][2 * half + 1];
      }
    }
  }
  if (levels < 2) return;

  // Level 2: rows 2 wy + j, columns l and 32 + l of the tile.
  const int h2 = h1 >> 1, w2 = w1 >> 1;
  float v2[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      v2[j][half] = ((v1[2 * j][2 * half] + v1[2 * j + 1][2 * half]) +
                     (v1[2 * j][2 * half + 1] + v1[2 * j + 1][2 * half + 1])) * 0.25f;
    const int y = blockIdx.y * (L1_ROWS / 2) + 2 * wy + j;
    if (y >= h2) continue;
    float* row = outs.out[1] + (z * h2 + y) * w2;
    const int x = blockIdx.x * (L1_COLS / 2) + l;
    if (x < w2) row[x] = v2[j][0];
    if (x + 32 < w2) row[x + 32] = v2[j][1];
  }
  if (levels < 3) return;

  // Level 3: row wy; the column pair (2c, 2c + 1) of level 2 lies in lanes
  // 2c and 2c + 1 (c < 16: the first half) or 2c - 32 and 2c - 31.
  const int h3 = h2 >> 1, w3 = w2 >> 1;
  const float s0 = v2[0][0] + v2[1][0], s1 = v2[0][1] + v2[1][1];
  const float o0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float o1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  const bool odd = l & 1;
  const float v3 = (odd ? o1 + s1 : s0 + o0) * 0.25f;
  const int c3 = odd ? 16 + (l >> 1) : l >> 1;
  {
    const int y = blockIdx.y * (L1_ROWS / 4) + wy, x = blockIdx.x * (L1_COLS / 4) + c3;
    if (y < h3 && x < w3) outs.out[2][(z * h3 + y) * w3 + x] = v3;
  }
  if (levels < 4) return;

  // Levels 4 and 5 in shared memory: the tile's level 3 is LEVEL_WARPS x 32.
  t3[wy][c3] = v3;
  __syncthreads();
  const int h4 = h3 >> 1, w4 = w3 >> 1;
  const int t = threadIdx.x;
  if (t < (LEVEL_WARPS / 2) * 16) {
    const int r = t >> 4, c = t & 15;
    const float v = ((t3[2 * r][2 * c] + t3[2 * r + 1][2 * c]) +
                     (t3[2 * r][2 * c + 1] + t3[2 * r + 1][2 * c + 1])) * 0.25f;
    t4[r][c] = v;
    const int y = blockIdx.y * (L1_ROWS / 8) + r, x = blockIdx.x * (L1_COLS / 8) + c;
    if (y < h4 && x < w4) outs.out[3][(z * h4 + y) * w4 + x] = v;
  }
  if (levels < 5) return;
  __syncthreads();
  const int h5 = h4 >> 1, w5 = w4 >> 1;
  if (t < (LEVEL_WARPS / 4) * 8) {
    const int r = t >> 3, c = t & 7;
    const float v = ((t4[2 * r][2 * c] + t4[2 * r + 1][2 * c]) +
                     (t4[2 * r][2 * c + 1] + t4[2 * r + 1][2 * c + 1])) * 0.25f;
    const int y = blockIdx.y * (L1_ROWS / 16) + r, x = blockIdx.x * (L1_COLS / 16) + c;
    if (y < h5 && x < w5) outs.out[4][(z * h5 + y) * w5 + x] = v;
  }
}

// ---------------------------------------------------------------------------
// F3: flow [nb, fh, fw, 2] at the finest scale of a padded frame; out
// [nb, H, W, 2], the crop at (top, left) of the upsampled frame.
//
// The frame's column X samples at xs = (X + 0.5) / f - 0.5 (f = 2^finest),
// so the run of f columns X in [f j - f / 2, f j + f / 2) shares its taps
// x0 = j - 1 and x1 = j (clamped to the flow); only ax differs.  A block
// of FINISH_ROWS warps covers FINISH_ROWS output rows, a warp one row (its
// source rows and row weight), each lane FINISH_RUNS runs 32 apart: the
// four float2 taps (u and v side by side) of a run, then its f outputs,
// stored as float4 pairs where a pair is 16-byte aligned, else as float2.
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ flow, int fh, int fw, int H, int W, int top, int left,
              int f, float scale, float step, int j0, int runs, bool pairs,
              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.y * FINISH_ROWS + (threadIdx.x >> 5);
  if (y >= H) return;
  const int64_t b = blockIdx.z;
  const float ys = ((float)(y + top) + 0.5f) * step - 0.5f;
  const float y0f = floorf(ys);
  const int y0 = (int)y0f;
  const float ay = y0 < 0 ? 0.0f : ys - y0f;
  const float by = 1.0f - ay;
  const int y0c = min(max(y0, 0), fh - 1), y1c = min(max(y0 + 1, 0), fh - 1);
  const float2* row0 = reinterpret_cast<const float2*>(flow) + (b * fh + y0c) * fw;
  const float2* row1 = reinterpret_cast<const float2*>(flow) + (b * fh + y1c) * fw;
  float* dst = out + ((b * H + y) * W) * 2;
  const int first = blockIdx.x * (32 * FINISH_RUNS) + lane;

  float2 tap[FINISH_RUNS][4];
#pragma unroll
  for (int i = 0; i < FINISH_RUNS; ++i) {
    const int j = j0 + first + 32 * i;
    const int x0c = min(max(j - 1, 0), fw - 1), x1c = min(max(j, 0), fw - 1);
    if (first + 32 * i < runs) {
      tap[i][0] = row0[x0c];
      tap[i][1] = row0[x1c];
      tap[i][2] = row1[x0c];
      tap[i][3] = row1[x1c];
    }
  }
#pragma unroll
  for (int i = 0; i < FINISH_RUNS; ++i) {
    if (first + 32 * i >= runs) break;
    const int j = j0 + first + 32 * i;
    const float2 a0 = tap[i][0], a1 = tap[i][1], c0 = tap[i][2], c1 = tap[i][3];
    // Output column X of the run: resize_bilinear's top * (1 - ay) + bot *
    // ay of top = r0 * (1 - ax) + r1 * ax, each tap times the scale.
    auto value = [&](int X) {
      const float xs = ((float)X + 0.5f) * step - 0.5f;
      const float x0f = floorf(xs);
      const float ax = (int)x0f < 0 ? 0.0f : xs - x0f;
      const float bx = 1.0f - ax;
      const float tu = (a0.x * scale) * bx + (a1.x * scale) * ax;
      const float bu = (c0.x * scale) * bx + (c1.x * scale) * ax;
      const float tv = (a0.y * scale) * bx + (a1.y * scale) * ax;
      const float bv = (c0.y * scale) * bx + (c1.y * scale) * ax;
      return make_float2(tu * by + bu * ay, tv * by + bv * ay);
    };
    // The run's columns in pairs (x, x + 1), x = X - left.
    for (int m = 0; m < f; m += 2) {
      const int x = f * j - (f >> 1) + m - left;
      if (x + 1 < 0 || x >= W) continue;
      const float2 p = value(x + left), q = value(x + 1 + left);
      if (pairs && x >= 0 && x + 1 < W && !(x & 1)) {
        *reinterpret_cast<float4*>(dst + 2 * x) = make_float4(p.x, p.y, q.x, q.y);
      } else {
        if (x >= 0) *reinterpret_cast<float2*>(dst + 2 * x) = p;
        if (x + 1 < W) *reinterpret_cast<float2*>(dst + 2 * x + 2) = q;
      }
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
  const dim3 grid((w1 + L1_COLS - 1) / L1_COLS, (h1 + L1_ROWS - 1) / L1_ROWS, 2 * nb);
  auto aligned = [](const void* p, int bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
  };
  if (w % 4 == 0 && aligned(src1, 16) && aligned(src2, 16) && aligned(outs[0], 8))
    levels_kernel<true><<<grid, LEVEL_THREADS, 0, stream>>>(src1, src2, nb, h, w, levels, o);
  else
    levels_kernel<false><<<grid, LEVEL_THREADS, 0, stream>>>(src1, src2, nb, h, w, levels, o);
  return (int)cudaGetLastError();
}

// flow [nb, fh, fw, 2]; out [nb, H, W, 2]: the flow times scale = 2^finest
// >= 2, sampled at ((X + 0.5) * step - 0.5, (Y + 0.5) * step - 0.5) of the
// frame for X = x + left, Y = y + top, step = 1 / scale.
extern "C" int dis_frame_finish(const float* flow, int nb, int fh, int fw, int H, int W,
                                int top, int left, float scale, float step, float* out,
                                cudaStream_t stream) {
  const int f = (int)scale;
  if (nb < 1 || nb > 65535 || fh < 1 || fw < 1 || H < 1 || W < 1 || H > 65535 || top < 0 ||
      left < 0 || f < 2 || (f & (f - 1)) || (float)f != scale || step * scale != 1.0f)
    return (int)cudaErrorInvalidValue;
  // Runs j0 .. j0 + runs - 1 cover the crop's columns [left, left + W).
  const int j0 = (left + f / 2) / f;
  const int runs = (left + W - 1 + f / 2) / f - j0 + 1;
  const dim3 grid((runs + 32 * FINISH_RUNS - 1) / (32 * FINISH_RUNS),
                  (H + FINISH_ROWS - 1) / FINISH_ROWS, nb);
  const bool pairs = W % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  finish_kernel<<<grid, THREADS, 0, stream>>>(flow, fh, fw, H, W, top, left, f, scale, step, j0,
                                              runs, pairs, out);
  return (int)cudaGetLastError();
}
