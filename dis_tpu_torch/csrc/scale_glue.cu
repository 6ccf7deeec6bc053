// S1, S3, S4: each scale's device work around the search, one launch each
// per scale.
//
// No Pallas kernel backs these: on the TPU this work is jnp code that XLA
// fuses into a few loops per scale.  They replace those fusions:
//   S1 dis_scale_templates  the templates, their Hessians' inverses, fixed
//                           mode's mean-normalized template
//                           (dis_tpu/ops/iclk.py:155 extract_templates_grid,
//                           :346 _templates_from_taps, :355
//                           _templates_from_hessian, :635-637 Tn) and the
//                           search start: the x2 nearest-neighbour init from
//                           the coarser flow and the start test
//                           (dis_tpu/ops/grid.py:52 init_from_coarser_flow,
//                           dis_tpu/ops/iclk.py:639-646), once a kernel of its
//                           own (S2, now fused into S1);
//   S3 dis_fixed_weights    fixed mode's densification weights
//                           (dis_tpu/models/dis.py:27 _fixed_weights);
//   S4 dis_densify          densification (dis_tpu/ops/densify.py:58-108).
// Their plain versions are templates_plain and search_start_plain (S1's
// start) in dis_tpu_torch/ops/iclk.py, fixed_weights_plain and
// densify_plain in dis_tpu_torch/ops/densify.py.  Each kernel keeps the
// plain version's operations, one float32 rounding per operation and in its
// order (the build passes -fmad=false, so a product is rounded before it is
// summed); a sum over a patch's taps is dis_group_sum's pair tree
// (dis_common.cuh), which is pairwise_sum's; 1 / x is the correctly rounded
// reciprocal (__frcp_rn: Tensor.__rtruediv__ is reciprocal then * 1.0) and a
// tensor division __fdiv_rn.  So each kernel equals its plain version
// bitwise.
//
// Bound on the H100: memory.  At the 1080p finest scale (82,944 patches of
// ps 8 on level planes of 1104 x 1936): S1 reads the three planes (25.6 MB)
// and writes three templates of 64 taps a patch and the inverses (65 MB),
// and for the start reads the picks, the picked flow values and the centers
// and writes init_u, pos0 and conv0 (2.7 MB more); S3 reads Q and T
// (42.5 MB); S4 writes the 1080p flow (16.6 MB) and reads the uniform weight
// plane (8.3 MB).  The arithmetic is a few operations per byte at most, far
// under the card's 67 TFLOP/s.  The start alone moved too few bytes to pay
// for a launch of its own (0.0031 ms against a bound of 0.0008 ms), so it
// rides on S1, which already visits every patch in the same x-outer order.
//
// S1 (templates_kernel).  A block a tile of the patch grid, `rows`
// consecutive patch rows in `cols` consecutive patch columns of one pair
// (8 x 8 where it fits; ops/cuda/scale_kernel.py::template_tiles): it
// copies the tile's window of the level, dx and dy planes, (rows - 1) *
// steps + ps rows by (cols - 1) * steps + ps columns, into shared memory
// with cp.async (neighbouring threads on neighbouring addresses, 4 bytes
// each: a plane row need not be 16-byte aligned), and its lanes read their
// taps from there.  The row pitch is padded so that a warp's reads spread
// over the banks (an odd pitch at ps 8: the up to 23 rows of a warp's four
// patches fall in distinct banks).  The lanes keep K1's layout
// (dis_iclk_layout in iclk.cu: a group of G lanes a patch, K consecutive
// taps a lane, G K the power of two >= ps^2, taps past ps^2 zero), so a
// group's pair-tree sums are dis_group_sum's; a warp's 32 / G patches are
// consecutive patch rows of one column, so they are consecutive in the
// outputs (patches x-outer: patch = ix * num_h + iy; taps row-major, tap =
// j * ps + i at plane row y0 + iy * steps + j, column x0 + ix * steps + i;
// a stripe's row0 is already in y0), and the two lanes of a pair swap a
// chunk so that each 16-byte store instruction writes whole 32-byte
// sectors.  Lane 0 of a group writes the patch's inverse.  Where the
// launch asks for the start (two flags, never a null pointer, say whether
// to write the start and whether a coarser flow exists), a thread a patch
// of the tile (at most THREADS patches a tile) writes its init_u, pos0 and
// conv0: it loads the picks before the window's copies are issued, the
// flow value they pick right after, and stores the start after the
// block's templates, so that the start's dependent loads overlap the
// block's work instead of lengthening it.  What bounds it: the stores, 66
// of the 93 MB at 1080p.
//
// S4 (densify_kernel).  A block a tile of 32 output rows by 128 output
// columns of one pair.  It stages the tile's slices of cover_rows and
// cover_cols as 32-bit indices in shared memory, reduces the range of grid
// rows and columns they reach, loads that sub-block of u (times the
// weights, and the weights, where weighted) once (a grid column's rows are
// contiguous: u is x-outer), then sums each (output row, grid column)
// pair's covering grid rows once (the row pass) and each pixel's covering
// columns of those sums (the column pass), a term a vector ({u0, u1}, or
// {u0 w, u1 w, w} where weighted), the zero row and column (index num_h,
// num_w) added as the zeros they are, each loop unrolled for kr = kc = 3
// and 5.  The uniform weight plane's values are copied in first
// (cp.async), so that they arrive while the covers are reduced.  A range
// larger than the staged sub-block (cover tables that no plan makes) is
// summed straight from device memory in the same order.  At most 64
// registers a thread: four blocks an SM, so the 1080p finest scale's 510
// tiles run in one wave.  What bounds it: at 3 x 3 uniform covers the
// flow's stores and the weight plane's loads; at DIS_FULL's 5 x 5
// weighted covers the terms each pixel sums (below).
//
// S3 (weights_kernel) reads its patches [nb, n, ps^2] in K1's lane layout.
//
// Measured (H100 80GB HBM3, 700.00 W; chip_smoke.py phase 1f) at the 1080p
// compat finest scale before the start was fused into S1: S1 0.0374 ms (72%
// of its 0.0270 ms bound), S2 0.0031, S3 0.0141 (DIS_FAST; 91%), S4 0.0106
// (72% of 0.0076); S4 0.0163 ms (36% of 0.0059) at the DIS_FULL finest
// scale.  Phase 1f's sweep of cover widths on that grid, whose bytes barely
// change with them, takes 0.0109, 0.0161 and 0.0165 ms weighted at 3 x 3,
// 4 x 4 (the generic instance) and 5 x 5 covers, and 0.0113, 0.0158 and
// 0.0140 uniform: the terms a pixel sums ({u0 w, u1 w, w} vectors where
// weighted), not its bytes, set S4's pace there.  With the start fused
// (H100 80GB HBM3, 700.00 W; chip_smoke.py --kernel-times, both trees timed
// in turns on one card): S1 0.0389 ms against 0.0416 for S1 then S2 (1080p
// compat finest), 0.0054 against 0.0063 (coarsest) and 0.0663 against
// 0.0682 (KITTI B = 8 finest); the start adds about 0.002 ms to S1's 0.0367.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "dis_common.cuh"

extern "C" int dis_iclk_layout(int ps, int* k, int* g);

namespace {

constexpr int THREADS = 256;

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool aligned8(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

unsigned blocks_for(long long threads) { return (unsigned)((threads + THREADS - 1) / THREADS); }

// The lane's patch of a K, G layout: slot (pair * n + patch, possibly past
// the last patch, where the lane computes on patch 0 and stores nothing,
// so that every lane joins the group sums) and its lane in the group.
template <int G>
struct Lane {
  long long slot;
  int g;
  __device__ __forceinline__ Lane() {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    slot = (t >> 5) * (32 / G) + (threadIdx.x & 31) / G;
    g = (threadIdx.x & 31) % G;
  }
};

// The lane's K taps [t0, t0 + K) of a row of np taps; taps past np read as
// zero.  vec: the row is 16-byte aligned (np is a multiple of 4 for every
// even ps, so a 4-tap chunk is wholly in or out).
template <int K>
__device__ __forceinline__ void load_taps(const float* __restrict__ row, int t0, int np,
                                          bool vec, float (&v)[K]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < K / 4; ++c) {
      const int t = t0 + 4 * c;
      const float4 f = t < np ? __ldg(reinterpret_cast<const float4*>(row + t))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * c] = f.x;
      v[4 * c + 1] = f.y;
      v[4 * c + 2] = f.z;
      v[4 * c + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = t0 + k < np ? __ldg(row + t0 + k) : 0.0f;
  }
}

// Stores the lane's taps below np of a fresh output row (16-byte aligned:
// the row starts at a multiple of np floats of a torch allocation).
template <int K>
__device__ __forceinline__ void store_taps(float* __restrict__ row, int t0, int np,
                                           const float (&v)[K]) {
#pragma unroll
  for (int c = 0; c < K / 4; ++c) {
    const int t = t0 + 4 * c;
    if (t < np)
      *reinterpret_cast<float4*>(row + t) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// S1's stores of the lane's taps below np of a fresh output row, 16 bytes
// an instruction: the two lanes of a pair (g, g ^ 1: one patch, G even)
// swap one 4-tap chunk a sector, so that each instruction writes whole
// 32-byte sectors (the even lane's 8 taps, then the odd lane's) instead of
// half of each of twice as many.  Every lane of the warp must call it;
// only valid lanes store.  K = 4 (G = 1: a lane's taps are its patch, and
// a warp's lanes already write whole sectors) stores as store_taps.
template <int K>
__device__ __forceinline__ void store_taps_paired(float* __restrict__ row, int t0, int np,
                                                  const float (&v)[K], bool valid) {
  if (K < 8) {
    if (valid) store_taps<K>(row, t0, np, v);
    return;
  }
  const bool odd = threadIdx.x & 1;
  const int mine = t0, theirs = odd ? t0 - K : t0 + K;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const int c0 = 8 * j, c1 = 8 * j + 4;   // the sector's chunks in a lane
    float send[4], recv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      send[q] = odd ? v[c0 + q] : v[c1 + q];
      recv[q] = __shfl_xor_sync(0xffffffffu, send[q], 1);
    }
    if (!valid) continue;
    // The even lane's sector, then the odd lane's.
    const int ta = odd ? theirs + c1 : mine + c0, tb = odd ? mine + c1 : theirs + c0;
    const float4 fa = odd ? make_float4(recv[0], recv[1], recv[2], recv[3])
                          : make_float4(v[c0], v[c0 + 1], v[c0 + 2], v[c0 + 3]);
    const float4 fb = odd ? make_float4(v[c1], v[c1 + 1], v[c1 + 2], v[c1 + 3])
                          : make_float4(recv[0], recv[1], recv[2], recv[3]);
    if (ta < np) *reinterpret_cast<float4*>(row + ta) = fa;
    if (tb < np) *reinterpret_cast<float4*>(row + tb) = fb;
  }
}

// ---------------------------------------------------------------------------
// S1: planes img, dx, dy [nb, th, tw]; writes T, Tdx, Tdy [nb, n, ps^2],
// hinv [nb, n, 2, 2] and, where residual, tn [nb, n, ps^2].  Where start,
// also the search start from flow [nb, hc, wc, 2] (read only where
// coarser), nn_rows [num_h] and nn_cols [num_w] int64 and centers [n, 2]:
// init_u and pos0 [nb, n, 2] and conv0 [nb, n] (bool).
struct TemplateGrid {
  const float* img;
  const float* dx;
  const float* dy;
  int th, tw, num_w, num_h, steps, y0, x0, ps;
  int rows, cols;        // patch rows and columns a tile
  int tiles_h, tiles_w;  // tiles a pair, along a column and a row of the grid
  int pitch;             // a staged window row, in floats
  int plane;             // a staged plane: ((rows - 1) * steps + ps) * pitch floats
  int n, residual;       // patches a pair; whether tn is written
  float inv_ps2;
  float* T;
  float* Tdx;
  float* Tdy;
  float* hinv;
  float* tn;
  int start, coarser;    // whether to write the start; whether a coarser flow exists
  const float* flow;
  const long long* nn_rows;
  const long long* nn_cols;
  int hc, wc, row_off;   // the coarser flow's rows and columns; its first global row
  const float* centers;
  float lb, ub_w, ub_h;  // the valid region of ops/iclk.py::out_of_bounds
  float* init_u;
  float* pos0;
  uint8_t* conv0;
};

// A tile: its pair, its first patch row and column, and how many of its
// patch rows and columns lie in the grid (fewer at the grid's far edges).
struct TemplateTile {
  long long pair;
  int iy0, ix0, pv, cv;
  __device__ __forceinline__ TemplateTile(const TemplateGrid& g, long long t) {
    const int per_pair = g.tiles_h * g.tiles_w;
    pair = t / per_pair;
    const int rem = (int)(t - pair * per_pair);
    const int tx = rem / g.tiles_h, ty = rem - tx * g.tiles_h;
    iy0 = ty * g.rows;
    ix0 = tx * g.cols;
    pv = min(g.rows, g.num_h - iy0);
    cv = min(g.cols, g.num_w - ix0);
  }
};

// Starts the copies of tile tl's window of the three planes into buf
// ([3][window rows][pitch]); rows past the tile's last patch are not read.
__device__ __forceinline__ void stage_window(const TemplateGrid& g, const TemplateTile& tl,
                                             float* buf) {
  const int wr = (tl.pv - 1) * g.steps + g.ps, wc = (tl.cv - 1) * g.steps + g.ps;
  const long long src = tl.pair * g.th * g.tw + (long long)(g.y0 + tl.iy0 * g.steps) * g.tw +
                        g.x0 + tl.ix0 * g.steps;
  for (int e = threadIdx.x; e < wr * wc; e += THREADS) {
    const int r = e / wc, c = e - r * wc;
    const long long off = src + (long long)r * g.tw + c;
    float* d = buf + r * g.pitch + c;
    dis_cp_async4(d, g.img + off);
    dis_cp_async4(d + g.plane, g.dx + off);
    dis_cp_async4(d + 2 * g.plane, g.dy + off);
  }
}

// S1's search start, a thread a patch of the tile (slot threadIdx.x:
// patch column slot / rows, row slot % rows, the tile's consecutive patch
// rows on consecutive threads, as consecutive outputs), in three steps
// around the rest of the block's work, so that its dependent loads wait
// on memory while the window's copies and the templates do.  start_pick
// loads the patch's picks (row nn_rows[iy] - row_off and column
// nn_cols[ix] of the coarser flow) and its center before the window's
// copies are issued; start_flow loads the picked flow value right after
// them; start_write, after the block's patches, writes init_u (x2 that
// value, zeros where there is no coarser flow: the coarsest scale), pos0
// = centers + init_u and conv0, the start test.
struct StartPick {
  long long row, col;
  float2 center;
  bool has;   // the thread's slot is a patch of the grid and the launch writes the start
};

__device__ __forceinline__ StartPick start_pick(const TemplateGrid& g, const TemplateTile& tl) {
  StartPick p;
  const int s = threadIdx.x, cl = s / g.rows, rl = s - cl * g.rows;
  p.has = g.start && s < g.rows * g.cols && rl < tl.pv && cl < tl.cv;
  p.row = p.col = 0;
  p.center = make_float2(0.0f, 0.0f);
  if (p.has) {
    const int ix = tl.ix0 + cl, iy = tl.iy0 + rl;
    if (g.coarser) {
      p.row = g.nn_rows[iy] - g.row_off;
      p.col = g.nn_cols[ix];
    }
    p.center = reinterpret_cast<const float2*>(g.centers)[(long long)ix * g.num_h + iy];
  }
  return p;
}

// The picked flow value (zeros where there is none).
__device__ __forceinline__ float2 start_flow(const TemplateGrid& g, const TemplateTile& tl,
                                             const StartPick& p) {
  if (!p.has || !g.coarser) return make_float2(0.0f, 0.0f);
  return *reinterpret_cast<const float2*>(g.flow + ((tl.pair * g.hc + p.row) * g.wc + p.col) * 2);
}

__device__ __forceinline__ void start_write(const TemplateGrid& g, const TemplateTile& tl,
                                            const StartPick& p, float2 f) {
  if (!p.has) return;
  const int s = threadIdx.x, cl = s / g.rows, rl = s - cl * g.rows;
  const long long i = tl.pair * g.n + (long long)(tl.ix0 + cl) * g.num_h + tl.iy0 + rl;
  const float ux = f.x * 2.0f, uy = f.y * 2.0f;   // +0.0 where there is no coarser flow
  const float px = p.center.x + ux, py = p.center.y + uy;
  reinterpret_cast<float2*>(g.init_u)[i] = make_float2(ux, uy);
  reinterpret_cast<float2*>(g.pos0)[i] = make_float2(px, py);
  g.conv0[i] = (px < g.lb) | (py < g.lb) | (px > g.ub_w) | (py > g.ub_h);
}

// At most 85 registers a thread, so that three blocks fit an SM.
template <int K, int G>
__global__ void __launch_bounds__(THREADS, 3)
templates_kernel(const TemplateGrid g) {
  extern __shared__ float win[];   // [3][window rows][pitch]
  constexpr int GROUPS = THREADS / G;
  const int np = g.ps * g.ps;
  const int lane_g = threadIdx.x % G, group = threadIdx.x / G;
  const int t0 = lane_g * K;
  const TemplateTile tl(g, blockIdx.x);
  // The start's loads (the picks, then the flow value they pick) wait on
  // memory while the window's copies and the templates do.
  const StartPick pick = start_pick(g, tl);
  stage_window(g, tl, win);
  dis_cp_async_commit();
  const float2 picked = start_flow(g, tl, pick);
  const int slots = g.rows * g.cols;
  int off[K];   // the lane's taps in the staged window, -1 past ps^2
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int tap = t0 + k, j = tap / g.ps;
    off[k] = tap < np ? j * g.pitch + tap - j * g.ps : -1;
  }
  dis_cp_async_wait_all();
  __syncthreads();
  // Slot s of the tile is its patch (column s / rows, row s % rows); a
  // warp's groups take consecutive slots, rows a multiple of 32 / G.
  for (int s0 = 0; s0 < slots; s0 += GROUPS) {
    const int slot = s0 + group;
    const int cl = slot / g.rows, rl = slot - cl * g.rows;
    const bool valid = slot < slots && rl < tl.pv && cl < tl.cv;
    // An invalid lane computes on the tile's first patch and stores nothing.
    const float* base = win + (valid ? rl * g.steps * g.pitch + cl * g.steps : 0);
    float tv[K], gx[K], gy[K], xx[K], xy[K], yy[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tv[k] = gx[k] = gy[k] = 0.0f;
      if (off[k] >= 0) {
        tv[k] = base[off[k]];
        gx[k] = base[g.plane + off[k]];
        gy[k] = base[2 * g.plane + off[k]];
      }
      xx[k] = gx[k] * gx[k];
      xy[k] = gx[k] * gy[k];
      yy[k] = gy[k] * gy[k];
    }
    float a = dis_group_sum<K, G>(xx);
    const float b = dis_group_sum<K, G>(xy);
    float c = dis_group_sum<K, G>(yy);
    const long long i = tl.pair * g.n + (long long)(tl.ix0 + cl) * g.num_h + tl.iy0 + rl;
    store_taps_paired<K>(g.T + i * np, t0, np, tv, valid);
    store_taps_paired<K>(g.Tdx + i * np, t0, np, gx, valid);
    store_taps_paired<K>(g.Tdy + i * np, t0, np, gy, valid);
    if (g.residual) {  // uniform across the launch: every lane joins the sum
      const float m = dis_group_sum<K, G>(tv) * g.inv_ps2;
#pragma unroll
      for (int k = 0; k < K; ++k) tv[k] = tv[k] - m;
      store_taps_paired<K>(g.tn + i * np, t0, np, tv, valid);
    }
    if (valid && lane_g == 0) {
      // templates_from_hessian: the det == 0 guard adds 1e-10 to a and c,
      // +0.0 elsewhere; then the inverse from the recomputed determinant.
      const float det0 = a * c - b * b;
      const float guard = det0 == 0.0f ? 1e-10f : 0.0f;
      a = a + guard;
      c = c + guard;
      const float inv_det = __frcp_rn(a * c - b * b);
      const float nb_ = -b * inv_det;
      *reinterpret_cast<float4*>(g.hinv + 4 * i) =
          make_float4(c * inv_det, nb_, nb_, a * inv_det);
    }
  }
  start_write(g, tl, pick, picked);
}

// ---------------------------------------------------------------------------
// S3: q, t [nb * n, ps^2], oob [nb * n] (bool); writes w [nb * n].
template <int K, int G>
__global__ void __launch_bounds__(THREADS)
weights_kernel(const float* __restrict__ q, const float* __restrict__ t,
               const uint8_t* __restrict__ oob, long long total, int np, int normalize,
               float ps2, int vec, float* __restrict__ w) {
  const Lane<G> lane;
  const bool valid = lane.slot < total;
  const long long i = valid ? lane.slot : 0;
  const int t0 = lane.g * K;
  float tv[K], qv[K], r2[K];
  load_taps<K>(t + i * np, t0, np, vec, tv);
  load_taps<K>(q + i * np, t0, np, vec, qv);
  if (normalize) {  // uniform across the launch
    const float m = __fdiv_rn(dis_group_sum<K, G>(tv), ps2);
#pragma unroll
    for (int k = 0; k < K; ++k) tv[k] = tv[k] - m;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float r = qv[k] - tv[k];
    r2[k] = t0 + k < np ? r * r : 0.0f;
  }
  const float s = dis_group_sum<K, G>(r2);
  if (valid && lane.g == 0) {
    // torch.clamp(s, min=1.0) keeps a NaN; then its reciprocal.
    w[i] = oob[i] ? 1.0f : __frcp_rn(s < 1.0f ? 1.0f : s);
  }
}

// ---------------------------------------------------------------------------
// S4: u [nb, n, 2] and, where weighted, weights [nb, n], else the uniform
// weight, whose sum is uwsum [out_h, W] (an empty grid's pointers may be
// null, so a flag, not the pointer, says which); cover_rows [out_h, kr] and
// cover_cols [W, kc] int64 (num_h and num_w the zero row and column);
// writes out [nb, out_h, W, 2].  A block a tile of DENSIFY_ROWS output rows
// by DENSIFY_COLS output columns of a pair, tile = (pair * tiles_h + ty) *
// tiles_w + tx; kr and kc are KR and KC where those are not 0.  Shared
// memory (densify_bytes), as Vec (float4 {u0 w, u1 w, w, 0} where
// WEIGHTED, else float2 {u0, u1}): the staged sub-block su [cap_r + 1]
// [cap_c] (row cap_r the zero row) and the row pass's sums acc
// [DENSIFY_ROWS][cap_c + 1] (column cap_c the zero column); then as floats
// the uniform weights [DENSIFY_ROWS][DENSIFY_COLS] where not WEIGHTED, and
// the covers as 32-bit indices rows [DENSIFY_ROWS][kr] and cols
// [DENSIFY_COLS][kc].
constexpr int DENSIFY_ROWS = 32, DENSIFY_COLS = 128;

long long densify_bytes(int kr, int kc, int cap_r, int cap_c, int weighted) {
  const long long vec = weighted ? sizeof(float4) : sizeof(float2);
  return vec * ((cap_r + 1LL) * cap_c + DENSIFY_ROWS * (cap_c + 1LL)) +
         (long long)sizeof(float) * ((weighted ? 0 : DENSIFY_ROWS * DENSIFY_COLS) +
                                     DENSIFY_ROWS * kr + DENSIFY_COLS * kc);
}

struct DensifyArgs {
  const float* u;
  const float* wts;
  const long long* cover_rows;
  const long long* cover_cols;
  const float* uwsum;
  float* out;
  int out_h, W, kr, kc, num_w, num_h, tiles_w, tiles_h, cap_r, cap_c;
};

// The sum terms of S4: {u0, u1} where uniform, {u0 w, u1 w, w, 0} where
// weighted; zero() is the zero row's and column's, plus() adds each
// channel, and flow() the normalized flow (ws = the weight plane's value
// where uniform).
template <bool WEIGHTED>
struct Terms;
template <>
struct Terms<false> {
  using Vec = float2;
  static __device__ __forceinline__ Vec zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ Vec load(const float* up, const float*, long long p) {
    return *reinterpret_cast<const float2*>(up + 2 * p);
  }
  static __device__ __forceinline__ Vec plus(Vec a, Vec b) {
    return make_float2(a.x + b.x, a.y + b.y);
  }
  static __device__ __forceinline__ float weight(Vec, float ws) { return ws; }
};
template <>
struct Terms<true> {
  using Vec = float4;
  static __device__ __forceinline__ Vec zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  static __device__ __forceinline__ Vec load(const float* up, const float* wp, long long p) {
    const float2 uv = *reinterpret_cast<const float2*>(up + 2 * p);
    const float w = wp[p];
    return make_float4(uv.x * w, uv.y * w, w, 0.0f);   // rounded as densify_plain's u * w
  }
  static __device__ __forceinline__ Vec plus(Vec a, Vec b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, 0.0f);
  }
  static __device__ __forceinline__ float weight(Vec f, float) { return f.z; }
};

template <bool WEIGHTED>
__device__ __forceinline__ void put_flow(float* __restrict__ out, long long at,
                                         typename Terms<WEIGHTED>::Vec f, float uw) {
  const float ws = Terms<WEIGHTED>::weight(f, uw);
  const bool pos = ws > 0.0f;
  *reinterpret_cast<float2*>(out + 2 * at) =
      make_float2(pos ? __fdiv_rn(f.x, ws) : 0.0f, pos ? __fdiv_rn(f.y, ws) : 0.0f);
}

// At most 64 registers a thread, so that four blocks fit an SM.
template <int KR, int KC, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS, 4)
densify_kernel(const DensifyArgs a) {
  using T = Terms<WEIGHTED>;
  using Vec = typename T::Vec;
  constexpr int TY = DENSIFY_ROWS, TX = DENSIFY_COLS, LINES = THREADS / TX, PX = TY / LINES;
  constexpr int WARPS = THREADS / 32;
  const int kr = KR ? KR : a.kr, kc = KC ? KC : a.kc;
  const int cap_r = a.cap_r, cap_c = a.cap_c, num_h = a.num_h, num_w = a.num_w;
  extern __shared__ float4 dsm[];
  __shared__ int red[WARPS][4];
  Vec* su = reinterpret_cast<Vec*>(dsm);
  Vec* acc = su + (cap_r + 1) * cap_c;
  const int acc_pitch = cap_c + 1;
  float* uwb = reinterpret_cast<float*>(acc + TY * acc_pitch);
  int* rows = reinterpret_cast<int*>(uwb + (WEIGHTED ? 0 : TY * TX));
  int* cols = rows + TY * kr;

  const long long per_pair = (long long)a.tiles_h * a.tiles_w;
  const long long pair = blockIdx.x / per_pair;
  const int rem = (int)(blockIdx.x - pair * per_pair);
  const int ty = rem / a.tiles_w;
  const int y0 = ty * TY, x0 = (rem - ty * a.tiles_w) * TX;
  const int xl = threadIdx.x % TX, line = threadIdx.x / TX, x = x0 + xl;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n = (long long)num_w * num_h;
  const float* up = a.u + pair * n * 2;
  const float* wp = WEIGHTED ? a.wts + pair * n : nullptr;
  const long long out0 = pair * a.out_h;

  // The uniform weights of the thread's own pixels start first, so that
  // they arrive while the covers are reduced (only this thread reads them).
  if (!WEIGHTED) {
    for (int j = 0; j < PX; ++j) {
      const int yl = line + LINES * j, y = y0 + yl;
      if (y < a.out_h && x < a.W)
        dis_cp_async4(uwb + yl * TX + xl, a.uwsum + (long long)y * a.W + x);
      else
        uwb[yl * TX + xl] = 0.0f;
    }
  }
  dis_cp_async_commit();
  // The covers as 32-bit indices, and the range of grid rows and columns
  // they reach.
  int rlo = INT_MAX, rhi = -1, clo = INT_MAX, chi = -1;
  for (int e = threadIdx.x; e < TY * kr; e += THREADS) {
    const int gi = y0 + e / kr < a.out_h ? (int)a.cover_rows[(long long)y0 * kr + e] : num_h;
    rows[e] = gi;
    if (gi != num_h) {
      rlo = min(rlo, gi);
      rhi = max(rhi, gi);
    }
  }
  for (int e = threadIdx.x; e < TX * kc; e += THREADS) {
    const int ci = x0 + e / kc < a.W ? (int)a.cover_cols[(long long)x0 * kc + e] : num_w;
    cols[e] = ci;
    if (ci != num_w) {
      clo = min(clo, ci);
      chi = max(chi, ci);
    }
  }
  rlo = __reduce_min_sync(0xffffffffu, rlo);
  rhi = __reduce_max_sync(0xffffffffu, rhi);
  clo = __reduce_min_sync(0xffffffffu, clo);
  chi = __reduce_max_sync(0xffffffffu, chi);
  if (lane == 0) {
    red[warp][0] = rlo;
    red[warp][1] = rhi;
    red[warp][2] = clo;
    red[warp][3] = chi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    rlo = min(rlo, red[w][0]);
    rhi = max(rhi, red[w][1]);
    clo = min(clo, red[w][2]);
    chi = max(chi, red[w][3]);
  }
  const int nr = rhi >= rlo ? rhi - rlo + 1 : 0, nc = chi >= clo ? chi - clo + 1 : 0;
  const int* cc = cols + xl * kc;

  if (nr <= cap_r && nc <= cap_c) {   // uniform across the block
    // Local indices (each thread rewrites the entries it wrote).
    for (int e = threadIdx.x; e < TY * kr; e += THREADS)
      rows[e] = rows[e] == num_h ? cap_r : rows[e] - rlo;
    for (int e = threadIdx.x; e < TX * kc; e += THREADS)
      cols[e] = cols[e] == num_w ? cap_c : cols[e] - clo;
    // The sub-block, a grid column's rows contiguous (u is x-outer), and
    // the zero row.
    for (int e = threadIdx.x; e < nr * nc; e += THREADS) {
      const int c = e / nr, r = e - c * nr;
      su[r * cap_c + c] = T::load(up, wp, (long long)(clo + c) * num_h + rlo + r);
    }
    for (int c = threadIdx.x; c < nc; c += THREADS) su[cap_r * cap_c + c] = T::zero();
    __syncthreads();
    // The row pass: each (output row, grid column) once, a warp a row.
    for (int yl = warp; yl < TY; yl += WARPS) {
      const int* rr = rows + yl * kr;
      for (int c = lane; c < nc; c += 32) {
        Vec s = su[rr[0] * cap_c + c];
#pragma unroll
        for (int k = 1; k < kr; ++k) s = T::plus(s, su[rr[k] * cap_c + c]);
        acc[yl * acc_pitch + c] = s;
      }
      if (lane == 0) acc[yl * acc_pitch + cap_c] = T::zero();
    }
    dis_cp_async_wait_all();   // this thread's uniform weights
    __syncthreads();
    // The column pass.
#pragma unroll 4
    for (int j = 0; j < PX; ++j) {
      const int yl = line + LINES * j, y = y0 + yl;
      const Vec* ar = acc + yl * acc_pitch;
      Vec f = ar[cc[0]];
#pragma unroll
      for (int k = 1; k < kc; ++k) f = T::plus(f, ar[cc[k]]);
      if (y < a.out_h && x < a.W)
        put_flow<WEIGHTED>(a.out, (out0 + y) * a.W + x, f, WEIGHTED ? 0.0f : uwb[yl * TX + xl]);
    }
  } else {
    // Covers that reach past the staged sub-block: each pixel sums straight
    // from device memory, row sums inside column sums, in the same order.
    dis_cp_async_wait_all();
    for (int j = 0; j < PX; ++j) {
      const int yl = line + LINES * j, y = y0 + yl;
      const int* rr = rows + yl * kr;
      Vec f = T::zero();
      for (int kx = 0; kx < kc; ++kx) {
        const int c = cc[kx];
        Vec s = T::zero();   // the zero column's sums
        if (c != num_w) {
          for (int ky = 0; ky < kr; ++ky) {
            const int gi = rr[ky];
            const Vec v = gi != num_h ? T::load(up, wp, (long long)c * num_h + gi) : T::zero();
            s = ky == 0 ? v : T::plus(s, v);
          }
        }
        f = kx == 0 ? s : T::plus(f, s);
      }
      if (y < a.out_h && x < a.W)
        put_flow<WEIGHTED>(a.out, (out0 + y) * a.W + x, f, WEIGHTED ? 0.0f : uwb[yl * TX + xl]);
    }
  }
}

const void* const TEMPLATE_KERNELS[] = {
    (const void*)templates_kernel<8, 8>, (const void*)templates_kernel<8, 16>,
    (const void*)templates_kernel<8, 32>, (const void*)templates_kernel<16, 32>,
    (const void*)templates_kernel<8, 2>, (const void*)templates_kernel<4, 1>};
const void* const DENSIFY_KERNELS[] = {
    (const void*)densify_kernel<3, 3, false>, (const void*)densify_kernel<5, 5, false>,
    (const void*)densify_kernel<0, 0, false>, (const void*)densify_kernel<3, 3, true>,
    (const void*)densify_kernel<5, 5, true>, (const void*)densify_kernel<0, 0, true>};
int templates_granted[64] = {0};
int densify_granted[64] = {0};

// Launches a K, G instance of a patch kernel over total patches.
template <int K, int G>
unsigned patch_blocks(long long total) {
  const long long warps = (total + 32 / G - 1) / (32 / G);
  return blocks_for(warps * 32);
}

}  // namespace

// S1.  nb pairs of planes [th, tw]; a grid of n = num_w * num_h patches
// (num_h the column length), steps apart, the first tap at (y0, x0), taps
// inside the planes (the wrapper checks).  ps even, ps^2 <= 512.  A block a
// tile of tile_rows patch rows (a multiple of 32 / G) by tile_cols patch
// columns, staged with a row pitch of pitch floats (at least (tile_cols -
// 1) * steps + ps) in shared bytes (3 planes of (tile_rows - 1) * steps +
// ps rows), at most THREADS patches a tile;
// ops/cuda/scale_kernel.py::template_tiles gives them.  Where
// start, also the search start: init_u from flow [nb, hc, wc, 2] where
// coarser (row_off, the coarser flow's first global row, subtracted from
// nn_rows), else zeros (flow is then never read, whatever it points to);
// lb, ub_w, ub_h the valid region of ops/iclk.py::out_of_bounds.  Returns
// cudaGetLastError() after the launch (nb * n = 0 launches nothing).
extern "C" int dis_scale_templates(const float* img, const float* dx, const float* dy, int nb,
                                   int th, int tw, int n, int num_h, int steps, int y0, int x0,
                                   int ps, int residual, float inv_ps2, int tile_rows,
                                   int tile_cols, int pitch, int shared, float* T, float* Tdx,
                                   float* Tdy, float* hinv, float* tn, int start, int coarser,
                                   const float* flow, const long long* nn_rows,
                                   const long long* nn_cols, int hc, int wc, int row_off,
                                   const float* centers, float lb, float ub_w, float ub_h,
                                   float* init_u, float* pos0, unsigned char* conv0,
                                   cudaStream_t stream) {
  int k = 0, g = 0;
  if (dis_iclk_layout(ps, &k, &g) != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nb * n;
  if (total <= 0) return (int)cudaGetLastError();
  if (num_h <= 0 || n % num_h != 0 || steps < 1 || tile_rows < 1 || tile_cols < 1 ||
      tile_rows * tile_cols > THREADS || tile_rows % (32 / g) != 0 ||
      pitch < (tile_cols - 1) * steps + ps)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)((tile_rows - 1) * steps + ps) * pitch;
  if ((long long)shared != 3 * plane * (long long)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(T) || !aligned16(Tdx) || !aligned16(Tdy) || !aligned16(hinv) ||
      (residual && !aligned16(tn)))
    return (int)cudaErrorMisalignedAddress;
  if (start && (centers == nullptr || init_u == nullptr || pos0 == nullptr ||
                conv0 == nullptr || (coarser && (flow == nullptr || nn_rows == nullptr ||
                                                 nn_cols == nullptr || hc < 1 || wc < 1))))
    return (int)cudaErrorInvalidValue;
  if (start && (!aligned8(centers) || !aligned8(init_u) || !aligned8(pos0) ||
                (coarser && !aligned8(flow))))
    return (int)cudaErrorMisalignedAddress;
  const int limit = dis_shared_limit(templates_granted, TEMPLATE_KERNELS);
  if (limit == 0) return (int)cudaGetLastError();
  TemplateGrid grid;
  grid.img = img;
  grid.dx = dx;
  grid.dy = dy;
  grid.th = th;
  grid.tw = tw;
  grid.num_w = n / num_h;
  grid.num_h = num_h;
  grid.steps = steps;
  grid.y0 = y0;
  grid.x0 = x0;
  grid.ps = ps;
  grid.rows = tile_rows;
  grid.cols = tile_cols;
  grid.tiles_h = (num_h + tile_rows - 1) / tile_rows;
  grid.tiles_w = (grid.num_w + tile_cols - 1) / tile_cols;
  grid.pitch = pitch;
  grid.plane = (int)plane;
  grid.n = n;
  grid.residual = residual;
  grid.inv_ps2 = inv_ps2;
  grid.T = T;
  grid.Tdx = Tdx;
  grid.Tdy = Tdy;
  grid.hinv = hinv;
  grid.tn = tn;
  grid.start = start != 0;
  grid.coarser = start && coarser;
  grid.flow = flow;
  grid.nn_rows = nn_rows;
  grid.nn_cols = nn_cols;
  grid.hc = hc;
  grid.wc = wc;
  grid.row_off = row_off;
  grid.centers = centers;
  grid.lb = lb;
  grid.ub_w = ub_w;
  grid.ub_h = ub_h;
  grid.init_u = init_u;
  grid.pos0 = pos0;
  grid.conv0 = conv0;
  const long long blocks = (long long)nb * grid.tiles_h * grid.tiles_w;
  if (shared > limit || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#define DIS_S1_LAUNCH(KK, GG)                                                          \
  templates_kernel<KK, GG><<<(unsigned)blocks, THREADS, shared, stream>>>(grid); \
  return (int)cudaGetLastError()
  if (k == 8 && g == 8) { DIS_S1_LAUNCH(8, 8); }
  if (k == 8 && g == 16) { DIS_S1_LAUNCH(8, 16); }
  if (k == 8 && g == 32) { DIS_S1_LAUNCH(8, 32); }
  if (k == 16 && g == 32) { DIS_S1_LAUNCH(16, 32); }
  if (k == 8 && g == 2) { DIS_S1_LAUNCH(8, 2); }
  if (k == 4 && g == 1) { DIS_S1_LAUNCH(4, 1); }
#undef DIS_S1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// S3.  nb * n patches of ps^2 taps; ps2 = ps^2 as a float (the divisor of
// the template's mean where normalize).  nb * n = 0 launches nothing.
extern "C" int dis_fixed_weights(const float* q, const float* t, const unsigned char* oob,
                                 int nb, int n, int ps, int normalize, float ps2, float* w,
                                 cudaStream_t stream) {
  int k = 0, g = 0;
  if (dis_iclk_layout(ps, &k, &g) != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nb * n;
  if (total <= 0) return (int)cudaGetLastError();
  const int np = ps * ps;
  const int vec = aligned16(q) && aligned16(t);
#define DIS_S3_LAUNCH(KK, GG)                                                               \
  weights_kernel<KK, GG><<<patch_blocks<KK, GG>(total), THREADS, 0, stream>>>(              \
      q, t, oob, total, np, normalize, ps2, vec, w);                                        \
  return (int)cudaGetLastError()
  if (k == 8 && g == 8) { DIS_S3_LAUNCH(8, 8); }
  if (k == 8 && g == 16) { DIS_S3_LAUNCH(8, 16); }
  if (k == 8 && g == 32) { DIS_S3_LAUNCH(8, 32); }
  if (k == 16 && g == 32) { DIS_S3_LAUNCH(16, 32); }
  if (k == 8 && g == 2) { DIS_S3_LAUNCH(8, 2); }
  if (k == 4 && g == 1) { DIS_S3_LAUNCH(4, 1); }
#undef DIS_S3_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// S4.  nb pairs of a num_w x num_h grid; out [nb, out_h, W, 2]; weighted:
// the weights wts, else the uniform weight (uwsum [out_h, W] gives its sum).
// A block a tile of 32 output rows by 128 columns, staging up to cap_r grid
// rows by cap_c grid columns in shared bytes (densify_bytes);
// ops/cuda/scale_kernel.py::densify_tiles gives them.  An empty output
// launches nothing.
extern "C" int dis_densify(const float* u, const float* wts, const long long* cover_rows,
                           const long long* cover_cols, const float* uwsum, int weighted,
                           int nb, int out_h, int W, int kr, int kc, int num_w, int num_h,
                           int cap_r, int cap_c, int shared, float* out, cudaStream_t stream) {
  if (kr <= 0 || kc <= 0 || num_w < 0 || num_h < 0 || cap_r < 0 || cap_c < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)nb * out_h <= 0 || W <= 0) return (int)cudaGetLastError();
  if (!aligned8(u) || !aligned8(out)) return (int)cudaErrorMisalignedAddress;
  if ((long long)shared != densify_bytes(kr, kc, cap_r, cap_c, weighted))
    return (int)cudaErrorInvalidValue;
  const int limit = dis_shared_limit(densify_granted, DENSIFY_KERNELS);
  if (limit == 0) return (int)cudaGetLastError();
  DensifyArgs a;
  a.u = u;
  a.wts = wts;
  a.cover_rows = cover_rows;
  a.cover_cols = cover_cols;
  a.uwsum = uwsum;
  a.out = out;
  a.out_h = out_h;
  a.W = W;
  a.kr = kr;
  a.kc = kc;
  a.num_w = num_w;
  a.num_h = num_h;
  a.tiles_w = (W + DENSIFY_COLS - 1) / DENSIFY_COLS;
  a.tiles_h = (out_h + DENSIFY_ROWS - 1) / DENSIFY_ROWS;
  a.cap_r = cap_r;
  a.cap_c = cap_c;
  const long long blocks = (long long)nb * a.tiles_h * a.tiles_w;
  if (shared > limit || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int kk = kr == kc && (kr == 3 || kr == 5) ? kr : 0;
#define DIS_S4_LAUNCH(KK, WW)                                                       \
  densify_kernel<KK, KK, WW><<<(unsigned)blocks, THREADS, shared, stream>>>(a); \
  return (int)cudaGetLastError()
#define DIS_S4_COVERS(WW)                 \
  if (kk == 3) { DIS_S4_LAUNCH(3, WW); } \
  if (kk == 5) { DIS_S4_LAUNCH(5, WW); } \
  DIS_S4_LAUNCH(0, WW)
  if (weighted) { DIS_S4_COVERS(true); }
  DIS_S4_COVERS(false);
#undef DIS_S4_COVERS
#undef DIS_S4_LAUNCH
}
