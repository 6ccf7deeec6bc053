// K1: the whole IC-LK search loop for every patch at one scale.
//
// Replaces the TPU kernel dis_tpu/ops/pallas/iclk_kernel.py::_iclk_kernel
// (driven by inverse_search_pallas).  Per patch:
//   start: q = bilinear resample at centers + init_u; a start out of bounds
//          freezes the patch with q = T (the raw template).
//   each of n_iters = iterations + 1 trips, until the patch freezes:
//     rhs = [sum Tdx r, sum Tdy r], r = q (compat) or q - Tn (fixed);
//     delta = Hinv rhs; u -= delta;
//     policing (Q9): further than thresh from the start, or out of bounds,
//       resets u to init_u and freezes the patch;
//     q = ps x ps bilinear resample from the patch's region, tap base
//       ceil(pos + 1e-5f) (Q10), column blend then row blend, optionally
//       minus its mean (a stripe's row0, the global row of the plane's
//       first row, moves the y tap base only);
//     fixed mode: |delta| < conv_eps freezes the patch.
//
// A patch's region is the rc x rc window (rc = 2 ps + 3) of I2's padded
// level plane that K2 (extract_regions.cu) would copy for it.  Two modes,
// one template flag: in regions mode the warp stages the regions K2 or K2c
// wrote; in plane mode (dis_iclk_search_plane, the main path's route
// "K2") it takes K2's bases itself from the start pos0, base = clip(ceil(
// pos0 + 1e-5f) + pad - ps - 2, 0, dim - rc) with row0 from y only (base 0
// and indices clipped to the last row or column on an axis of fewer than
// rc entries, K2's small_kernel), and copies each window straight from the
// plane.  Both fill the same shared slots with the same floats, so every
// tap reads the bits it reads in the other mode, and no [n, rc, rc]
// regions go through device memory.
//
// Layout (dis_iclk_search_layout below): a group of G lanes per patch,
// 32 / G patches per warp.  Lane g of a group holds the K consecutive taps
// [g K, g K + K) of Tdx, Tdy, Tn and q in registers.  Where G K is the
// power of two >= ps^2 (dis_iclk_layout), taps past ps^2 are zero: ps = 8:
// K = 8, G = 8, so a lane holds one patch row and a warp four patches;
// ps = 10: K = 8, G = 16; ps = 16: K = 8, G = 32; other even ps up to 22
// take a runtime-ps instance.  ps = 12 takes the split layout, in which no
// lane holds only padding (the power-of-two layout gave it 32 lanes, 14 of
// them all zeros): G K = 128 main taps with K = 8, G = 16, two patches a
// warp, and lane g also holds the extra tap 128 + g.  ps is a template
// parameter for 8, 10, 12, 16, so no tap index needs a runtime division;
// where a lane's taps lie in one patch row (ps = 8, 16) the lane loads its
// two region rows once and blends them column then row; at ps = 12 its
// main taps are two runs of 4 taps, each in one patch row, whose window
// offsets and the extra tap's are fixed for the patch (lane_taps).
//
// Every sum over taps is the in-lane pair tree over K taps followed by
// log2(G) xor-butterfly levels with offsets below G: that is the balanced
// pair tree of ops/iclk.py::pairwise_sum over the zero-padded taps, and
// float addition is commutative, so every lane of a group holds the same
// bits and the kernel equals the plain PyTorch version bitwise (the build
// passes -fmad=false).  Over 144 taps that tree is tree(taps 0..127) +
// (tree(taps 128..143) + 0.0f), the + 0.0f being what its zero-padded
// levels do to a -0.0: the split layout sums its extra taps by a second
// butterfly over the group and adds them so (tap_sum).
//
// Freezing: a warp loops while any of its groups is active (__any_sync);
// every lane runs each trip's arithmetic and shuffles under the full mask,
// and a group's u, q and conv change only while its patch is active, as in
// iclk_search_plain.  A frozen patch never changes, so leaving the loop
// when all four are frozen is output-identical to the full trip count.
//
// Bound on the H100: instruction issue, not memory.  A patch reads its
// templates once from device memory (T, Tdx, Tdy and, in fixed mode, Tn:
// 2.3 KB at ps 12, 1.0 KB at ps 8) and its window of rc^2 floats (2.9 KB
// at ps 12, 1.4 KB at ps 8).  In plane mode the window comes from the
// level plane, which the L2 holds (2.2 MB at the 1080p PRESET_MEDIUM
// finest level, 8.6 MB at 2160p's, against 50 MB): device memory sees the
// plane about once, and the windows' 170 MB at the 1080p medium finest
// scale (58,240 patches; 677 MB at 2160p) are read from the L2, or from
// the L1 where the 4 warps of a block, neighbours 3 px apart in a grid
// column, overlap.  In regions mode those bytes came from device memory,
// after K2 had written them there.  Issue slots per patch per trip at ps
// = 8, compat mode with patch normalisation, counted from the source as
// warp instructions divided by the patches a warp holds (the SASS count
// differs by the address arithmetic):
//   before (one warp per patch, K = 2): about 150 -- the 2x2 solve, policing
//     sqrtf and tap-base ceil/clip on every lane, three 5-level shuffle
//     butterflies (15 shuffles, 15 dependent adds), a runtime division and
//     both column blends per tap;
//   after (four patches per warp, K = 8): about 55 -- per warp 16 products,
//     three sums of 7 in-lane adds plus 3 shuffle levels, one scalar chain
//     for four patches, 18 shared loads and 72 blend operations for the 8
//     taps, 8 mean subtractions and 12 masked updates.
// Measured on the H100 (PERF.md), the finest 1080p scale takes about 2.3x
// its memory bound, down from about 7x.  ncu does not run on the measuring
// machine, so smsp__inst_executed was not read.  Block: 4 warps (16
// patches at ps = 8, 8 at ps = 12), 23.1 KB of shared memory for their
// windows (23.3 KB at ps = 12); the 72 registers of the ps = 8 instance
// (79 in plane mode) limit an SM to 7 such blocks (6), the 96 of the ps =
// 12 instance to 5.  In a sweep on the H100, 64 threads per block ran as
// fast, and 256 threads or a 64-register cap (8 blocks, with spills) ran
// slower.  At ps = 12 the split layout's plane mode ran the 1080p
// PRESET_MEDIUM finest scale in 0.135 ms, against 0.282 with 32 lanes of
// 8 taps (14 of them padding) and 0.146 with one patch a warp (32 lanes
// of 4 taps, an extra tap on lanes 0-15, 64 registers): two patches a
// warp lose lane-trips to early exit, and win more on the scalar chain.  Regions mode stages with 16-byte loads where the warp's regions
// start aligned.  Plane mode stages by 4-byte cp.async, which fly while
// the templates load: a slot's row pitch is rc, odd, which spreads the
// sampler's reads over the shared-memory banks, so a window row's shared
// and plane addresses agree modulo 16 bytes on one row in four, too few
// for 16-byte copies to pay (on the H100 the plane mode at ps 12 ran
// faster than regions mode on K2's regions, copies and all).  Templates
// load and q stores as 16-byte vectors where the rows are aligned (every
// even ps: ps^2 is a multiple of 4).
//
// K1b, the batched form (replaces _run_vmap of the same TPU file, which
// folds the pairs into the block grid): nb pairs are one launch over nb * n
// patches, pair-major.  Every per-pair array is [nb, n, ...] and is read at
// the patch's flat index i = pair * n + patch; the centers are shared by the
// pairs and read at i % n, so no [nb * n, 2] broadcast copy is made per
// scale.  In plane mode the planes are [nb, th, tw] and patch i reads plane
// i / n: a warp may straddle two pairs.  nb = 1 is K1; the math is the same
// lines, so each pair's patches get exactly the bits they get alone.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "dis_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// The lane's K taps [t0, t0 + K) of one patch row of a [.., np] array;
// taps past np read as zero.  vec: the row is 16-byte aligned and np is a
// multiple of 4, so every 4-tap chunk is wholly in or out.
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
    for (int k = 0; k < K; ++k) v[k] = t0 + k < np ? row[t0 + k] : 0.0f;
  }
}

template <int K>
__device__ __forceinline__ void store_taps(float* __restrict__ row, int t0, int np, bool vec,
                                           const float (&v)[K]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < K / 4; ++c) {
      const int t = t0 + 4 * c;
      if (t < np)
        *reinterpret_cast<float4*>(row + t) =
            make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t0 + k < np) row[t0 + k] = v[k];
  }
}

struct Patch {
  const float* reg;  // [rc, rc] in shared memory
  int pad, row0, by, bx;
};

// Whether an instance takes the split layout: G K main taps short of
// ps^2, and lane g also holds the extra tap G K + g (ps^2 = G K + G).
template <int PS, int K, int G>
__host__ __device__ constexpr bool split_layout() {
  return PS > 0 && G * K < PS * PS;
}

// Lane g's fixed offsets in its patch's window, in the split layout: of
// each run of 4 consecutive main taps (one patch row each, PS % 4 == 0),
// and of its extra tap.
template <int K>
struct LaneTaps {
  int run[K / 4];
  int extra;
};

template <int PS, int K, int G>
__device__ __forceinline__ LaneTaps<K> lane_taps(int g) {
  constexpr int rc = 2 * PS + 3;
  LaneTaps<K> L;
#pragma unroll
  for (int r = 0; r < K / 4; ++r) {
    const int t = g * K + 4 * r;
    L.run[r] = t / PS * rc + t % PS;
  }
  const int t = G * K + g;
  L.extra = t / PS * rc + t % PS;
  return L;
}

// The sum over a patch's taps v (main) and, in the split layout, x (the
// extra tap): the group sum of the main taps, plus (the group sum of the
// extra taps + 0.0f) in the split layout, pairwise_sum's tree.
template <int K, int G, bool SPLIT>
__device__ __forceinline__ float tap_sum(const float (&v)[K], float x) {
  const float s = dis_group_sum<K, G>(v);
  if constexpr (!SPLIT) {
    return s;
  } else {
    const float e[1] = {x};
    return s + (dis_group_sum<1, G>(e) + 0.0f);
  }
}

// Bilinear resample of the patch at (px, py) into this lane's taps q (and,
// in the split layout, qx: its extra tap), then (normalize) minus the
// patch mean.  PS > 0: ps is PS; PS = 0: runtime ps.  L: the lane's
// offsets in the split layout.
template <int PS, int K, int G>
__device__ __forceinline__ void sample(const Patch& P, const LaneTaps<K>& L, int ps_rt,
                                       float px, float py, int g, bool normalize,
                                       float inv_ps2, float (&q)[K], float& qx) {
  constexpr bool SPLIT = split_layout<PS, K, G>();
  const int ps = PS > 0 ? PS : ps_rt;
  const int rc = 2 * ps + 3, np = ps * ps, half = ps / 2, span = rc - (ps + 1);
  const float a = px - floorf(px), b = py - floorf(py);
  const float a1 = 1.0f - a, b1 = 1.0f - b;
  const int ws = min(max(dis_ceil_coord(py) + P.pad - P.row0 - half - 1 - P.by, 0), span);
  const int cs = min(max(dis_ceil_coord(px) + P.pad - half - 1 - P.bx, 0), span);
  const float* w = P.reg + ws * rc + cs;
  const int t0 = g * K;
  if constexpr (PS > 0 && PS % K == 0) {
    // The lane's taps are K consecutive taps of patch row j: two region
    // rows of K + 1 values give them all.
    const int j = t0 / PS, i0 = t0 - j * PS;
    const float* r0 = w + j * rc + i0;
    const float* r1 = r0 + rc;
    float x0[K + 1], x1[K + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      x0[k] = r0[k];
      x1[k] = r1[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float c0 = a1 * x0[k] + a * x0[k + 1];
      const float c1 = a1 * x1[k] + a * x1[k + 1];
      q[k] = b1 * c0 + b * c1;
    }
  } else if constexpr (SPLIT) {
    // Each run of 4 taps lies in one patch row: two region rows of 5
    // values give it.
#pragma unroll
    for (int r = 0; r < K / 4; ++r) {
      const float* r0 = w + L.run[r];
      const float* r1 = r0 + rc;
      float x0[5], x1[5];
#pragma unroll
      for (int k = 0; k <= 4; ++k) {
        x0[k] = r0[k];
        x1[k] = r1[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float c0 = a1 * x0[k] + a * x0[k + 1];
        const float c1 = a1 * x1[k] + a * x1[k + 1];
        q[4 * r + k] = b1 * c0 + b * c1;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k;
      q[k] = 0.0f;
      if (t < np) {
        const int j = t / ps, i = t - j * ps;
        const float* r0 = w + j * rc + i;
        const float* r1 = r0 + rc;
        const float c0 = a1 * r0[0] + a * r0[1];
        const float c1 = a1 * r1[0] + a * r1[1];
        q[k] = b1 * c0 + b * c1;
      }
    }
  }
  if constexpr (SPLIT) {
    const float* r0 = w + L.extra;
    const float c0 = a1 * r0[0] + a * r0[1];
    const float c1 = a1 * r0[rc] + a * r0[rc + 1];
    qx = b1 * c0 + b * c1;
  }
  if (normalize) {
    const float m = tap_sum<K, G, SPLIT>(q, qx) * inv_ps2;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t0 + k < np) q[k] = q[k] - m;
    if constexpr (SPLIT) qx = qx - m;
  }
}

// Where the patches' rc x rc windows come from.  Regions mode: K2's
// regions [nb, n, rc, rc] and bases [nb, n].  Plane mode: the padded
// level planes img [nb, th, tw] (first row = global row row0) and the
// starts pos0 [nb, n, 2], from which the kernel takes K2's bases itself.
struct Windows {
  const float* regions;
  const int* base_y;
  const int* base_x;
  const float* img;
  const float* pos0;
  int th, tw;
};

// Plane mode: copies each of the warp's cnt windows (bases by, bx held by
// lane slot * G) from its pair's plane into the warp's shared slots, rc
// floats a row at the slot's pitch rc, by 4-byte cp.async (committed; the
// caller waits).  Element e of a window goes to lane e % 32, whose plane
// offset advances by carries, with no division.  A plane of fewer than rc
// rows or columns clips each index to its last row or column (K2's
// small_kernel); elsewhere the clip never binds and is skipped.
template <int PS, int G>
__device__ __forceinline__ void stage_plane(const Windows& W, float* wreg, long long first,
                                            int cnt, long long n, int ps_rt, int by, int bx,
                                            int lane) {
  const int ps = PS > 0 ? PS : ps_rt;
  const int rc = 2 * ps + 3, rr = rc * rc;
  const int dr = 32 / rc, dc = 32 - dr * rc;   // a step of 32 elements
  const int r0 = lane / rc, c0 = lane - r0 * rc;
  const bool small = W.th < rc || W.tw < rc;
  for (int s = 0; s < cnt; ++s) {               // warp-uniform
    const int sy = __shfl_sync(FULL, by, s * G), sx = __shfl_sync(FULL, bx, s * G);
    const float* plane = W.img + (size_t)((first + s) / n) * W.th * W.tw;
    float* dst = wreg + s * rr;
    if (small) {
      int r = r0, c = c0;
      for (int e = lane; e < rr; e += 32) {
        dis_cp_async4(dst + e, plane + min(sy + r, W.th - 1) * W.tw + min(sx + c, W.tw - 1));
        c += dc;
        r += dr;
        if (c >= rc) {
          c -= rc;
          ++r;
        }
      }
    } else {
      const float* src = plane + (sy + r0) * W.tw + sx + c0;
      int c = c0;
      for (int e = lane; e < rr; e += 32) {
        dis_cp_async4(dst + e, src);
        c += dc;
        src += dr * W.tw + dc;
        if (c >= rc) {
          c -= rc;
          src += W.tw - rc;
        }
      }
    }
  }
  dis_cp_async_commit();
}

template <int PS, int K, int G, bool PLANE>
__global__ void __launch_bounds__(THREADS)
iclk_kernel(Windows win, const float* __restrict__ T, const float* __restrict__ Tdx,
            const float* __restrict__ Tdy, const float* __restrict__ Tn,
            const float* __restrict__ Hinv, const float* __restrict__ centers,
            const float* __restrict__ init_u, const unsigned char* __restrict__ conv0,
            long long total, int n, int ps_rt, int n_iters, int pad, int row0, int width,
            int height, int normalize, int fixed, float thresh, float conv_eps, float inv_ps2,
            int vec, float* __restrict__ u_out, float* __restrict__ q_out,
            unsigned char* __restrict__ conv_out) {
  constexpr int PPW = 32 / G;  // patches per warp
  constexpr bool SPLIT = split_layout<PS, K, G>();
  static_assert(!SPLIT || PS * PS == G * K + G, "the split layout: one extra tap a lane");
  extern __shared__ float smem[];
  const int ps = PS > 0 ? PS : ps_rt;
  const int rc = 2 * ps + 3, rr = rc * rc, np = ps * ps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane & (G - 1), slot = lane / G;
  const long long first = ((long long)blockIdx.x * WARPS + warp) * PPW;
  if (first >= total) return;  // warp-uniform; nothing below syncs the block
  const int cnt = (int)(total - first < PPW ? total - first : PPW);
  float* wreg = smem + warp * PPW * rr;

  // A group past the end mirrors the warp's first patch, frozen, and
  // writes nothing; it only keeps the shuffles' full mask.
  const bool valid = slot < cnt;
  const long long i = first + (valid ? slot : 0);  // pair * n + patch
  const long long c = i % n;                        // the patch's center
  int by, bx;
  if constexpr (PLANE) {
    // K2's bases (extract_group.cuh; extract_regions.cu's small_kernel).
    by = min(max(dis_ceil_coord(win.pos0[2 * i + 1]) + pad - row0 - ps - 2, 0),
             max(win.th - rc, 0));
    bx = min(max(dis_ceil_coord(win.pos0[2 * i]) + pad - ps - 2, 0), max(win.tw - rc, 0));
    stage_plane<PS, G>(win, wreg, first, cnt, n, ps_rt, by, bx, lane);
  } else {
    // Stage the warp's cnt regions (contiguous in device memory).
    const float* greg = win.regions + first * rr;
    const int nreg = cnt * rr;
    if ((reinterpret_cast<uintptr_t>(greg) & 15) == 0 && (nreg & 3) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(greg);
      float4* d4 = reinterpret_cast<float4*>(wreg);
      for (int e = lane; e < nreg / 4; e += 32) d4[e] = __ldg(s4 + e);
    } else {
      for (int e = lane; e < nreg; e += 32) wreg[e] = greg[e];
    }
    by = win.base_y[i];
    bx = win.base_x[i];
  }
  const Patch P{wreg + (valid ? slot : 0) * rr, pad, row0, by, bx};
  const bool v4 = vec != 0;
  const int t0 = g * K;
  const size_t row = (size_t)i * np;
  LaneTaps<K> L{};
  if constexpr (SPLIT) L = lane_taps<PS, K, G>(g);
  const size_t xrow = row + G * K + g;  // the lane's extra tap (split layout)

  float tdx[K], tdy[K], tn[K], q[K];
  float xdx = 0.0f, xdy = 0.0f, xtn = 0.0f, xq = 0.0f;
  load_taps<K>(Tdx + row, t0, np, v4, tdx);
  load_taps<K>(Tdy + row, t0, np, v4, tdy);
  if constexpr (SPLIT) {
    xdx = Tdx[xrow];
    xdy = Tdy[xrow];
  }
  if (fixed) {
    load_taps<K>(Tn + row, t0, np, v4, tn);
    if constexpr (SPLIT) xtn = Tn[xrow];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) tn[k] = 0.0f;
  }
  const float h00 = Hinv[4 * i], h01 = Hinv[4 * i + 1];
  const float h10 = Hinv[4 * i + 2], h11 = Hinv[4 * i + 3];
  const float cx = centers[2 * c], cy = centers[2 * c + 1];
  const float iux = init_u[2 * i], iuy = init_u[2 * i + 1];
  const float sx = cx + iux, sy = cy + iuy;
  const float lb = -(float)ps / 2.0f;
  const float ub_w = (float)(width + ps / 2 - 2), ub_h = (float)(height + ps / 2 - 2);
  // The windows: plane mode's copies flew while the templates loaded.
  if constexpr (PLANE) dis_cp_async_wait_all();
  __syncwarp();

  const bool start_frozen = conv0[i] != 0;
  bool frozen = !valid || start_frozen;
  sample<PS, K, G>(P, L, ps, sx, sy, g, normalize, inv_ps2, q, xq);
  if (start_frozen) {
    load_taps<K>(T + row, t0, np, v4, q);
    if constexpr (SPLIT) xq = T[xrow];
  }

  float ux = iux, uy = iuy;
  for (int it = 0; it < n_iters; ++it) {
    if (!__any_sync(FULL, !frozen)) break;
    float px_[K], py_[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float r = fixed ? q[k] - tn[k] : q[k];
      px_[k] = tdx[k] * r;
      py_[k] = tdy[k] * r;
    }
    const float xr = fixed ? xq - xtn : xq;
    const float rx = tap_sum<K, G, SPLIT>(px_, xdx * xr);
    const float ry = tap_sum<K, G, SPLIT>(py_, xdy * xr);
    const float dx = h00 * rx + h01 * ry;
    const float dy = h10 * rx + h11 * ry;
    const float uxn = ux - dx, uyn = uy - dy;
    const float pxn = cx + uxn, pyn = cy + uyn;
    const float mx = sx - pxn, my = sy - pyn;
    const float dist = sqrtf(mx * mx + my * my);
    const bool policed = dist > thresh || pxn < lb || pyn < lb || pxn > ub_w || pyn > ub_h;
    const float nux = policed ? iux : uxn;
    const float nuy = policed ? iuy : uyn;
    float qn[K], xqn = 0.0f;
    sample<PS, K, G>(P, L, ps, cx + nux, cy + nuy, g, normalize, inv_ps2, qn, xqn);
    if (!frozen) {
      ux = nux;
      uy = nuy;
#pragma unroll
      for (int k = 0; k < K; ++k) q[k] = qn[k];
      xq = xqn;
      frozen = policed || (fixed && sqrtf(dx * dx + dy * dy) < conv_eps);
    }
  }

  if (!valid) return;
  store_taps<K>(q_out + row, t0, np, v4, q);
  if constexpr (SPLIT) q_out[xrow] = xq;
  if (g == 0) {
    u_out[2 * i] = ux;
    u_out[2 * i + 1] = uy;
    conv_out[i] = frozen ? 1 : 0;
  }
}

template <int PS, int K, int G, bool PLANE>
int launch(const Windows& win, const float* T, const float* Tdx, const float* Tdy,
           const float* Tn, const float* Hinv, const float* centers, const float* init_u,
           const unsigned char* conv0, long long total, int n, int ps, int n_iters, int pad,
           int row0, int width, int height, int normalize, int fixed, float thresh,
           float conv_eps, float inv_ps2, int vec, float* u_out, float* q_out,
           unsigned char* conv_out, cudaStream_t stream) {
  constexpr int PPB = WARPS * (32 / G);  // patches per block
  const int rc = 2 * ps + 3;
  const size_t bytes = (size_t)PPB * rc * rc * sizeof(float);
  const long long blocks = (total + PPB - 1) / PPB;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  iclk_kernel<PS, K, G, PLANE><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      win, T, Tdx, Tdy, Tn, Hinv, centers, init_u, conv0, total, n, ps, n_iters, pad, row0,
      width, height, normalize, fixed, thresh, conv_eps, inv_ps2, vec, u_out, q_out, conv_out);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The lane layout the kernel takes for patch size ps: K taps per lane and
// G lanes per patch, G * K the power of two >= ps^2 (K = 8 where G <= 32
// allows it).  Returns 0, or cudaErrorInvalidValue for an odd ps or
// ps^2 > 512 (ops/cuda/iclk_kernel.py::lane_layout is its copy).
extern "C" int dis_iclk_layout(int ps, int* k, int* g) {
  if (ps < 2 || ps % 2 != 0 || ps * ps > 512) return (int)cudaErrorInvalidValue;
  int p = 1;
  while (p < ps * ps) p <<= 1;
  *k = p > 256 ? p / 32 : (p < 8 ? p : 8);
  *g = p / *k;
  return 0;
}

// K1's lane layout for patch size ps (S1 and S3 keep dis_iclk_layout's):
// dis_iclk_layout's, except at ps = 12, the split layout: K = 8, G = 16,
// G K = 128 < ps^2, and each lane also holds one of the 16 taps past G K.
// Returns dis_iclk_layout's status (ops/cuda/iclk_kernel.py::search_layout
// is its copy).
extern "C" int dis_iclk_search_layout(int ps, int* k, int* g) {
  const int err = dis_iclk_layout(ps, k, g);
  if (err == 0 && ps == 12) {
    *k = 8;
    *g = 16;
  }
  return err;
}

namespace {

// K1 or K1b over nb pairs of n patches, the windows from `win`.
template <bool PLANE>
int search(const Windows& win, const float* T, const float* Tdx, const float* Tdy,
           const float* Tn, const float* Hinv, const float* centers, const float* init_u,
           const unsigned char* conv0, int nb, int n, int ps, int n_iters, int pad, int row0,
           int width, int height, int normalize, int fixed, float thresh, float conv_eps,
           float inv_ps2, float* u_out, float* q_out, unsigned char* conv_out,
           cudaStream_t stream) {
  int k = 0, g = 0;
  if (dis_iclk_search_layout(ps, &k, &g) != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nb * n;
  if (total <= 0) return (int)cudaGetLastError();
  const int vec = aligned16(T) && aligned16(Tdx) && aligned16(Tdy) &&
                  (!fixed || aligned16(Tn)) && aligned16(q_out);
#define DIS_ICLK_LAUNCH(PS, KK, GG)                                                           \
  return launch<PS, KK, GG, PLANE>(win, T, Tdx, Tdy, Tn, Hinv, centers, init_u, conv0,       \
                                   total, n, ps, n_iters, pad, row0, width, height,           \
                                   normalize, fixed, thresh, conv_eps, inv_ps2, vec, u_out,   \
                                   q_out, conv_out, stream)
  if (ps == 8) DIS_ICLK_LAUNCH(8, 8, 8);
  if (ps == 10) DIS_ICLK_LAUNCH(10, 8, 16);
  if (ps == 12) DIS_ICLK_LAUNCH(12, 8, 16);
  if (ps == 16) DIS_ICLK_LAUNCH(16, 8, 32);
  if (k == 4 && g == 1) DIS_ICLK_LAUNCH(0, 4, 1);
  if (k == 8 && g == 2) DIS_ICLK_LAUNCH(0, 8, 2);
  if (k == 8 && g == 8) DIS_ICLK_LAUNCH(0, 8, 8);
  if (k == 8 && g == 32) DIS_ICLK_LAUNCH(0, 8, 32);
  if (k == 16 && g == 32) DIS_ICLK_LAUNCH(0, 16, 32);
#undef DIS_ICLK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// nb pairs of n patches.  regions [nb, n, rc, rc]; base_y/base_x [nb, n]
// int32; T/Tdx/Tdy/Tn [nb, n, ps^2] (Tn read only when fixed != 0); Hinv
// [nb, n, 2, 2]; init_u [nb, n, 2]; conv0 [nb, n] bool; centers [n, 2],
// shared by the pairs.  Outputs u [nb, n, 2], q [nb, n, ps^2], conv [nb, n]
// bool.  row0 is the global row of the first row of the plane the regions
// came from.  ps even, ps^2 <= 512.  Returns cudaGetLastError() after the
// launch (nb * n = 0 launches nothing).
extern "C" int dis_iclk_search(const float* regions, const int* base_y, const int* base_x,
                               const float* T, const float* Tdx, const float* Tdy,
                               const float* Tn, const float* Hinv, const float* centers,
                               const float* init_u, const unsigned char* conv0, int nb, int n,
                               int ps, int n_iters, int pad, int row0, int width,
                               int height, int normalize, int fixed, float thresh, float conv_eps,
                               float inv_ps2, float* u_out, float* q_out,
                               unsigned char* conv_out, cudaStream_t stream) {
  const Windows win{regions, base_y, base_x, nullptr, nullptr, 0, 0};
  return search<false>(win, T, Tdx, Tdy, Tn, Hinv, centers, init_u, conv0, nb, n, ps, n_iters,
                       pad, row0, width, height, normalize, fixed, thresh, conv_eps, inv_ps2,
                       u_out, q_out, conv_out, stream);
}

// The same search in plane mode: each patch's window comes from img [nb,
// th, tw], the padded level planes whose first row is global row row0,
// at K2's base from pos0 [nb, n, 2], the starts; no regions, no bases.
// The other arguments are dis_iclk_search's.  th * tw <= INT_MAX.
extern "C" int dis_iclk_search_plane(const float* img, int th, int tw, const float* pos0,
                                     const float* T, const float* Tdx, const float* Tdy,
                                     const float* Tn, const float* Hinv, const float* centers,
                                     const float* init_u, const unsigned char* conv0, int nb,
                                     int n, int ps, int n_iters, int pad, int row0, int width,
                                     int height, int normalize, int fixed, float thresh,
                                     float conv_eps, float inv_ps2, float* u_out, float* q_out,
                                     unsigned char* conv_out, cudaStream_t stream) {
  if (th < 1 || tw < 1 || (long long)th * tw > INT_MAX) return (int)cudaErrorInvalidValue;
  const Windows win{nullptr, nullptr, nullptr, img, pos0, th, tw};
  return search<true>(win, T, Tdx, Tdy, Tn, Hinv, centers, init_u, conv0, nb, n, ps, n_iters,
                      pad, row0, width, height, normalize, fixed, thresh, conv_eps, inv_ps2,
                      u_out, q_out, conv_out, stream);
}
