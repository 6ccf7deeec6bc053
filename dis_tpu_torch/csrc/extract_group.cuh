// Device code shared by K2/K2b (extract_regions.cu) and K2c
// (extract_banded.cu): per-patch sampling regions, a group of patches of
// one grid column per step of a block.
//
// The function: for each (pair, patch), the rc x rc window (rc = 2 ps + 3)
// of the padded level plane at
//   base = clip(ceil(pos0 + 1e-5f) + pad - ps - 2, 0, dim - rc)
// (a stripe's row0 subtracted from y only), and the bases.  A pure copy,
// bound by bytes on the H100: it writes n x rc^2 floats (479 MB at the 4K
// finest scale) and reads the plane.  Equal bitwise to the plain version.
//
// The patches are x-outer, so a grid column is contiguous.  A column of
// num_h patches is cut into ceil(num_h / GROUP) groups of one size, the
// column's share rounded up to a multiple of 4 (the last group takes the
// rest); K2 without a column length takes the pair's n patches as one
// column, so its groups may straddle two columns.  A persistent block
// walks groups with a stride of the grid, STAGES of them in flight:
//   prepare(group g + (STAGES - 1) * grid): one thread per patch, spread
//     over all warps, computes and writes its bases; a min/max reduction
//     (order-free, exact, no atomics) gives the group's bounding box; the
//     block stages it into the group's stage by cp.async: 16 bytes a copy
//     where the plane rows are 16-byte aligned (tw % 4 == 0 and an aligned
//     plane; the box's left edge is aligned down and its pitch up to 4
//     floats, which never passes tw), else 4 bytes;
//   write(group g), while those copies fly: the group's regions are one
//     contiguous span of cnt x rc^2 floats.  Its 16-byte-aligned body is
//     written as float4 with streaming stores (__stcs: evict-first, so the
//     region stream does not push the plane out of L2), its ragged head and
//     tail (at most 3 floats each) as scalars.  Four consecutive patches
//     hold exactly rc^2 float4, so a table of rc^2 entries, built once per
//     block, maps a float4 to the (patch, row, col) of its four floats; the
//     loop advances (quad, entry) by carries, with no division.  A float4
//     whose floats lie in one staged window (all but under 1%) reads that
//     window's tile offset once.
// A stage holds at most STAGE_FLOATS floats, a fixed cap (the same for
// every launch, so a launch stays capturable in a CUDA graph) that holds a
// 48-patch group's box at stride 5 and ps 8 with up to 16 px of flow spread
// in y and 8 in x; two stages and the table leave MIN_BLOCKS blocks of
// THREADS threads on an SM (on the H100, fewer larger groups ran faster
// than more blocks of smaller ones: the per-group steps cost more than the
// occupancy gains).  A box larger than the cap is staged in part (its first rows); a
// patch whose window is not wholly in the staged part is copied from device
// memory, so the result never depends on the cap (and is counted in
// *outside when a counter is given).  Offsets into the regions are 64-bit;
// into one plane 32-bit (checked).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "dis_common.cuh"

namespace {
namespace dis_extract {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 48;             // patches per group, at most
constexpr int STAGES = 2;
constexpr int STAGE_FLOATS = 9216;    // 36 KB of plane per stage
constexpr int MIN_BLOCKS = 2;         // per SM: registers <= 128 a thread
constexpr int MAX_RC = 63;            // a table field keeps row and col in 6 bits
constexpr int HDR = 1;                // ints per stage: the tile's pitch
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* img;     // [nb, th, tw] padded planes, first row = global row row0
  int th, tw;
  const float* pos0;    // [nb, n, 2] (x, y), n = num_w * num_h, x-outer
  int nb, num_w, num_h, ps, pad, row0;
  float* regions;       // [nb, n, rc, rc], 16-byte aligned
  int* base_y;          // [nb, n]
  int* base_x;
  int* outside;         // null, or a counter of windows copied from device memory
};

// Dynamic shared memory of a block: the stages, the table, and per stage
// the header, each patch's tile and plane offsets and the warps' partial
// boxes.
inline size_t shared_bytes(int rc) {
  return (size_t)STAGES * STAGE_FLOATS * sizeof(float) + (size_t)rc * rc * sizeof(uint2)
         + (size_t)STAGES * (HDR + 2 * GROUP + 4 * WARPS) * sizeof(int);
}

// Groups of a column of num_h patches, and their size.
__host__ __device__ __forceinline__ int groups_per_column(int num_h) {
  return (num_h + GROUP - 1) / GROUP;
}

__device__ __forceinline__ int group_size(int num_h, int per_col) {
  return ((num_h + per_col - 1) / per_col + 3) & ~3;
}

struct Group {
  int pair, first, cnt;
  long long p0;         // flat index (pair * n + patch) of the group's first patch
};

__device__ __forceinline__ Group decode(long long g, const Args& a, int per_col, int size) {
  const long long per_pair = (long long)a.num_w * per_col;
  Group G;
  G.pair = (int)(g / per_pair);
  const long long rem = g - (long long)G.pair * per_pair;
  const int col = (int)(rem / per_col);
  G.first = (int)(rem - (long long)col * per_col) * size;
  G.cnt = min(size, a.num_h - G.first);
  G.p0 = ((long long)G.pair * a.num_w + col) * a.num_h + G.first;
  return G;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  // L2::128B: the L2 fetches the copy's whole 128-byte line, which the
  // box's next copies of the row read.
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bases of group G, its box, and the cp.async copies that stage the box
// into `tile` (committed as one batch of copies by every thread).
__device__ __forceinline__ void prepare(const Args& a, const Group& G, bool vec, float* tile,
                                        int* hdr, int* sb, int* gb, int* red) {
  const int rc = 2 * a.ps + 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane * WARPS + warp;   // patch t: lane t / WARPS of warp t % WARPS
  int by = 0, bx = 0;
  int ylo = INT_MAX, xlo = INT_MAX, yhi = INT_MIN, xhi = INT_MIN;
  if (t < G.cnt) {
    const long long i = G.p0 + t;
    by = min(max(dis_ceil_coord(a.pos0[2 * i + 1]) + a.pad - a.row0 - a.ps - 2, 0), a.th - rc);
    bx = min(max(dis_ceil_coord(a.pos0[2 * i]) + a.pad - a.ps - 2, 0), a.tw - rc);
    a.base_y[i] = by;
    a.base_x[i] = bx;
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
    red[4 * warp] = ylo;
    red[4 * warp + 1] = xlo;
    red[4 * warp + 2] = yhi;
    red[4 * warp + 3] = xhi;
  }
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    ylo = min(ylo, red[4 * w]);
    xlo = min(xlo, red[4 * w + 1]);
    yhi = max(yhi, red[4 * w + 2]);
    xhi = max(xhi, red[4 * w + 3]);
  }
  // The box, its left edge aligned down to 16 bytes and its pitch up to a
  // multiple of 4 floats on the vector path (so xa + pitch <= tw); its rows
  // cut to the cap.
  const int y0 = ylo;
  const int xa = vec ? (xlo & ~3) : xlo;
  const int pitch = vec ? ((xhi + rc - xa + 3) & ~3) : xhi + rc - xa;
  int rows = min(yhi + rc - y0, STAGE_FLOATS / pitch);
  if (rows < rc) rows = 0;
  if (t < G.cnt) {
    const bool in = by - y0 + rc <= rows;
    sb[t] = in ? (by - y0) * pitch + bx - xa : -1;
    gb[t] = by * a.tw + bx;
    if (!in && a.outside != nullptr) atomicAdd(a.outside, 1);
  }
  if (threadIdx.x == 0) hdr[0] = pitch;
  // Stage: `w` slots a row (float4 or float), walked with carries.
  const float* plane = a.img + (size_t)G.pair * a.th * a.tw + (size_t)y0 * a.tw + xa;
  const int w = vec ? pitch >> 2 : pitch;
  const int total = rows * w;
  if ((int)threadIdx.x < total) {
    int r = threadIdx.x / w, c = threadIdx.x - r * w;
    const int dr = THREADS / w, dc = THREADS - dr * w;
    for (int s = threadIdx.x; s < total; s += THREADS) {
      const float* src = plane + (size_t)r * a.tw;
      float* dst = tile + r * pitch;
      if (vec) {
        cp_async16(dst + 4 * c, src + 4 * c);
      } else {
        dis_cp_async4(dst + c, src + c);
      }
      c += dc;
      r += dr;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
  }
  dis_cp_async_commit();
}

// The value of element (r, c) of local patch t's window: from the staged
// tile, or from device memory where the window is not wholly staged.
__device__ __forceinline__ float window_value(const float* tile, const float* plane, int pitch,
                                              int tw, const int* sb, const int* gb, int t, int r,
                                              int c) {
  const int s = sb[t];
  return s >= 0 ? tile[s + r * pitch + c] : plane[gb[t] + r * tw + c];
}

__device__ __forceinline__ float table_value(unsigned f, int lq, const float* tile,
                                             const float* plane, int pitch, int tw, const int* sb,
                                             const int* gb) {
  return window_value(tile, plane, pitch, tw, sb, gb, lq + (int)(f >> 12), (f >> 6) & 63, f & 63);
}

// Writes group G's regions (one contiguous span) from its staged tile.
__device__ __forceinline__ void write_group(const Args& a, const Group& G, const float* tile,
                                            const uint2* table, const int* hdr, const int* sb,
                                            const int* gb) {
  const int rc = 2 * a.ps + 3, rc2 = rc * rc;
  const int pitch = hdr[0];
  const float* plane = a.img + (size_t)G.pair * a.th * a.tw;
  const unsigned long long f0 = (unsigned long long)G.p0 * rc2;
  const unsigned long long f1 = f0 + (unsigned long long)G.cnt * rc2;
  const unsigned long long m0 = (f0 + 3) >> 2, m1 = f1 >> 2;   // the float4 body [m0, m1)
  if (threadIdx.x < 6) {   // the ragged head [f0, 4 m0) and tail [4 m1, f1)
    const unsigned long long f = threadIdx.x < 3 ? f0 + threadIdx.x : 4 * m1 + threadIdx.x - 3;
    if (threadIdx.x < 3 ? f < 4 * m0 : f < f1) {
      const int lf = (int)(f - f0), t = lf / rc2, e = lf - t * rc2, r = e / rc;
      __stcs(a.regions + f, window_value(tile, plane, pitch, a.tw, sb, gb, t, r, e - r * rc));
    }
  }
  unsigned long long m = m0 + threadIdx.x;
  if (m >= m1) return;
  // Float4 m holds floats [4m, 4m + 4): entry q = m % rc2 of the quad of
  // patches [4 (m / rc2), 4 (m / rc2) + 4); lq is that quad's first patch
  // relative to the group.
  const unsigned long long quad = m / rc2;
  int q = (int)(m - quad * rc2);
  int lq = (int)((long long)(4 * quad) - G.p0);
  const int dquad = THREADS / rc2, dq = THREADS - dquad * rc2;
  float4* out = reinterpret_cast<float4*>(a.regions);
  for (; m < m1; m += THREADS) {
    const uint2 e = table[q];
    float4 v;
    const int t0 = lq + (int)((e.x >> 12) & 3u);   // the patch of the first float
    const int s = sb[t0];
    if (t0 == lq + (int)(e.y >> 28) && s >= 0) {   // one patch, staged
      const float* win = tile + s;
      v.x = win[(int)((e.x >> 6) & 63u) * pitch + (int)(e.x & 63u)];
      v.y = win[(int)((e.x >> 22) & 63u) * pitch + (int)((e.x >> 16) & 63u)];
      v.z = win[(int)((e.y >> 6) & 63u) * pitch + (int)(e.y & 63u)];
      v.w = win[(int)((e.y >> 22) & 63u) * pitch + (int)((e.y >> 16) & 63u)];
    } else {
      v.x = table_value(e.x & 0xffffu, lq, tile, plane, pitch, a.tw, sb, gb);
      v.y = table_value(e.x >> 16, lq, tile, plane, pitch, a.tw, sb, gb);
      v.z = table_value(e.y & 0xffffu, lq, tile, plane, pitch, a.tw, sb, gb);
      v.w = table_value(e.y >> 16, lq, tile, plane, pitch, a.tw, sb, gb);
    }
    __stcs(out + m, v);
    q += dq;
    lq += 4 * dquad;
    if (q >= rc2) {
      q -= rc2;
      lq += 4;
    }
  }
}

__device__ __forceinline__ void extract_groups(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rc = 2 * a.ps + 3, rc2 = rc * rc;
  float* tiles = reinterpret_cast<float*>(smem);                   // [STAGES][STAGE_FLOATS]
  uint2* table = reinterpret_cast<uint2*>(tiles + STAGES * STAGE_FLOATS);   // [rc2]
  int* hdr = reinterpret_cast<int*>(table + rc2);                  // [STAGES][HDR]
  int* sb = hdr + STAGES * HDR;                                    // [STAGES][GROUP]
  int* gb = sb + STAGES * GROUP;                                   // [STAGES][GROUP]
  int* red = gb + STAGES * GROUP;                                  // [STAGES][WARPS][4]

  // Table entry q: for each float k of float4 q of a quad, the field
  // patch << 12 | row << 6 | col of float 4q + k.
  for (int q = threadIdx.x; q < rc2; q += THREADS) {
    unsigned f[4];
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * q + k, t = e / rc2, r = (e - t * rc2) / rc;
      f[k] = (unsigned)(t << 12 | r << 6 | (e - t * rc2 - r * rc));
    }
    table[q] = make_uint2(f[0] | f[1] << 16, f[2] | f[3] << 16);
  }

  const int per_col = groups_per_column(a.num_h);
  const int size = group_size(a.num_h, per_col);
  const long long groups = (long long)a.nb * a.num_w * per_col;
  const bool vec = (a.tw & 3) == 0 && (reinterpret_cast<uintptr_t>(a.img) & 15) == 0;
  if ((long long)blockIdx.x >= groups) return;
  // Block b takes groups b, b + gridDim.x, ...; the i-th of them uses
  // stage i % STAGES.  Each iteration commits one batch of copies (empty
  // past the last group), so waiting for all but the newest STAGES - 1
  // batches means the current group's copies have landed.
  auto stage = [&](long long g, int s) {
    if (g < groups)
      prepare(a, decode(g, a, per_col, size), vec, tiles + s * STAGE_FLOATS, hdr + s * HDR,
              sb + s * GROUP, gb + s * GROUP, red + s * 4 * WARPS);
    else
      dis_cp_async_commit();
  };
  const long long step = gridDim.x;
  for (int s = 0; s < STAGES - 1; ++s) stage(blockIdx.x + s * step, s);
  int st = 0;
  for (long long g = blockIdx.x; g < groups; g += step) {
    stage(g + (STAGES - 1) * step, st == 0 ? STAGES - 1 : st - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    write_group(a, decode(g, a, per_col, size), tiles + st * STAGE_FLOATS, table,
                hdr + st * HDR, sb + st * GROUP, gb + st * GROUP);
    __syncthreads();        // stage st is the one the next iteration's copies fill
    st = st + 1 == STAGES ? 0 : st + 1;
  }
}

// Blocks of K an SM holds for region size rc (from the occupancy
// calculator) and the SM count, once per device and rc: the first launch
// runs eagerly, before any stream capture.  The first call on a device
// also lets K take the dynamic shared memory of the largest region, once:
// setting it per rc would lower it for a larger rc set before.
template <void (*K)(Args)>
int occupancy(int rc, int* per_sm, int* sms) {
  static int sm_count[64] = {0};
  static int blocks[64][MAX_RC + 1] = {{0}};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared_bytes(MAX_RC));
    if (err != cudaSuccess) return (int)err;
    sm_count[dev] = count;
  }
  if (blocks[dev][rc] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[dev][rc], K, THREADS,
                                                        shared_bytes(rc));
    if (err != cudaSuccess) return (int)err;
    if (blocks[dev][rc] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  *per_sm = blocks[dev][rc];
  *sms = sm_count[dev];
  return 0;
}

// Launches K over every group: a persistent grid of at most as many blocks
// as the card holds at once.  Returns cudaGetLastError() after the launch.
template <void (*K)(Args)>
int launch(const Args& a, cudaStream_t stream) {
  const int rc = 2 * a.ps + 3;
  if (a.ps < 1 || rc > MAX_RC || a.nb < 0 || a.th < rc || a.tw < rc
      || (long long)a.th * a.tw > INT_MAX
      || (reinterpret_cast<uintptr_t>(a.regions) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (a.nb == 0 || a.num_w <= 0 || a.num_h <= 0) return (int)cudaGetLastError();
  int per_sm = 0, sms = 0;
  const int err = occupancy<K>(rc, &per_sm, &sms);
  if (err != 0) return err;
  const long long groups = (long long)a.nb * a.num_w * groups_per_column(a.num_h);
  const long long most = (long long)per_sm * sms;
  K<<<(unsigned)(groups < most ? groups : most), THREADS, shared_bytes(rc), stream>>>(a);
  return (int)cudaGetLastError();
}

// THREADS, GROUP, STAGES, STAGE_FLOATS, MIN_BLOCKS, the shared bytes for
// ps and the blocks an SM holds into out[7].
template <void (*K)(Args)>
int layout(int ps, int* out) {
  const int rc = 2 * ps + 3;
  if (ps < 1 || rc > MAX_RC) return (int)cudaErrorInvalidValue;
  int sms = 0;
  out[0] = THREADS;
  out[1] = GROUP;
  out[2] = STAGES;
  out[3] = STAGE_FLOATS;
  out[4] = MIN_BLOCKS;
  out[5] = (int)shared_bytes(rc);
  return occupancy<K>(rc, &out[6], &sms);
}

}  // namespace dis_extract
}  // namespace
