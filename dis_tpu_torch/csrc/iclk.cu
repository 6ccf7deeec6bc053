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
// A frozen patch never changes, so leaving its loop at once is
// output-identical to running the full trip count.
//
// One warp per patch.  The region (rc^2 floats, rc = 2 ps + 3) sits in
// shared memory; lane L holds taps [L K, L K + K) of Tdx, Tdy, Tn and q in
// registers, where 32 K is the power of two >= ps^2 (taps past ps^2 are
// zero).  Every sum over taps is an in-lane pair tree followed by a xor
// butterfly over lanes 1, 2, 4, 8, 16: that is the pair tree of
// ops/iclk.py::pairwise_sum, and float addition is commutative, so every
// lane holds the same bits and the kernel equals the plain PyTorch version
// bitwise (the build passes -fmad=false).
//
// Bound on the H100: issue latency of the dependent iteration chain (two
// butterflies, a 2x2 solve, a resample per trip), not memory: each patch
// reads about 1.4 KB of region and 0.8 KB of templates once (ps = 8).
// Patches are independent, so 82,944 warps at the finest 1080p scale keep
// every SM's schedulers busy.  The TPU kernel's lane packing, rolls and
// samplers have no counterpart here.
//
// K1b, the batched form (replaces _run_vmap of the same TPU file, which
// folds the pairs into the block grid): nb pairs are one launch over
// nb * n warps, pair-major.  Every per-pair array is [nb, n, ...] and is
// read at the warp's flat index g = pair * n + patch; the centers are shared
// by the pairs and read at g % n, so no [nb * n, 2] broadcast copy is made
// per scale.  nb = 1 is K1; the math is the same lines, so each pair's
// patches get exactly the bits they get alone.

#include <cuda_runtime.h>

#include "dis_common.cuh"

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <int K>
__device__ __forceinline__ float warp_tree_sum(const float (&v)[K]) {
  float t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = v[k];
#pragma unroll
  for (int width = K; width > 1; width >>= 1) {
#pragma unroll
    for (int k = 0; k < width / 2; ++k) t[k] = t[2 * k] + t[2 * k + 1];
  }
  float s = t[0];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) s = s + __shfl_xor_sync(FULL, s, off);
  return s;
}

struct Patch {
  const float* reg;  // [rc, rc] in shared memory
  int rc, ps, pad, row0, by, bx;
};

// Bilinear resample of the patch at (px, py) into this lane's taps.
template <int K>
__device__ __forceinline__ void sample(const Patch& P, float px, float py, int lane,
                                       bool normalize, float inv_ps2, float (&q)[K]) {
  const int ps = P.ps, half = ps / 2, span = P.rc - (ps + 1);
  const float a = px - floorf(px), b = py - floorf(py);
  const float a1 = 1.0f - a, b1 = 1.0f - b;
  const int ws = min(max(dis_ceil_coord(py) + P.pad - P.row0 - half - 1 - P.by, 0), span);
  const int cs = min(max(dis_ceil_coord(px) + P.pad - half - 1 - P.bx, 0), span);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane * K + k;
    q[k] = 0.0f;
    if (t < ps * ps) {
      const int j = t / ps, i = t - j * ps;
      const float* r0 = P.reg + (ws + j) * P.rc + cs + i;
      const float* r1 = r0 + P.rc;
      const float c0 = a1 * r0[0] + a * r0[1];
      const float c1 = a1 * r1[0] + a * r1[1];
      q[k] = b1 * c0 + b * c1;
    }
  }
  if (normalize) {
    const float m = warp_tree_sum<K>(q) * inv_ps2;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane * K + k < ps * ps) q[k] = q[k] - m;
  }
}

template <int K>
__global__ void iclk_kernel(const float* __restrict__ regions, const int* __restrict__ base_y,
                            const int* __restrict__ base_x, const float* __restrict__ T,
                            const float* __restrict__ Tdx, const float* __restrict__ Tdy,
                            const float* __restrict__ Tn, const float* __restrict__ Hinv,
                            const float* __restrict__ centers, const float* __restrict__ init_u,
                            const unsigned char* __restrict__ conv0, long long total, int n,
                            int ps, int n_iters, int pad, int row0, int width, int height,
                            int normalize,
                            int fixed, float thresh, float conv_eps, float inv_ps2,
                            float* __restrict__ u_out, float* __restrict__ q_out,
                            unsigned char* __restrict__ conv_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * (blockDim.x >> 5) + warp;  // pair * n + patch
  if (i >= total) return;
  const long long c = i % n;  // the patch's center, shared by the pairs
  const int rc = 2 * ps + 3, np = ps * ps;

  float* reg = smem + warp * rc * rc;
  const float* greg = regions + (size_t)i * rc * rc;
  for (int e = lane; e < rc * rc; e += 32) reg[e] = greg[e];
  __syncwarp();
  const Patch P{reg, rc, ps, pad, row0, base_y[i], base_x[i]};

  float tdx[K], tdy[K], tn[K], q[K];
  const size_t row = (size_t)i * np;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane * K + k;
    const bool ok = t < np;
    tdx[k] = ok ? Tdx[row + t] : 0.0f;
    tdy[k] = ok ? Tdy[row + t] : 0.0f;
    tn[k] = (ok && fixed) ? Tn[row + t] : 0.0f;
  }
  const float h00 = Hinv[4 * i], h01 = Hinv[4 * i + 1];
  const float h10 = Hinv[4 * i + 2], h11 = Hinv[4 * i + 3];
  const float cx = centers[2 * c], cy = centers[2 * c + 1];
  const float iux = init_u[2 * i], iuy = init_u[2 * i + 1];
  const float sx = cx + iux, sy = cy + iuy;
  const float lb = -(float)ps / 2.0f;
  const float ub_w = (float)(width + ps / 2 - 2), ub_h = (float)(height + ps / 2 - 2);

  bool frozen = conv0[i] != 0;
  if (frozen) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = lane * K + k;
      q[k] = t < np ? T[row + t] : 0.0f;
    }
  } else {
    sample<K>(P, sx, sy, lane, normalize, inv_ps2, q);
  }

  float ux = iux, uy = iuy;
  for (int it = 0; it < n_iters && !frozen; ++it) {
    float px_[K], py_[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float r = fixed ? q[k] - tn[k] : q[k];
      px_[k] = tdx[k] * r;
      py_[k] = tdy[k] * r;
    }
    const float rx = warp_tree_sum<K>(px_);
    const float ry = warp_tree_sum<K>(py_);
    const float dx = h00 * rx + h01 * ry;
    const float dy = h10 * rx + h11 * ry;
    const float uxn = ux - dx, uyn = uy - dy;
    const float pxn = cx + uxn, pyn = cy + uyn;
    const float mx = sx - pxn, my = sy - pyn;
    const float dist = sqrtf(mx * mx + my * my);
    const bool policed = dist > thresh || pxn < lb || pyn < lb || pxn > ub_w || pyn > ub_h;
    ux = policed ? iux : uxn;
    uy = policed ? iuy : uyn;
    sample<K>(P, cx + ux, cy + uy, lane, normalize, inv_ps2, q);
    frozen = policed || (fixed && sqrtf(dx * dx + dy * dy) < conv_eps);
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane * K + k;
    if (t < np) q_out[row + t] = q[k];
  }
  if (lane == 0) {
    u_out[2 * i] = ux;
    u_out[2 * i + 1] = uy;
    conv_out[i] = frozen ? 1 : 0;
  }
}

template <int K>
int launch(const float* regions, const int* base_y, const int* base_x, const float* T,
           const float* Tdx, const float* Tdy, const float* Tn, const float* Hinv,
           const float* centers, const float* init_u, const unsigned char* conv0, long long total,
           int n, int ps, int n_iters, int pad, int row0, int width, int height, int normalize,
           int fixed, float thresh, float conv_eps, float inv_ps2, float* u_out, float* q_out,
           unsigned char* conv_out, cudaStream_t stream) {
  const int rc = 2 * ps + 3;
  const int region_bytes = rc * rc * (int)sizeof(float);
  const int warps = std::max(1, std::min(8, (48 * 1024) / region_bytes));
  const unsigned blocks = (unsigned)((total + warps - 1) / warps);
  iclk_kernel<K><<<blocks, warps * 32, warps * region_bytes, stream>>>(
      regions, base_y, base_x, T, Tdx, Tdy, Tn, Hinv, centers, init_u, conv0, total, n, ps,
      n_iters, pad, row0, width, height, normalize, fixed, thresh, conv_eps, inv_ps2, u_out,
      q_out, conv_out);
  return (int)cudaGetLastError();
}

}  // namespace

// nb pairs of n patches.  regions [nb, n, rc, rc]; base_y/base_x [nb, n]
// int32; T/Tdx/Tdy/Tn [nb, n, ps^2] (Tn read only when fixed != 0); Hinv
// [nb, n, 2, 2]; init_u [nb, n, 2]; conv0 [nb, n] bool; centers [n, 2],
// shared by the pairs.  Outputs u [nb, n, 2], q [nb, n, ps^2], conv [nb, n]
// bool.  row0 is the global row of the first row of the plane the regions
// came from.  ps^2 <= 512.  Returns cudaGetLastError() after the launch
// (nb * n = 0 launches nothing).
extern "C" int dis_iclk_search(const float* regions, const int* base_y, const int* base_x,
                               const float* T, const float* Tdx, const float* Tdy,
                               const float* Tn, const float* Hinv, const float* centers,
                               const float* init_u, const unsigned char* conv0, int nb, int n,
                               int ps, int n_iters, int pad, int row0, int width,
                               int height, int normalize, int fixed, float thresh, float conv_eps,
                               float inv_ps2, float* u_out, float* q_out,
                               unsigned char* conv_out, cudaStream_t stream) {
  const long long total = (long long)nb * n;
  if (total <= 0) return (int)cudaGetLastError();
  const int np = ps * ps;
#define DIS_ICLK_LAUNCH(KK)                                                                   \
  return launch<KK>(regions, base_y, base_x, T, Tdx, Tdy, Tn, Hinv, centers, init_u, conv0, \
                    total, n, ps, n_iters, pad, row0, width, height, normalize, fixed, thresh, \
                    conv_eps, inv_ps2, u_out, q_out, conv_out, stream)
  if (np <= 32) DIS_ICLK_LAUNCH(1);
  if (np <= 64) DIS_ICLK_LAUNCH(2);
  if (np <= 128) DIS_ICLK_LAUNCH(4);
  if (np <= 256) DIS_ICLK_LAUNCH(8);
  if (np <= 512) DIS_ICLK_LAUNCH(16);
#undef DIS_ICLK_LAUNCH
  return (int)cudaErrorInvalidValue;
}
