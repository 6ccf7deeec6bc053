// S1-S4: each scale's device work around the search, one launch each per
// scale.
//
// No Pallas kernel backs these: on the TPU this work is jnp code that XLA
// fuses into a few loops per scale.  They replace those fusions:
//   S1 dis_scale_templates  the templates, their Hessians' inverses and
//                           fixed mode's mean-normalized template
//                           (dis_tpu/ops/iclk.py:155 extract_templates_grid,
//                           :346 _templates_from_taps, :355
//                           _templates_from_hessian, :635-637 Tn);
//   S2 dis_search_start     the x2 nearest-neighbour init from the coarser
//                           flow and the start test (dis_tpu/ops/grid.py:52
//                           init_from_coarser_flow, dis_tpu/ops/iclk.py:639-646);
//   S3 dis_fixed_weights    fixed mode's densification weights
//                           (dis_tpu/models/dis.py:27 _fixed_weights);
//   S4 dis_densify          densification (dis_tpu/ops/densify.py:58-108).
// Their plain versions are templates_plain and search_start_plain in
// dis_tpu_torch/ops/iclk.py, fixed_weights_plain and densify_plain in
// dis_tpu_torch/ops/densify.py.  Each kernel keeps the plain version's
// operations, one float32 rounding per operation and in its order (the
// build passes -fmad=false, so a product is rounded before it is summed);
// a sum over a patch's taps is dis_group_sum's pair tree (dis_common.cuh),
// which is pairwise_sum's; 1 / x is the correctly rounded reciprocal
// (__frcp_rn: Tensor.__rtruediv__ is reciprocal then * 1.0) and a tensor
// division __fdiv_rn.  So each kernel equals its plain version bitwise.
//
// Layouts.  S1 and S3 work on patches [nb, n, ps^2] with K1's lane layout
// (dis_iclk_layout in iclk.cu: a group of G lanes a patch, K consecutive
// taps a lane, G K the power of two >= ps^2, taps past ps^2 zero), so a
// group's pair-tree sums are dis_group_sum's; a warp holds 32 / G patches
// (four at ps 8).  Patches are x-outer (patch = ix * num_h + iy) and a
// template's taps row-major (tap = j * ps + i reads the plane at row
// y0 + iy * steps + j, column x0 + ix * steps + i; a stripe's row0 is
// already in y0).  S2 takes a thread per patch, S4 a block per output row
// and a thread per output pixel: out[b, y, x] sums, for each covering grid
// column in cover_cols order, that column's covering grid rows in
// cover_rows order, the zero row and column (index num_h, num_w) included
// as the zero they are, as densify_plain's row pass then column pass add
// them.
//
// Bound on the H100: memory.  At the 1080p finest scale (82,944 patches of
// ps 8 on level planes of 1104 x 1936): S1 reads the three planes (25.6 MB)
// and writes three templates of 64 taps a patch and the inverses (65 MB);
// S3 reads Q and T (42.5 MB); S4 writes the 1080p flow (16.6 MB) and reads
// the uniform weight plane (8.3 MB); S2 moves about 2 MB and is bound by
// its launch.  The arithmetic is a few operations per byte at most, far
// under the card's 67 TFLOP/s.  The planes' overlapping windows (stride 5
// under ps 8) come from L1 and L2, so device memory sees each about once;
// templates are written as 16-byte vectors.  S4's block sums each output
// row's covering grid rows once into shared memory and writes the row's
// flow as 8-byte pairs.  Measured there (H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 1f): S1 0.057, S2 0.003, S3 0.014, S4 0.018 ms, 48%,
// 28%, 90% and 43% of those bounds; S1's lanes read 8-tap rows of patches
// 5 rows apart, so a load instruction touches about 17 sectors.

#include <cuda_runtime.h>

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

// ---------------------------------------------------------------------------
// S1: planes img, dx, dy [nb, th, tw]; writes T, Tdx, Tdy [nb, n, ps^2],
// hinv [nb, n, 2, 2] and, where residual, tn [nb, n, ps^2].
template <int K, int G>
__global__ void __launch_bounds__(THREADS)
templates_kernel(const float* __restrict__ img, const float* __restrict__ dx,
                 const float* __restrict__ dy, int th, int tw, long long total, int n,
                 int num_h, int steps, int y0, int x0, int ps, int residual, float inv_ps2,
                 float* __restrict__ T, float* __restrict__ Tdx, float* __restrict__ Tdy,
                 float* __restrict__ hinv, float* __restrict__ tn) {
  const Lane<G> lane;
  const bool valid = lane.slot < total;
  const long long i = valid ? lane.slot : 0;
  const long long pair = i / n;
  const int patch = (int)(i - pair * n);
  const int ix = patch / num_h, iy = patch - ix * num_h;
  const float* src_img = img + pair * th * tw;
  const float* src_dx = dx + pair * th * tw;
  const float* src_dy = dy + pair * th * tw;
  const int ry = y0 + iy * steps, rx = x0 + ix * steps;
  const int np = ps * ps;
  const int t0 = lane.g * K;
  float t[K], gx[K], gy[K], xx[K], xy[K], yy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int tap = t0 + k;
    t[k] = gx[k] = gy[k] = 0.0f;
    if (tap < np) {
      const int j = tap / ps;
      const long long off = (long long)(ry + j) * tw + rx + (tap - j * ps);
      t[k] = __ldg(src_img + off);
      gx[k] = __ldg(src_dx + off);
      gy[k] = __ldg(src_dy + off);
    }
    xx[k] = gx[k] * gx[k];
    xy[k] = gx[k] * gy[k];
    yy[k] = gy[k] * gy[k];
  }
  float a = dis_group_sum<K, G>(xx);
  const float b = dis_group_sum<K, G>(xy);
  float c = dis_group_sum<K, G>(yy);
  if (valid) {
    store_taps<K>(T + i * np, t0, np, t);
    store_taps<K>(Tdx + i * np, t0, np, gx);
    store_taps<K>(Tdy + i * np, t0, np, gy);
  }
  if (residual) {  // uniform across the launch: every lane joins the sum
    const float m = dis_group_sum<K, G>(t) * inv_ps2;
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = t[k] - m;
    if (valid) store_taps<K>(tn + i * np, t0, np, t);
  }
  if (valid && lane.g == 0) {
    // templates_from_hessian: the det == 0 guard adds 1e-10 to a and c,
    // +0.0 elsewhere; then the inverse from the recomputed determinant.
    const float det0 = a * c - b * b;
    const float guard = det0 == 0.0f ? 1e-10f : 0.0f;
    a = a + guard;
    c = c + guard;
    const float inv_det = __frcp_rn(a * c - b * b);
    const float nb_ = -b * inv_det;
    *reinterpret_cast<float4*>(hinv + 4 * i) = make_float4(c * inv_det, nb_, nb_, a * inv_det);
  }
}

// ---------------------------------------------------------------------------
// S2: flow [nb, hc, wc, 2] (null at the coarsest scale), nn_rows [num_h] and
// nn_cols [num_w] int64, centers [n, 2]; writes init_u and pos0 [nb, n, 2]
// and conv0 [nb, n] (bool).
__global__ void __launch_bounds__(THREADS)
start_kernel(const float* __restrict__ flow, const long long* __restrict__ nn_rows,
             const long long* __restrict__ nn_cols, int hc, int wc, int row_off,
             const float* __restrict__ centers, long long total, int n, int num_h, float lb,
             float ub_w, float ub_h, float* __restrict__ init_u, float* __restrict__ pos0,
             uint8_t* __restrict__ conv0) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long pair = i / n;
  const int patch = (int)(i - pair * n);
  float ux = 0.0f, uy = 0.0f;
  if (flow != nullptr) {
    const int ix = patch / num_h, iy = patch - ix * num_h;
    const long long r = nn_rows[iy] - row_off;
    const float2 f = *reinterpret_cast<const float2*>(
        flow + ((pair * hc + r) * wc + nn_cols[ix]) * 2);
    ux = f.x * 2.0f;
    uy = f.y * 2.0f;
  }
  const float2 c = *reinterpret_cast<const float2*>(centers + 2 * patch);
  const float px = c.x + ux, py = c.y + uy;
  *reinterpret_cast<float2*>(init_u + 2 * i) = make_float2(ux, uy);
  *reinterpret_cast<float2*>(pos0 + 2 * i) = make_float2(px, py);
  conv0[i] = (px < lb) | (py < lb) | (px > ub_w) | (py > ub_h);
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
// cover_cols [W, kc] int64
// (num_h and num_w the zero row and column); writes out [nb, out_h, W, 2].
// A block per output row of a pair, in densify_plain's two passes: the row
// pass sums each grid column's covering grid rows into shared memory
// (acc[c][col] for the two flow channels and the weight, col = num_w the
// zero column), then each output pixel sums its covering columns of acc.
// So a grid value is read kr times a row instead of kr * kc times a pixel.
__global__ void __launch_bounds__(THREADS)
densify_kernel(const float* __restrict__ u, const float* __restrict__ wts,
               const long long* __restrict__ cover_rows, const long long* __restrict__ cover_cols,
               const float* __restrict__ uwsum, int weighted, int out_h, int W, int kr,
               int kc, int num_w, int num_h, float* __restrict__ out) {
  extern __shared__ float acc[];   // [3][num_w + 1]
  const int stride = num_w + 1;
  const long long row = blockIdx.x;                   // pair * out_h + y
  const long long pair = row / out_h;
  const int y = (int)(row - pair * out_h);
  const long long n = (long long)num_w * num_h;
  const float* up = u + pair * n * 2;
  const float* wp = weighted ? wts + pair * n : nullptr;
  const long long* rows = cover_rows + (long long)y * kr;
  for (int col = threadIdx.x; col <= num_w; col += THREADS) {
    float a0 = 0.0f, a1 = 0.0f, aw = 0.0f;   // the zero column's values
    if (col < num_w) {
      for (int ky = 0; ky < kr; ++ky) {
        const long long g = rows[ky];
        float v0 = 0.0f, v1 = 0.0f, vw = 0.0f;   // the zero row's values
        if (g != num_h) {
          const long long p = (long long)col * num_h + g;
          const float2 uv = *reinterpret_cast<const float2*>(up + 2 * p);
          v0 = uv.x;
          v1 = uv.y;
          if (weighted) {
            vw = wp[p];
            v0 = v0 * vw;
            v1 = v1 * vw;
          }
        }
        if (ky == 0) {
          a0 = v0;
          a1 = v1;
          aw = vw;
        } else {
          a0 = a0 + v0;
          a1 = a1 + v1;
          aw = aw + vw;
        }
      }
    }
    acc[col] = a0;
    acc[stride + col] = a1;
    acc[2 * stride + col] = aw;
  }
  __syncthreads();
  const float* uw = uwsum + (long long)y * W;
  float* dst = out + row * W * 2;
  for (int x = threadIdx.x; x < W; x += THREADS) {
    const long long* cols = cover_cols + (long long)x * kc;
    float f0 = 0.0f, f1 = 0.0f, fw = 0.0f;
    for (int kx = 0; kx < kc; ++kx) {
      const int c = (int)cols[kx];
      if (kx == 0) {
        f0 = acc[c];
        f1 = acc[stride + c];
        fw = acc[2 * stride + c];
      } else {
        f0 = f0 + acc[c];
        f1 = f1 + acc[stride + c];
        fw = fw + acc[2 * stride + c];
      }
    }
    const float ws = weighted ? fw : uw[x];
    const bool pos = ws > 0.0f;
    *reinterpret_cast<float2*>(dst + 2 * x) =
        make_float2(pos ? __fdiv_rn(f0, ws) : 0.0f, pos ? __fdiv_rn(f1, ws) : 0.0f);
  }
}

// The dynamic shared memory S4 may take on this device: the opt-in maximum,
// granted to the kernel once per device (never per shape, so a later
// launch never lowers it).  0 on an error.
int densify_shared_limit() {
  static int limit[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (limit[dev] == 0) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(densify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin) != cudaSuccess)
      return 0;
    limit[dev] = optin;
  }
  return limit[dev];
}

// Launches a K, G instance of a patch kernel over total patches.
template <int K, int G>
unsigned patch_blocks(long long total) {
  const long long warps = (total + 32 / G - 1) / (32 / G);
  return blocks_for(warps * 32);
}

}  // namespace

// S1.  nb pairs of planes [th, tw]; a grid of n = num_w * num_h patches
// (num_h the column length), steps apart, the first tap at (y0, x0), taps
// inside the planes (the wrapper checks).  ps even, ps^2 <= 512.  Returns
// cudaGetLastError() after the launch (nb * n = 0 launches nothing).
extern "C" int dis_scale_templates(const float* img, const float* dx, const float* dy, int nb,
                                   int th, int tw, int n, int num_h, int steps, int y0, int x0,
                                   int ps, int residual, float inv_ps2, float* T, float* Tdx,
                                   float* Tdy, float* hinv, float* tn, cudaStream_t stream) {
  int k = 0, g = 0;
  if (dis_iclk_layout(ps, &k, &g) != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nb * n;
  if (total <= 0) return (int)cudaGetLastError();
  if (num_h <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(T) || !aligned16(Tdx) || !aligned16(Tdy) || !aligned16(hinv) ||
      (residual && !aligned16(tn)))
    return (int)cudaErrorMisalignedAddress;
#define DIS_S1_LAUNCH(KK, GG)                                                              \
  templates_kernel<KK, GG><<<patch_blocks<KK, GG>(total), THREADS, 0, stream>>>(           \
      img, dx, dy, th, tw, total, n, num_h, steps, y0, x0, ps, residual, inv_ps2, T, Tdx,  \
      Tdy, hinv, tn);                                                                      \
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

// S2.  nb pairs of n patches; flow [nb, hc, wc, 2] or null (zeros: the
// coarsest scale); row_off, the coarser flow's first global row, is
// subtracted from nn_rows.  lb, ub_w, ub_h: the valid region of
// ops/iclk.py::out_of_bounds.  nb * n = 0 launches nothing.
extern "C" int dis_search_start(const float* flow, const long long* nn_rows,
                                const long long* nn_cols, int nb, int hc, int wc, int row_off,
                                const float* centers, int n, int num_h, float lb, float ub_w,
                                float ub_h, float* init_u, float* pos0, unsigned char* conv0,
                                cudaStream_t stream) {
  const long long total = (long long)nb * n;
  if (total <= 0) return (int)cudaGetLastError();
  if (num_h <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned8(flow) || !aligned8(centers) || !aligned8(init_u) || !aligned8(pos0))
    return (int)cudaErrorMisalignedAddress;
  start_kernel<<<blocks_for(total), THREADS, 0, stream>>>(flow, nn_rows, nn_cols, hc, wc,
                                                          row_off, centers, total, n, num_h,
                                                          lb, ub_w, ub_h, init_u, pos0, conv0);
  return (int)cudaGetLastError();
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
// An empty output launches nothing.
extern "C" int dis_densify(const float* u, const float* wts, const long long* cover_rows,
                           const long long* cover_cols, const float* uwsum, int weighted,
                           int nb, int out_h, int W, int kr, int kc, int num_w, int num_h,
                           float* out, cudaStream_t stream) {
  if (kr <= 0 || kc <= 0 || num_w < 0 || num_h < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)nb * out_h;
  if (rows <= 0 || W <= 0) return (int)cudaGetLastError();
  if (!aligned8(u) || !aligned8(out)) return (int)cudaErrorMisalignedAddress;
  const size_t shared = 3 * sizeof(float) * ((size_t)num_w + 1);
  const int limit = densify_shared_limit();
  if (limit == 0) return (int)cudaGetLastError();
  if (shared > (size_t)limit || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  densify_kernel<<<(unsigned)rows, THREADS, shared, stream>>>(
      u, wts, cover_rows, cover_cols, uwsum, weighted, out_h, W, kr, kc, num_w, num_h, out);
  return (int)cudaGetLastError();
}
