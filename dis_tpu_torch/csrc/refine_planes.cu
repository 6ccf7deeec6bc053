// R0: the Sobel planes of one refinement level (the planes6 scheme), one
// launch per level; and R1w, R1's warp1 mode (the warp1 scheme), one
// launch per outer iteration, which shares its tile design (below R0).
//
// No Pallas kernel backs it: on the TPU the level's planes are jnp code
// (dis_tpu/ops/variational.py:188-204, the Sobels of I1 and I2 and the
// six-plane stack) that XLA fuses.  Its plain version is
// refine_planes_plain in dis_tpu_torch/ops/variational.py: I1 and I2, the
// [h, w] windows at offset p of two level planes [H, W] (the padded Q1
// levels, or the intensity planes at p = 0), give I1x, I1y and the stack
// [I2, I2x, I2y, I2xx, I2xy, I2yy] that R1 warps.  The windows are read in
// place: no copy of them is made.
//
// Every Sobel is ops/image.py::sobel3 (3x3, x1/8, reflect-101 border of
// the window): d = p[c+1] - p[c-1] across the axis, then (d[r-1] + 2 d[r])
// + d[r+1] along the other, then * 0.125, one float32 rounding per
// operation in that order (the build passes -fmad=false).  The second
// Sobels reflect the first Sobel planes: I2xx at row -1 reads I2x at row 1,
// the Sobel computed at row 1, which sums other taps in another order than
// a Sobel of the reflected I2 would.  So a block stages I2 on its tile with
// a 2-pixel halo, computes I2x and I2y on the tile and a 1-pixel ring, and
// takes the second Sobels from those.  Every entry is held under its frame
// index, and every neighbour index is reflected into the window before it
// is read, so the ring's entries outside the window are never needed: they
// stand for the in-window entries they reflect to, which the block has.
// Each kernel output equals the plain version bitwise.
//
// Layout: a block of 256 threads owns a TW x TH = 32 x 16 tile of one
// plane (blockIdx.z is the plane of a batch), consecutive threads on
// consecutive columns, so the planes are read and written in coalesced
// rows.  Shared memory: I2 on (TH + 4) x (TW + 4), I1 and the two first
// Sobels of I2 on (TH + 2) x (TW + 2): 2,556 floats, 10.2 KB.  Outputs:
// I1x and I1y as grads [2, nb, h, w], and the six planes interleaved,
// planes [nb, h, w, 6], R1's layout, three float2 stores a pixel.  A
// block whose staged range lies in the window (most of them) takes a path
// without the reflect index arithmetic and the window tests.
//
// Bound on the H100: memory.  It must read the two windows and write 8
// planes, 40 bytes a pixel (1080p finest level: 82.9 MB, 0.025 ms at
// 3.35 TB/s); its 49 operations a pixel take under 3 us at 67 TFLOP/s.
// The staged halo adds (20 * 36 + 18 * 34) / 512 = 2.6 reads of a pixel
// from L2 per output pixel, most of them cached.  Measured there (H100
// 80GB HBM3 at 700 W, chip_smoke.py phase 1e): 0.043 ms, 57% of that
// bound; without the interior path and with six scalar stores a pixel,
// 0.058 ms (43%).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TW = 32, TH = 16;            // output tile
constexpr int SW = TW + 4, SH = TH + 4;    // I2, 2-pixel halo
constexpr int GW = TW + 2, GH = TH + 2;    // I1 and the first Sobels, 1-pixel ring
constexpr int PLANES = 6;

// The reflect-101 image of i in [-1, n] (np.pad's "reflect" rule): -1 is 1
// and n is n - 2, and on an axis of one entry (n = 1) both are 0.
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// A staged plane: entry [j][k] holds frame (oy + j, ox + k); ld its row
// stride.  INNER: the block's staged range lies in the window, where every
// reflect-101 index is the identity.
template <bool INNER>
struct Staged {
  const float* s;
  int ld, oy, ox, h, w;
  __device__ __forceinline__ float at(int r, int c) const { return s[(r - oy) * ld + c - ox]; }
  __device__ __forceinline__ int row(int r) const { return INNER ? r : reflect101(r, h); }
  __device__ __forceinline__ int col(int c) const { return INNER ? c : reflect101(c, w); }

  // sobel3(., "x") at frame (r, c) of the h x w window.
  __device__ __forceinline__ float sobel_x(int r, int c) const {
    const int rm = row(r - 1), rp = row(r + 1), cm = col(c - 1), cp = col(c + 1);
    const float d0 = at(rm, cp) - at(rm, cm);
    const float d1 = at(r, cp) - at(r, cm);
    const float d2 = at(rp, cp) - at(rp, cm);
    return ((d0 + 2.0f * d1) + d2) * 0.125f;
  }

  // sobel3(., "y") at frame (r, c).
  __device__ __forceinline__ float sobel_y(int r, int c) const {
    const int rm = row(r - 1), rp = row(r + 1), cm = col(c - 1), cp = col(c + 1);
    const float d0 = at(rp, cm) - at(rm, cm);
    const float d1 = at(rp, c) - at(rm, c);
    const float d2 = at(rp, cp) - at(rm, cp);
    return ((d0 + 2.0f * d1) + d2) * 0.125f;
  }
};

struct Smem {
  float s2[SH * SW];
  float s1[GH * GW];
  float gx[GH * GW];
  float gy[GH * GW];
};

template <bool INNER>
__device__ __forceinline__ void build(Smem& m, const float* __restrict__ a,
                                      const float* __restrict__ b, int img_w, int h, int w,
                                      float* __restrict__ grads, float* __restrict__ planes) {
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  auto inside = [&](int r, int c) { return INNER || (r >= 0 && r < h && c >= 0 && c < w); };

  // I2 on frame rows [y0 - 2, y0 + TH + 2) and I1 on [y0 - 1, y0 + TH + 1)
  // (columns alike), in the window only.
  for (int k = threadIdx.x; k < SH * SW; k += THREADS) {
    const int r = y0 - 2 + k / SW, c = x0 - 2 + k % SW;
    if (inside(r, c)) m.s2[k] = b[(int64_t)r * img_w + c];
  }
  for (int k = threadIdx.x; k < GH * GW; k += THREADS) {
    const int r = y0 - 1 + k / GW, c = x0 - 1 + k % GW;
    if (inside(r, c)) m.s1[k] = a[(int64_t)r * img_w + c];
  }
  __syncthreads();

  // I2x and I2y on the tile and its ring, in the window.
  const Staged<INNER> S2 = {m.s2, SW, y0 - 2, x0 - 2, h, w};
  for (int k = threadIdx.x; k < GH * GW; k += THREADS) {
    const int r = y0 - 1 + k / GW, c = x0 - 1 + k % GW;
    if (inside(r, c)) {
      m.gx[k] = S2.sobel_x(r, c);
      m.gy[k] = S2.sobel_y(r, c);
    }
  }
  __syncthreads();

  const Staged<INNER> S1 = {m.s1, GW, y0 - 1, x0 - 1, h, w};
  const Staged<INNER> Gx = {m.gx, GW, y0 - 1, x0 - 1, h, w};
  const Staged<INNER> Gy = {m.gy, GW, y0 - 1, x0 - 1, h, w};
  const int64_t n = (int64_t)gridDim.z * h * w;
  for (int k = threadIdx.x; k < TH * TW; k += THREADS) {
    const int y = y0 + k / TW, x = x0 + k % TW;
    if (!INNER && (y >= h || x >= w)) continue;
    const int64_t i = (int64_t)blockIdx.z * h * w + (int64_t)y * w + x;
    grads[i] = S1.sobel_x(y, x);
    grads[n + i] = S1.sobel_y(y, x);
    // Six consecutive floats, 8-byte aligned: three float2 stores.
    float2* o = reinterpret_cast<float2*>(planes + i * PLANES);
    o[0] = make_float2(S2.at(y, x), Gx.at(y, x));
    o[1] = make_float2(Gy.at(y, x), Gx.sobel_x(y, x));
    o[2] = make_float2(Gx.sobel_y(y, x), Gy.sobel_y(y, x));
  }
}

__global__ void __launch_bounds__(THREADS)
planes_kernel(const float* __restrict__ img1, const float* __restrict__ img2, int img_h,
              int img_w, int p, int h, int w, float* __restrict__ grads,
              float* __restrict__ planes) {
  __shared__ Smem m;
  const int64_t src = (int64_t)blockIdx.z * img_h * img_w + (int64_t)p * img_w + p;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  if (y0 >= 2 && y0 + TH + 2 <= h && x0 >= 2 && x0 + TW + 2 <= w)
    build<true>(m, img1 + src, img2 + src, img_w, h, w, grads, planes);
  else
    build<false>(m, img1 + src, img2 + src, img_w, h, w, grads, planes);
}

// ---------------------------------------------------------------------------
// R1w: R1's warp1 mode, one launch per outer iteration of the warp1
// scheme.  No Pallas kernel backs it either: it replaces the jnp code of
// dis_tpu/ops/variational.py:191-197 (I1's Sobels, the one plane to warp)
// and :223-242 (outer's head under warp1) that XLA fuses.  Its plain
// version is refine_setup_warp1_plain in dis_tpu_torch/ops/variational.py:
// I1 and I2, the windows at offset p of the level planes, and the flow
// give W, I2 warped at x + flow (R1's taps and blend, refine_warp_plain),
// and from it R23's thirteen inputs, out [13, nb, h, w]:
//   Iz = W - I1, Izx = Wxr - I1x, Izy = Wyr - I1y, Wx, Wy, Wxx = sobel_x(Wx),
//   Wxy = sobel_y(Wx), Wyy = sobel_y(Wy), m, u0, v0, du = dv = 0,
// where Wxr and Wyr are W's Sobels, I1x and I1y I1's, and Wx = (I1x + Wxr)
// * 0.5 (two roundings), Wy alike.  The second Sobels reflect the averaged
// planes at the window's border, the nested reflect-101 of R0; so, as R0,
// a block stages W and I1 on its tile with a 2-pixel halo (the warp is
// pointwise, so the block warps its halo itself, from the flow at each
// pixel of the window), computes the four first Sobels and the two means
// on the tile and a 1-pixel ring, and the second Sobels on the tile.  The
// mask is recomputed from the flow where it is written.  Every output
// equals the plain version bitwise.
//
// Shared memory: W and I1 on (TH + 4) x (TW + 4), the four first Sobels
// and the two means on (TH + 2) x (TW + 2): 5,112 floats, 20.4 KB.
//
// Bound on the H100: memory.  It must read the two windows and the flow
// (16 bytes a pixel) and write 13 planes (52): at the 1080p finest level
// (1088 x 1920 under the intensity planes' padding) 142 MB, 0.0424 ms at
// 3.35 TB/s; its about 100 operations a pixel take under 4 us at 67
// TFLOP/s.

struct Warp1Smem {
  float w[SH * SW];    // W, the warped I2
  float i1[SH * SW];   // I1
  float i1x[GH * GW], i1y[GH * GW];   // I1's Sobels
  float wxr[GH * GW], wyr[GH * GW];   // W's Sobels
  float ax[GH * GW], ay[GH * GW];     // their means: Wx, Wy
};
enum Warp1Out { O_IZ, O_IZX, O_IZY, O_WX, O_WY, O_WXX, O_WXY, O_WYY, O_M, O_U0, O_V0, O_DU,
                O_DV };

// Whether x + flow at (y, x) falls inside the h x w plane, and where it
// lands clamped to it: R1's test and clamp (refine_warp_plain).
struct Landing {
  bool in;
  float fxc, fyc;
};

__device__ __forceinline__ Landing land(int y, int x, float u, float v, int h, int w) {
  const float wm1 = (float)(w - 1), hm1 = (float)(h - 1);
  const float fx = (float)x + u;
  const float fy = (float)y + v;
  const bool in = (fx >= 0.f) & (fx <= wm1) & (fy >= 0.f) & (fy <= hm1);
  return {in, fminf(fmaxf(fx, 0.f), wm1), fminf(fmaxf(fy, 0.f), hm1)};
}

// I2 (the window at `b`, row stride img_w) sampled at x + flow of pixel
// (y, x): refine_warp_plain's four taps and blend (warp_kernel's in
// variational.cu), the terms summed left to right.
__device__ __forceinline__ float warp_at(const float* __restrict__ b, int img_w,
                                         const float* __restrict__ flow, int y, int x, int h,
                                         int w) {
  const int64_t f = 2 * ((int64_t)y * w + x);
  const Landing l = land(y, x, flow[f], flow[f + 1], h, w);
  const float x0f = floorf(l.fxc), y0f = floorf(l.fyc);
  const float a = l.fxc - x0f, bb = l.fyc - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const float w00 = (1.f - a) * (1.f - bb), w01 = a * (1.f - bb);
  const float w10 = (1.f - a) * bb, w11 = a * bb;
  float s = w00 * b[(int64_t)y0 * img_w + x0] + w01 * b[(int64_t)y0 * img_w + x1];
  s = s + w10 * b[(int64_t)y1 * img_w + x0];
  return s + w11 * b[(int64_t)y1 * img_w + x1];
}

template <bool INNER>
__device__ __forceinline__ void build_warp1(Warp1Smem& m, const float* __restrict__ a,
                                            const float* __restrict__ b, int img_w,
                                            const float* __restrict__ flow, int h, int w,
                                            float* __restrict__ out) {
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  auto inside = [&](int r, int c) { return INNER || (r >= 0 && r < h && c >= 0 && c < w); };

  // W and I1 on frame rows [y0 - 2, y0 + TH + 2) (columns alike), in the
  // window only.
  for (int k = threadIdx.x; k < SH * SW; k += THREADS) {
    const int r = y0 - 2 + k / SW, c = x0 - 2 + k % SW;
    if (inside(r, c)) {
      m.w[k] = warp_at(b, img_w, flow, r, c, h, w);
      m.i1[k] = a[(int64_t)r * img_w + c];
    }
  }
  __syncthreads();

  // The first Sobels and their means on the tile and its ring, in the window.
  const Staged<INNER> Ws = {m.w, SW, y0 - 2, x0 - 2, h, w};
  const Staged<INNER> S1 = {m.i1, SW, y0 - 2, x0 - 2, h, w};
  for (int k = threadIdx.x; k < GH * GW; k += THREADS) {
    const int r = y0 - 1 + k / GW, c = x0 - 1 + k % GW;
    if (inside(r, c)) {
      const float i1x = S1.sobel_x(r, c), i1y = S1.sobel_y(r, c);
      const float wxr = Ws.sobel_x(r, c), wyr = Ws.sobel_y(r, c);
      m.i1x[k] = i1x;
      m.i1y[k] = i1y;
      m.wxr[k] = wxr;
      m.wyr[k] = wyr;
      m.ax[k] = (i1x + wxr) * 0.5f;
      m.ay[k] = (i1y + wyr) * 0.5f;
    }
  }
  __syncthreads();

  const Staged<INNER> I1x = {m.i1x, GW, y0 - 1, x0 - 1, h, w};
  const Staged<INNER> I1y = {m.i1y, GW, y0 - 1, x0 - 1, h, w};
  const Staged<INNER> Wxr = {m.wxr, GW, y0 - 1, x0 - 1, h, w};
  const Staged<INNER> Wyr = {m.wyr, GW, y0 - 1, x0 - 1, h, w};
  const Staged<INNER> Ax = {m.ax, GW, y0 - 1, x0 - 1, h, w};
  const Staged<INNER> Ay = {m.ay, GW, y0 - 1, x0 - 1, h, w};
  const int64_t n = (int64_t)gridDim.z * h * w;
  for (int k = threadIdx.x; k < TH * TW; k += THREADS) {
    const int y = y0 + k / TW, x = x0 + k % TW;
    if (!INNER && (y >= h || x >= w)) continue;
    const int64_t j = (int64_t)y * w + x;
    const int64_t i = (int64_t)blockIdx.z * h * w + j;
    const float u = flow[2 * j], v = flow[2 * j + 1];
    out[O_IZ * n + i] = Ws.at(y, x) - S1.at(y, x);
    out[O_IZX * n + i] = Wxr.at(y, x) - I1x.at(y, x);
    out[O_IZY * n + i] = Wyr.at(y, x) - I1y.at(y, x);
    out[O_WX * n + i] = Ax.at(y, x);
    out[O_WY * n + i] = Ay.at(y, x);
    out[O_WXX * n + i] = Ax.sobel_x(y, x);
    out[O_WXY * n + i] = Ax.sobel_y(y, x);
    out[O_WYY * n + i] = Ay.sobel_y(y, x);
    out[O_M * n + i] = land(y, x, u, v, h, w).in ? 1.0f : 0.0f;
    out[O_U0 * n + i] = u;
    out[O_V0 * n + i] = v;
    out[O_DU * n + i] = 0.0f;
    out[O_DV * n + i] = 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
warp1_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
             const float* __restrict__ flow, int img_h, int img_w, int p, int h, int w,
             float* __restrict__ out) {
  __shared__ Warp1Smem m;
  const int64_t src = (int64_t)blockIdx.z * img_h * img_w + (int64_t)p * img_w + p;
  const float* f = flow + (int64_t)blockIdx.z * h * w * 2;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  if (y0 >= 2 && y0 + TH + 2 <= h && x0 >= 2 && x0 + TW + 2 <= w)
    build_warp1<true>(m, img1 + src, img2 + src, img_w, f, h, w, out);
  else
    build_warp1<false>(m, img1 + src, img2 + src, img_w, f, h, w, out);
}

}  // namespace

// img1, img2 [nb, img_h, img_w]; the window [h, w] at offset p of each.
// Writes grads [2, nb, h, w] (I1x, I1y) and planes [nb, h, w, 6].
extern "C" int dis_refine_planes(const float* img1, const float* img2, int nb, int img_h,
                                 int img_w, int p, int h, int w, float* grads, float* planes,
                                 cudaStream_t stream) {
  if (nb < 1 || nb > 65535 || h < 1 || w < 1 || p < 0 || p + h > img_h || p + w > img_w ||
      (int64_t)nb * h * w > ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, nb);
  planes_kernel<<<grid, THREADS, 0, stream>>>(img1, img2, img_h, img_w, p, h, w, grads, planes);
  return (int)cudaGetLastError();
}

// R1w: img1, img2 [nb, img_h, img_w] (I1 and I2 their windows [h, w] at
// offset p), flow [nb, h, w, 2]; writes out [13, nb, h, w], R23's inputs.
extern "C" int dis_refine_setup_warp1(const float* img1, const float* img2, const float* flow,
                                      int nb, int img_h, int img_w, int p, int h, int w,
                                      float* out, cudaStream_t stream) {
  if (nb < 1 || nb > 65535 || h < 1 || w < 1 || p < 0 || p + h > img_h || p + w > img_w ||
      (int64_t)nb * h * w > ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, nb);
  warp1_kernel<<<grid, THREADS, 0, stream>>>(img1, img2, flow, img_h, img_w, p, h, w, out);
  return (int)cudaGetLastError();
}
