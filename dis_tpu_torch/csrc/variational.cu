// R1's setup mode, R23 and R3's no-sweep mode: the variational
// refinement's device loop.
//
// No Pallas kernel backs these: on the TPU the refinement is elementwise
// jnp code (dis_tpu/ops/variational.py) that XLA fuses into a few loops
// per masked half-sweep.  They replace those fusions:
//   R1s dis_refine_setup    R1's setup mode (the planes6 scheme): the warp
//                           (_warp_bilinear, :88) and, from it, the weight
//                           update's thirteen inputs (outer's head,
//                           :220-250, and the zero increments of :312);
//   R23 dis_refine_update   a weight update, the head of inner (:252-283)
//                           and the per-update coefficients, and all its
//                           red and black half-sweeps (half_sweep,
//                           :286-307) in one launch, on tiles held on chip
//                           (below); in its compose mode the last update of
//                           an outer iteration, which writes the flow
//                           (u0 + du, v0 + dv) (:314), clipped to a bound
//                           under a flag (refined_init_clamp's jnp.clip,
//                           dis_tpu/models/dis.py:101-103);
//   R3n dis_refine_nosweep  R3's no-sweep mode: that flow of an outer
//                           iteration that makes no half-sweep, with the
//                           same clip.
// A planes6 level of 5 updates of 5 sweeps makes 7 launches (R0, R1s, five
// R23).  R1's warp1 mode (R1w), a tile kernel, is in refine_planes.cu.
// Their plain versions are refine_setup_plain, refine_update_plain (made of
// refine_weights_plain and refine_sor_plain) and refine_nosweep_plain in
// dis_tpu_torch/ops/variational.py.  Each kernel keeps the plain version's
// operations, one float32 rounding per operation and in its order (the
// build passes -fmad=false, so no product is contracted into a
// multiply-add); the IRLS weight is 0.5 * (1 / sqrt(s2 + eps2)) with the
// correctly rounded root and reciprocal (__fsqrt_rn, __frcp_rn: the plain
// version's sqrt_f32 and Tensor.__rtruediv__), the solve divides with
// __fdiv_rn, and every Python scalar of the plain version is a float32
// here.  There is no reduction, so each kernel equals its plain version
// bitwise.
//
// Layout: planes [nb, h, w] float32, contiguous, nb pairs (the batch axis)
// of h x w pixels each; a stencil clamps its neighbour's row and column to
// the pair's own plane (the plain version's replicate border), so it never
// crosses a pair boundary.  R1s and R3n take one thread per pixel over a
// 1-D grid of the nb * h * w pixels: consecutive threads take consecutive
// columns, so every plane is read and written in coalesced rows.  Outputs
// are new planes: R1s writes R23's thirteen inputs one after another
// ([13, nb, h, w]), R23 the new du and dv ([2, nb, h, w]) or the flow.
//
// Bound on the H100: R1s and R3n by memory.  At the 1080p finest level
// (2,073,600 px, a plane 8.29 MB) R1s reads 11 planes and writes 13 (199
// MB, 59 us at 3.35 TB/s): 0.074 ms, 80% of that bound (H100 80GB HBM3 at
// 700 W, chip_smoke.py phase 1e).  R23 reads its 13 planes and writes 2
// (124 MB at 1080p, 37 us), once each; it is bound instead by the work its
// halo repeats (a tile of about 2,800 pixels keeps about 1,000 as its
// interior) and by the latency of its chain of half-sweeps, each a barrier
// apart: 0.26 ms a weight update at 1088 x 1920, and 0.009-0.072 ms at the
// 1080p hd1080_medium levels 5 to 1 (H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "dis_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float EPS2_DATA = 1e-2f;     // variational.py::_EPS2_DATA
constexpr float EPS2_SMOOTH = 1e-6f;   // variational.py::_EPS2_SMOOTH
constexpr float DET_FLOOR = 1e-12f;    // the masked_fill of det

// Psi'(s^2) = 0.5 / sqrt(s^2 + eps^2) as the plain version rounds it:
// fl(s2 + eps2), the correctly rounded root, its correctly rounded
// reciprocal, then the exact scaling by 0.5.
__device__ __forceinline__ float psi_deriv(float s2, float eps2) {
  return __frcp_rn(__fsqrt_rn(s2 + eps2)) * 0.5f;
}

// A pixel's pair, row and column from its index in [0, nb * h * w).
struct Pixel {
  int64_t base;   // index of the pair's first pixel
  int y, x;
};

__device__ __forceinline__ Pixel pixel_of(int64_t i, int h, int w) {
  const int64_t hw = (int64_t)h * w;
  const int64_t b = i / hw;
  const int r = (int)(i - b * hw);
  return {b * hw, r / w, r % w};
}

// ---------------------------------------------------------------------------
// R1's setup mode (refine_setup_plain; its one instance is C = 6, SETUP, the
// name traces and the layer tables match): planes [nb, h, w, C]
// interleaved, sampled at x + flow, flow [nb, h, w, 2], with edge clamp
// (refine_warp_plain's taps and blend); writes the thirteen planes that
// R23 reads, out [13, nb, h, w] in its input order: Iz = W - I1, Izx = Wx -
// I1x, Izy = Wy - I1y, the five warped derivative planes, the mask m as
// 1.0 or 0.0, u0 and v0 from the flow, and du = dv = 0.  I1 is read in
// place from its level plane (`setup.img1`, planes of img_h x img_w, the
// window at offset p); I1x and I1y are R0's planes.
struct Setup {
  const float* img1;
  const float* I1x;
  const float* I1y;
  int img_h, img_w, p;
};
enum SetupOut { O_IZ, O_IZX, O_IZY, O_WX, O_WY, O_WXX, O_WXY, O_WYY, O_M, O_U0, O_V0, O_DU,
                O_DV, N_SETUP_OUT };

template <int C, bool SETUP>
__global__ void __launch_bounds__(THREADS)
warp_kernel(const float* __restrict__ planes, const float* __restrict__ flow, int h, int w,
            int64_t n, float* __restrict__ out, Setup setup) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Pixel p = pixel_of(i, h, w);
  const float wm1 = (float)(w - 1), hm1 = (float)(h - 1);
  const float u0 = flow[2 * i], v0 = flow[2 * i + 1];
  const float fx = (float)p.x + u0;
  const float fy = (float)p.y + v0;
  const bool in = (fx >= 0.f) & (fx <= wm1) & (fy >= 0.f) & (fy <= hm1);
  const float fxc = fminf(fmaxf(fx, 0.f), wm1);
  const float fyc = fminf(fmaxf(fy, 0.f), hm1);
  const float x0f = floorf(fxc), y0f = floorf(fyc);
  const float a = fxc - x0f, b = fyc - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  // ((1 - a) * (1 - b)) * c00 + (a * (1 - b)) * c01 + ((1 - a) * b) * c10
  // + (a * b) * c11, the terms summed left to right.
  const float w00 = (1.f - a) * (1.f - b), w01 = a * (1.f - b);
  const float w10 = (1.f - a) * b, w11 = a * b;
  const float* c00 = planes + (p.base + (int64_t)y0 * w + x0) * C;
  const float* c01 = planes + (p.base + (int64_t)y0 * w + x1) * C;
  const float* c10 = planes + (p.base + (int64_t)y1 * w + x0) * C;
  const float* c11 = planes + (p.base + (int64_t)y1 * w + x1) * C;
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float s = w00 * c00[c] + w01 * c01[c];
    s = s + w10 * c10[c];
    v[c] = s + w11 * c11[c];
  }
  const int64_t plane = (int64_t)setup.img_h * setup.img_w;
  const float I1 = setup.img1[(p.base / ((int64_t)h * w)) * plane +
                              (int64_t)(p.y + setup.p) * setup.img_w + p.x + setup.p];
  out[O_IZ * n + i] = v[0] - I1;
  out[O_IZX * n + i] = v[1] - setup.I1x[i];
  out[O_IZY * n + i] = v[2] - setup.I1y[i];
#pragma unroll
  for (int c = 1; c < C; ++c) out[(O_WX + c - 1) * n + i] = v[c];
  out[O_M * n + i] = in ? 1.0f : 0.0f;
  out[O_U0 * n + i] = u0;
  out[O_V0 * n + i] = v0;
  out[O_DU * n + i] = 0.0f;
  out[O_DV * n + i] = 0.0f;
}

// R23's inputs, in the order of refine_weights_plain's arguments.
enum WeightIn { IZ, IZX, IZY, WX, WY, WXX, WXY, WYY, M, U0, V0, DU, DV, N_WEIGHT_IN };

// x clipped to [-b, b] as torch.clamp and jnp.clip clip it: NaN passes
// through and -0.0 stays -0.0 (fminf and fmaxf would drop a NaN).
__device__ __forceinline__ float clip(float x, float b) {
  return x < -b ? -b : (x > b ? b : x);
}

// ---------------------------------------------------------------------------
// R3's no-sweep mode (refine_nosweep_plain): the flow out [nb, h, w, 2] =
// (u0 + du, v0 + dv), each clipped to [-bound, bound] where `clamp` (a
// runtime flag).  It keeps the name and the template argument it had as
// the compose instance of R3's half-sweep, which traces and the layer
// tables match; COMPOSE is true in its one instance.
template <bool COMPOSE>
__global__ void __launch_bounds__(THREADS)
sor_kernel(const float* __restrict__ u0, const float* __restrict__ v0,
           const float* __restrict__ du, const float* __restrict__ dv, int64_t n, int clamp,
           float bound, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float u = u0[i] + du[i], v = v0[i] + dv[i];
  out[2 * i] = clamp ? clip(u, bound) : u;
  out[2 * i + 1] = clamp ? clip(v, bound) : v;
}

// ---------------------------------------------------------------------------
// R23: one weight update, its coefficients and `nh` of its half-sweeps,
// on a tile held on chip (temporal blocking).  A block takes one tile of
// one pair: an interior of ih x iw pixels and a halo of nh pixels above
// and left of it and nh + 1 below and right, cut at the plane's edges.
// Each thread holds up to UPDATE_PAIRS pairs of the tile's pixels in
// registers (each pixel's du, dv and most of its coefficients); shared memory
// holds what neighbours read (U = u0 + du, V = v0 + dv, the smoothness
// weights) and the rest (u0, v0, the edge weights).  The block loads U
// and V (du, dv the update's increments, which the coefficients read) and the
// half-sweeps' start du and dv, makes the smoothness weights, then the
// coefficients, then runs the half-sweeps colour by colour, and writes
// the interior's du and dv, or in the compose mode the flow (u0 + du,
// v0 + dv) clipped where `clamp`.
// A half-sweep reads 14 shared words a pixel and writes 2, where one that
// kept all of the coefficients in shared memory read 22 and wrote 4, and
// shared memory's bandwidth set its pace.
//
// A stencil clamps its neighbour to the tile, which at the plane's edges is
// the plain version's replicate border; at an edge inside the plane it
// reads a wrong value, and the halo holds every pixel that such a value
// reaches: a smoothness weight reads its right and lower neighbours' U (1
// pixel, right and below), an edge weight its four neighbours' weights (1
// more each side), and a half-sweep its four neighbours' U and V (1 more
// each side per half-sweep).  After the coefficients and nh half-sweeps the wrong values
// reach nh pixels in from the tile's upper and left edges and nh + 1 in
// from its lower and right ones, so the interior holds the plain version's
// bits.  The j-th half-sweep (from 1) updates only the pixels still right
// after it, j in from the upper and left edges inside the plane and j + 1
// from the lower and right ones.  ops/variational.py::refine_update_tiled
// runs the same tiles with the plain versions on the CPU.
//
// Where a launch holds only part of an update's half-sweeps (j0 > 0: the
// halo of them all would not leave a tile an interior), du and dv point to
// the previous launch's output while the coefficients still read the
// update's own increments; U and V are made anew from them after the
// coefficients.
constexpr int UPDATE_THREADS = 512;
// The pixel pairs a thread holds: a row's pixels 2k and 2k + 1, one of
// each colour, so that every thread has one pixel of a pair to update in
// each half-sweep.  A tile holds at most UPDATE_PAIRS * UPDATE_THREADS
// pairs.
constexpr int UPDATE_PAIRS = 3;
// The tile's planes in shared memory: what a pixel's neighbours read (U
// and V, the smoothness weights), and what its threads' registers do not
// hold (u0, v0 and the edge weights).
enum TilePlane { P_U, P_V, P_U0, P_V0, P_WSM, P_WE, P_WW, P_WS, P_WN, N_TILE_PLANES };

struct UpdateArgs {
  const float* in[N_WEIGHT_IN];   // the coefficients' inputs: du and dv the update's increments
  const float* du;                // the half-sweeps' start
  const float* dv;
};

// The tiles of a launch: interior ih x iw, tiles_x across a plane; the
// launch's half-sweeps j0 .. j0 + nh - 1 of the update (colour j & 1).
struct UpdatePlan {
  int ih, iw, tiles_x, j0, nh;
};

// Rows and columns a tile loads: its interior's extent with its halo,
// cut at the plane (the same on both axes).
__host__ __device__ __forceinline__ int tile_extent(int n, int inner, int tiles, int nh) {
  return tiles == 1 ? n : min(n, inner + (nh + 1) + (tiles > 2 ? nh : 0));
}

// A tile plane in shared memory holds its red pixels, then its black
// ones, each colour's row by row at a pitch of (tw + 1) / 2 (the tile's
// pairs): pair p's pixel of colour c is word c * half + p, so the pixels
// one half-sweep updates, and each of their neighbours, lie in
// consecutive words, and each colour's half starts 16 banks after the
// other's: no two lanes of a warp meet in a bank.  The floats of a half.
__host__ __device__ __forceinline__ int tile_half(int th, int tw) {
  return (th * ((tw + 1) / 2) + 15) / 32 * 32 + 16;
}

// What a thread holds of one of its pixels through the half-sweeps: its
// du and dv, and refine_weights_plain's outputs but for the edge weights
// (in shared memory) and Su0 and Sv0, which a half-sweep makes again from
// the edge weights and u0 and v0 with the same operations.
struct Held {
  float du, dv, a11, a12, a22, b1c, b2c, det;
};

template <int C>
using Colour = std::integral_constant<int, C>;

template <bool COMPOSE>
__global__ void __launch_bounds__(UPDATE_THREADS, 1)
sor_kernel(UpdateArgs g, int h, int w, UpdatePlan t, float alpha, float delta, float gamma,
           float omega, int relax, int clamp, float bound, float* __restrict__ out) {
  extern __shared__ float dis_tile[];
  const int64_t base = (int64_t)blockIdx.y * h * w;
  const int r0 = (blockIdx.x / t.tiles_x) * t.ih, c0 = (blockIdx.x % t.tiles_x) * t.iw;
  const int r1 = min(h, r0 + t.ih), c1 = min(w, c0 + t.iw);
  const int y0 = max(0, r0 - t.nh), y1 = min(h, r1 + t.nh + 1);
  const int x0 = max(0, c0 - t.nh), x1 = min(w, c1 + t.nh + 1);
  const int th = y1 - y0, tw = x1 - x0;
  const int pitch = (tw + 1) / 2, half = tile_half(th, tw), pairs = th * pitch;
  const int q = (y0 + x0) & 1;   // the colour of the tile's first pixel
  float* const sU = dis_tile + P_U * 2 * half;
  float* const sV = dis_tile + P_V * 2 * half;
  float* const sU0 = dis_tile + P_U0 * 2 * half;
  float* const sV0 = dis_tile + P_V0 * 2 * half;
  float* const sWSM = dis_tile + P_WSM * 2 * half;
  float* const sWE = dis_tile + P_WE * 2 * half;
  float* const sWW = dis_tile + P_WW * 2 * half;
  float* const sWS = dis_tile + P_WS * 2 * half;
  float* const sWN = dis_tile + P_WN * 2 * half;
  const bool split = g.du != g.in[DU] || g.dv != g.in[DV];
  // The word of the tile's pixel (y, x) in a plane.
  const auto at = [&](int y, int x) { return ((q + y + x) & 1) * half + y * pitch + (x >> 1); };
  // The thread's pairs: pair threadIdx.x + m * UPDATE_THREADS, row y[m]
  // and pair k[m] of the row (y[m] = th where the tile has no such pair).
  int y[UPDATE_PAIRS], k[UPDATE_PAIRS];
#pragma unroll
  for (int m = 0; m < UPDATE_PAIRS; ++m) {
    const int p = threadIdx.x + m * UPDATE_THREADS;
    y[m] = p < pairs ? p / pitch : th;
    k[m] = p - y[m] * pitch;
  }
  // f(m, c, x, i, gi) for each pixel the thread holds (colour c of its
  // pair m, column x, word i, index gi in the planes).
  const auto each_held = [&](auto&& f) {
#pragma unroll
    for (int m = 0; m < UPDATE_PAIRS; ++m) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int x = 2 * k[m] + ((c + q + y[m]) & 1);
        if (y[m] < th && x < tw)
          f(m, c, x, c * half + y[m] * pitch + k[m], base + (int64_t)(y0 + y[m]) * w + x0 + x);
      }
    }
  };
  Held px[UPDATE_PAIRS][2];

  each_held([&](int m, int c, int x, int i, int64_t gi) {
    const float u0 = __ldg(g.in[U0] + gi), v0 = __ldg(g.in[V0] + gi);
    px[m][c].du = __ldg(g.du + gi);
    px[m][c].dv = __ldg(g.dv + gi);
    sU0[i] = u0;
    sV0[i] = v0;
    sU[i] = u0 + (split ? __ldg(g.in[DU] + gi) : px[m][c].du);
    sV[i] = v0 + (split ? __ldg(g.in[DV] + gi) : px[m][c].dv);
  });
  __syncthreads();
  // The smoothness weights: alpha * Psi'(|grad U|^2 + |grad V|^2), forward
  // differences to the clamped right and lower neighbours, the squares
  // summed as ((Ux^2 + Uy^2) + Vx^2) + Vy^2 (refine_weights_plain).
  each_held([&](int m, int c, int x, int i, int64_t gi) {
    const int e = at(y[m], min(x + 1, tw - 1)), s = at(min(y[m] + 1, th - 1), x);
    const float Ux = sU[e] - sU[i], Uy = sU[s] - sU[i];
    const float Vx = sV[e] - sV[i], Vy = sV[s] - sV[i];
    float sum = Ux * Ux + Uy * Uy;
    sum = sum + Vx * Vx;
    sum = sum + Vy * Vy;
    sWSM[i] = psi_deriv(sum, EPS2_SMOOTH) * alpha;
  });
  __syncthreads();
  // The coefficients, refine_weights_plain's operations on the tile: the
  // lagged robust weights of the data and gradient terms, the edge weights
  // (the mean of the endpoints' smoothness weights), the 2x2 system and its
  // determinant, floored.
  each_held([&](int m, int c, int x, int i, int64_t gi) {
    const int yy = y[m];
    const float Iz = __ldg(g.in[IZ] + gi), Izx = __ldg(g.in[IZX] + gi);
    const float Izy = __ldg(g.in[IZY] + gi), Wx = __ldg(g.in[WX] + gi);
    const float Wy = __ldg(g.in[WY] + gi), Wxx = __ldg(g.in[WXX] + gi);
    const float Wxy = __ldg(g.in[WXY] + gi), Wyy = __ldg(g.in[WYY] + gi);
    const float mk = __ldg(g.in[M] + gi);
    const float du = split ? __ldg(g.in[DU] + gi) : px[m][c].du;
    const float dv = split ? __ldg(g.in[DV] + gi) : px[m][c].dv;
    float r_d = Iz + Wx * du;
    r_d = r_d + Wy * dv;
    const float wd = (psi_deriv(r_d * r_d, EPS2_DATA) * delta) * mk;
    float r_gx = Izx + Wxx * du;
    r_gx = r_gx + Wxy * dv;
    float r_gy = Izy + Wxy * du;
    r_gy = r_gy + Wyy * dv;
    const float wg = (psi_deriv(r_gx * r_gx + r_gy * r_gy, EPS2_DATA) * gamma) * mk;
    const float ws = sWSM[i];
    const float wsE = sWSM[at(yy, min(x + 1, tw - 1))], wsW = sWSM[at(yy, max(x - 1, 0))];
    const float wsS = sWSM[at(min(yy + 1, th - 1), x)], wsN = sWSM[at(max(yy - 1, 0), x)];
    Held& o = px[m][c];
    const float wE = (ws + wsE) * 0.5f, wW = (ws + wsW) * 0.5f;
    const float wS = (ws + wsS) * 0.5f, wN = (ws + wsN) * 0.5f;
    float S = wE + wW;
    S = S + wS;
    S = S + wN;
    float a11 = (wd * Wx) * Wx + wg * (Wxx * Wxx + Wxy * Wxy);
    o.a11 = a11 + S;
    o.a12 = (wd * Wx) * Wy + wg * (Wxy * (Wxx + Wyy));
    float a22 = (wd * Wy) * Wy + wg * (Wxy * Wxy + Wyy * Wyy);
    o.a22 = a22 + S;
    o.b1c = -((wd * Wx) * Iz + wg * (Wxx * Izx + Wxy * Izy));
    o.b2c = -((wd * Wy) * Iz + wg * (Wxy * Izx + Wyy * Izy));
    const float det = o.a11 * o.a22 - o.a12 * o.a12;
    o.det = fabsf(det) < DET_FLOOR ? DET_FLOOR : det;
    // Stored after every read of the smoothness weights in this pass (a
    // barrier follows before the half-sweeps read them).
    sWE[i] = wE;
    sWW[i] = wW;
    sWS[i] = wS;
    sWN[i] = wN;
    if (split) {   // no thread reads U or V in this pass
      sU[i] = sU0[i] + px[m][c].du;
      sV[i] = sV0[i] + px[m][c].dv;
    }
  });
  // The half-sweeps: refine_sor_plain's operations on each held pixel of the
  // colour that stays right; the other colour is only read, so each runs
  // in place.  The colour is a constant of each instance, so the held
  // values stay in registers.
  const int top = y0 > 0, bottom = y1 < h, left = x0 > 0, right = x1 < w;
  const auto half_sweep = [&](int j, auto colour) {
    constexpr int c = decltype(colour)::value;
    const int ya = top * j, yb = th - bottom * (j + 1);
    const int xa = left * j, xb = tw - right * (j + 1);
#pragma unroll
    for (int m = 0; m < UPDATE_PAIRS; ++m) {
      const int yy = y[m], x = 2 * k[m] + ((c + q + yy) & 1);
      if (yy < ya || yy >= yb || x < xa || x >= xb) continue;
      const int i = c * half + yy * pitch + k[m];
      const int nrow = (c ^ 1) * half + yy * pitch;
      // A neighbour past the tile is the pixel itself (the replicate border).
      const int e = x + 1 < tw ? nrow + ((x + 1) >> 1) : i;
      const int ww = x > 0 ? nrow + ((x - 1) >> 1) : i;
      const int s = yy + 1 < th ? nrow + pitch + (x >> 1) : i;
      const int nn = yy > 0 ? nrow - pitch + (x >> 1) : i;
      Held& o = px[m][c];
      const float wE = sWE[i], wW = sWW[i], wS = sWS[i], wN = sWN[i];
      float nU = wE * sU[e] + wW * sU[ww];
      nU = nU + wS * sU[s];
      nU = nU + wN * sU[nn];
      float nV = wE * sV[e] + wW * sV[ww];
      nV = nV + wS * sV[s];
      nV = nV + wN * sV[nn];
      float S = wE + wW;   // the coefficients' S, Su0 and Sv0
      S = S + wS;
      S = S + wN;
      const float u0 = sU0[i], v0 = sV0[i];
      const float b1 = (o.b1c + nU) - S * u0;
      const float b2 = (o.b2c + nV) - S * v0;
      float du_new = __fdiv_rn(o.a22 * b1 - o.a12 * b2, o.det);
      float dv_new = __fdiv_rn(o.a11 * b2 - o.a12 * b1, o.det);
      if (relax) {   // omega != 1: over-relax; omega == 1 keeps the direct assignment
        du_new = o.du + (du_new - o.du) * omega;
        dv_new = o.dv + (dv_new - o.dv) * omega;
      }
      o.du = du_new;
      o.dv = dv_new;
      sU[i] = u0 + du_new;
      sV[i] = v0 + dv_new;
    }
  };
  for (int j = 1; j <= t.nh; ++j) {
    __syncthreads();
    if (((t.j0 + j - 1) & 1) == 0)
      half_sweep(j, Colour<0>{});
    else
      half_sweep(j, Colour<1>{});
  }
  // The interior: U and V hold u0 + du and v0 + dv, the flow's sums.
  const int64_t n = (int64_t)gridDim.y * h * w;
  each_held([&](int m, int c, int x, int i, int64_t gi) {
    if (y[m] < r0 - y0 || y[m] >= r1 - y0 || x < c0 - x0 || x >= c1 - x0) return;
    if (COMPOSE) {
      out[2 * gi] = clamp ? clip(sU[i], bound) : sU[i];
      out[2 * gi + 1] = clamp ? clip(sV[i], bound) : sV[i];
    } else {
      out[gi] = px[m][c].du;
      out[n + gi] = px[m][c].dv;
    }
  });
}

using UpdateKernel = void (*)(UpdateArgs, int, int, UpdatePlan, float, float, float, float, int,
                              int, float, float*);
const void* const UPDATE_KERNELS[] = {(const void*)(UpdateKernel)sor_kernel<false>,
                                      (const void*)(UpdateKernel)sor_kernel<true>};
int update_granted[64] = {0};

int blocks_for(int64_t n) { return (int)((n + THREADS - 1) / THREADS); }

bool shape_ok(int nb, int h, int w) {
  return nb >= 1 && h >= 1 && w >= 1 && (int64_t)nb * h * w <= ((int64_t)1 << 31) - THREADS;
}

}  // namespace

// R1's setup mode: planes [nb, h, w, 6], flow [nb, h, w, 2], img1 [nb,
// img_h, img_w] (I1 its window at offset p), I1x and I1y [nb, h, w]; out
// [13, nb, h, w].
extern "C" int dis_refine_setup(const float* planes, const float* flow, const float* img1,
                                const float* I1x, const float* I1y, int nb, int h, int w,
                                int img_h, int img_w, int p, float* out, cudaStream_t stream) {
  if (!shape_ok(nb, h, w) || p < 0 || p + h > img_h || p + w > img_w)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)nb * h * w;
  const Setup setup = {img1, I1x, I1y, img_h, img_w, p};
  warp_kernel<6, true><<<blocks_for(n), THREADS, 0, stream>>>(planes, flow, h, w, n, out, setup);
  return (int)cudaGetLastError();
}

// R3's no-sweep mode: u0, v0, du and dv [nb, h, w]; out the flow [nb, h, w,
// 2], clipped to [-bound, bound] where clamp != 0.
extern "C" int dis_refine_nosweep(const float* u0, const float* v0, const float* du,
                                  const float* dv, int nb, int h, int w, int clamp, float bound,
                                  float* out, cudaStream_t stream) {
  if (!shape_ok(nb, h, w)) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)nb * h * w;
  sor_kernel<true><<<blocks_for(n), THREADS, 0, stream>>>(u0, v0, du, dv, n, clamp, bound, out);
  return (int)cudaGetLastError();
}

// R23: the half-sweeps j0 .. j0 + nh - 1 of a weight update, over tiles of
// ih x iw interior pixels (one launch).  ins: its thirteen inputs (the
// update's du and dv at 11 and 12), then the half-sweeps' start du and dv
// (the same two pointers in the update's first launch).  out [2, nb, h, w]
// (du, dv); in the compose mode (compose != 0) the flow [nb, h, w, 2],
// clipped to [-bound, bound] where clamp != 0.
extern "C" int dis_refine_update(const float* const* ins, int nb, int h, int w, int ih, int iw,
                                 int j0, int nh, float alpha, float delta, float gamma,
                                 float omega, int relax, int compose, int clamp, float bound,
                                 float* out, cudaStream_t stream) {
  if (!shape_ok(nb, h, w) || nb > 65535 || ih < 1 || iw < 1 || j0 < 0 || nh < 1 ||
      (clamp && !compose))
    return (int)cudaErrorInvalidValue;
  const int tiles_y = (h + ih - 1) / ih, tiles_x = (w + iw - 1) / iw;
  const int64_t tiles = (int64_t)tiles_x * tiles_y;
  const int64_t bytes = (int64_t)N_TILE_PLANES * sizeof(float) * 2 *
                        tile_half(tile_extent(h, ih, tiles_y, nh), tile_extent(w, iw, tiles_x, nh));
  const int limit = dis_shared_limit(update_granted, UPDATE_KERNELS);
  if (limit == 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  if (tiles > INT_MAX || bytes > limit ||
      (int64_t)tile_extent(h, ih, tiles_y, nh) * ((tile_extent(w, iw, tiles_x, nh) + 1) / 2) >
          UPDATE_PAIRS * UPDATE_THREADS)
    return (int)cudaErrorInvalidValue;
  UpdateArgs g;
  for (int k = 0; k < N_WEIGHT_IN; ++k) g.in[k] = ins[k];
  g.du = ins[N_WEIGHT_IN];
  g.dv = ins[N_WEIGHT_IN + 1];
  const UpdatePlan t = {ih, iw, tiles_x, j0, nh};
  const dim3 grid((unsigned)tiles, (unsigned)nb);
  if (compose)
    sor_kernel<true><<<grid, UPDATE_THREADS, bytes, stream>>>(g, h, w, t, alpha, delta, gamma,
                                                              omega, relax, clamp, bound, out);
  else
    sor_kernel<false><<<grid, UPDATE_THREADS, bytes, stream>>>(g, h, w, t, alpha, delta, gamma,
                                                               omega, relax, 0, 0.0f, out);
  return (int)cudaGetLastError();
}
