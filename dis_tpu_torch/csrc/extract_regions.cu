// K2 and K2b: per-patch sampling regions for one scale.
//
// Replaces the TPU kernel dis_tpu/ops/pallas/extract_kernel.py::
// extract_regions_pallas (kernel body `kern`), and its batched rule
// _run_vmap / kern_batched (K2b): nb pairs are one launch.  For each patch
// it copies the rc x rc window (rc = 2 ps + 3) of the padded level plane at
//   base = clip(ceil(pos0 + 1e-5f) + pad - ps - 2, 0, dim - rc)
// (the Q10 tap base in float32; a stripe's row0 is subtracted from the y
// base only) and writes the bases.  A pure copy: equal bitwise to the plain
// PyTorch version and to K2c.
//
// Bound on the H100: bytes.  At the 1080p finest scale it writes 82,944 x
// 361 floats (about 120 MB).  The device code is extract_group.cuh, shared
// with K2c; what it does about each cause of the earlier one-warp-per-patch
// design's 48% of the bound:
//   - no reuse between overlapping windows (each plane value read about 14
//     times at stride 5): a block stages a group of up to 48 patches of one
//     grid column, their bounding box, into shared memory once, and copies
//     each window out of it;
//   - 4-byte loads with little in flight: the box is staged by cp.async,
//     16 bytes a copy, and the next group's copies fly while the current
//     group is written (two stages in a persistent loop);
//   - 4-byte stores in runs not 16-byte aligned, a patch's first and last
//     sectors written by two warps: a group writes its regions as one
//     span of float4 streaming stores, scalars only at its ragged ends;
//   - e / rc for every element: a float4's (patch, row, col) come from a
//     table built once per block.
// num_h, the grid's column length, makes the groups follow the columns;
// without it (num_h = n) a group may straddle two columns, and the windows
// outside its staged rows are copied from device memory: the same bits.
// N = 0 launches nothing.
//
// A plane of fewer than rc rows or columns (a coarse level of a frame of
// under 24 rows or columns at ps 8) has no window of rc x rc: there the
// base is 0 on that axis and a window index past the plane reads its last
// row or column, the edge rule of the NumPy oracle's sampler
// (dis_tpu/oracle/reference_semantics.py::sample_patches clips every
// tap), which the plain version follows.  Such a plane holds a few dozen
// patches, so small_kernel copies them simply: one thread per region
// float over a 1-D grid, each clipping its own indices.

#include "extract_group.cuh"

namespace {

__global__ void __launch_bounds__(dis_extract::THREADS, dis_extract::MIN_BLOCKS)
extract_kernel(dis_extract::Args a) {
  dis_extract::extract_groups(a);
}

__global__ void __launch_bounds__(dis_extract::THREADS)
small_kernel(dis_extract::Args a, long long total) {
  const long long i = (long long)blockIdx.x * dis_extract::THREADS + threadIdx.x;
  if (i >= total) return;
  const int rc = 2 * a.ps + 3, rc2 = rc * rc;
  const long long k = i / rc2;                     // pair * n + patch
  const int e = (int)(i - k * rc2), r = e / rc, c = e - r * rc;
  const long long pair = k / ((long long)a.num_w * a.num_h);
  const int by = min(max(dis_ceil_coord(a.pos0[2 * k + 1]) + a.pad - a.row0 - a.ps - 2, 0),
                     max(a.th - rc, 0));
  const int bx = min(max(dis_ceil_coord(a.pos0[2 * k]) + a.pad - a.ps - 2, 0),
                     max(a.tw - rc, 0));
  if (e == 0) {
    a.base_y[k] = by;
    a.base_x[k] = bx;
  }
  a.regions[i] = a.img[pair * a.th * a.tw + (long long)min(by + r, a.th - 1) * a.tw +
                       min(bx + c, a.tw - 1)];
}

// small_kernel over every patch of a plane smaller than a region.
int launch_small(const dis_extract::Args& a, cudaStream_t stream) {
  const int rc = 2 * a.ps + 3;
  if (a.ps < 1 || rc > dis_extract::MAX_RC || a.nb < 0 || a.th < 1 || a.tw < 1 ||
      (long long)a.th * a.tw > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)a.nb * a.num_w * a.num_h * rc * rc;
  const long long blocks = (total + dis_extract::THREADS - 1) / dis_extract::THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    small_kernel<<<(unsigned)blocks, dis_extract::THREADS, 0, stream>>>(a, total);
  return (int)cudaGetLastError();
}

}  // namespace

// img [nb, th, tw] padded level planes whose first row is global row
// row0; pos0 [nb, n, 2] (x, y) start positions of an x-outer grid of
// columns of num_h patches (n a multiple of num_h); regions [nb, n, rc,
// rc], 16-byte aligned; base_y, base_x [nb, n] int32.  A plane of fewer
// than rc rows or columns takes small_kernel.
extern "C" int dis_extract_regions(const float* img, int nb, int th, int tw, const float* pos0,
                                   int n, int num_h, int ps, int pad, int row0, float* regions,
                                   int* base_y, int* base_x, cudaStream_t stream) {
  if (n < 0 || num_h < 0 || (num_h > 0 && n % num_h != 0)) return (int)cudaErrorInvalidValue;
  const dis_extract::Args a{img, th, tw, pos0, nb, num_h > 0 ? n / num_h : 0, num_h, ps, pad,
                            row0, regions, base_y, base_x, nullptr};
  const int rc = 2 * ps + 3;
  if (th < rc || tw < rc) return launch_small(a, stream);
  return dis_extract::launch<extract_kernel>(a, stream);
}

// The launch constants and the blocks an SM holds for ps, into out[7]
// (ops/cuda/extract_kernel.py keeps the same constants).
extern "C" int dis_extract_layout(int ps, int* out) {
  return dis_extract::layout<extract_kernel>(ps, out);
}
