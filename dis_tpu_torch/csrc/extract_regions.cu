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

#include "extract_group.cuh"

namespace {

__global__ void __launch_bounds__(dis_extract::THREADS, dis_extract::MIN_BLOCKS)
extract_kernel(dis_extract::Args a) {
  dis_extract::extract_groups(a);
}

}  // namespace

// img [nb, th, tw] padded level planes whose first row is global row
// row0; pos0 [nb, n, 2] (x, y) start positions of an x-outer grid of
// columns of num_h patches (n a multiple of num_h); regions [nb, n, rc,
// rc], 16-byte aligned; base_y, base_x [nb, n] int32.
extern "C" int dis_extract_regions(const float* img, int nb, int th, int tw, const float* pos0,
                                   int n, int num_h, int ps, int pad, int row0, float* regions,
                                   int* base_y, int* base_x, cudaStream_t stream) {
  if (n < 0 || num_h < 0 || (num_h > 0 && n % num_h != 0)) return (int)cudaErrorInvalidValue;
  const dis_extract::Args a{img, th, tw, pos0, nb, num_h > 0 ? n / num_h : 0, num_h, ps, pad,
                            row0, regions, base_y, base_x, nullptr};
  return dis_extract::launch<extract_kernel>(a, stream);
}

// The launch constants and the blocks an SM holds for ps, into out[7]
// (ops/cuda/extract_kernel.py keeps the same constants).
extern "C" int dis_extract_layout(int ps, int* out) {
  return dis_extract::layout<extract_kernel>(ps, out);
}
