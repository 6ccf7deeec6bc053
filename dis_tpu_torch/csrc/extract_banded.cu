// K2c: per-patch sampling regions, column-banded (4K frames and stripes).
//
// Replaces the TPU kernel dis_tpu/ops/pallas/extract_kernel.py::
// extract_regions_banded (kernel body `kern`).  Same function as K2: each
// patch's rc x rc window (rc = 2 ps + 3) of the padded level plane at
//   base = clip(ceil(pos0 + 1e-5f) + pad - ps - 2, 0, dim - rc)
// (a stripe's row0 subtracted from the y base only), and the bases.  A
// pure copy: equal bitwise to the plain PyTorch version and to K2.
//
// The TPU kernel DMAs a full-height [th, 384] column band into VMEM per
// grid column; a 4K band is 3.3 MB and a Hopper block has at most 227 KB
// of shared memory, so the band does not carry over.  Here the patches are
// x-outer, so a grid column is contiguous and its bases spread in x only
// by the init flow; a block stages a group of up to 48 patches of one
// column, their bounding box, and copies the windows out of it.
//
// Bound on the H100: bytes (at the 4K finest scale it writes 331,776 x 361
// floats, about 479 MB).  The device code is extract_group.cuh, shared with
// K2; what it does about each cause of the earlier design's 34% of the
// bound:
//   - shared memory reserved for the static init bound (208 x 133 floats,
//     110,800 B a block for 16 patches): a stage now holds a fixed 9,216
//     floats for 48 patches (the box a 48-patch 4K group needs is about
//     258 x 24); a larger box is staged in part and the windows outside it
//     are copied from device memory (counted in *outside), so the result
//     never depends on the cap;
//   - warp 0 computing bases while 7 warps wait, then staging, then
//     copying, nothing overlapped: one thread per patch over all warps, and
//     the next group's cp.async copies (16 bytes a copy) fly while the
//     current group is written, in a persistent loop;
//   - a division by rc per element and 4-byte stores: a table built once
//     per block maps each float4 of the group's contiguous span to its
//     floats' (patch, row, col), written with float4 streaming stores.
// nb = 0, num_w = 0 or num_h = 0 launches nothing.

#include "extract_group.cuh"

namespace {

__global__ void __launch_bounds__(dis_extract::THREADS, dis_extract::MIN_BLOCKS)
banded_kernel(dis_extract::Args a) {
  dis_extract::extract_groups(a);
}

}  // namespace

// img [nb, th, tw] padded level planes whose first row is global row row0;
// pos0 [nb, n, 2] (x, y) start positions of an x-outer grid, n = num_w *
// num_h; regions [nb, n, rc, rc], 16-byte aligned; base_y, base_x [nb, n]
// int32.  outside, when not null, gets the count of windows copied from
// device memory.  Returns cudaGetLastError() after the launch.
extern "C" int dis_extract_banded(const float* img, int nb, int th, int tw, const float* pos0,
                                  int num_w, int num_h, int ps, int pad, int row0,
                                  float* regions, int* base_y, int* base_x, int* outside,
                                  cudaStream_t stream) {
  if (nb > 65535) return (int)cudaErrorInvalidValue;
  const dis_extract::Args a{img, th, tw, pos0, nb, num_w, num_h, ps, pad, row0,
                            regions, base_y, base_x, outside};
  return dis_extract::launch<banded_kernel>(a, stream);
}
