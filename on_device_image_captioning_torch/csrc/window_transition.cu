// B11: the standalone window transition, a permuting copy of the window
// layout from one shift layout to another (the end-of-stage move back to
// shift 0 on the window-resident path).
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// window_transition_fused, which gathers rows with one-hot P4 products on the
// MXU. Bound on the H100: bytes, each row read once and written once, no
// arithmetic on the data. Design: one thread per 16-byte chunk of an output
// row; the source row comes from map_row(kMapTransition) (window_layout.cuh),
// so a warp reads and writes runs of consecutive 16-byte chunks (a row of
// C = 192 bf16 is 24 chunks).
#include <cstdint>

#include "common.cuh"
#include "window_layout.cuh"

__global__ void window_transition_kernel(const uint4* __restrict__ x,
                                         uint4* __restrict__ out, long chunks,
                                         int chunks_per_row, Geometry geo) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= chunks) return;
  const long r = idx / chunks_per_row;
  const int ch = (int)(idx % chunks_per_row);
  const long src = map_row(kMapTransition, r, 0, geo);
  out[idx] = x[src * chunks_per_row + ch];
}

// x, out (rows, row_bytes) with row_bytes a multiple of 16 and both pointers
// 16-byte aligned; rows = images * res^2 in window layout.
extern "C" int window_transition_launch(const void* x, void* out, long rows,
                                        int row_bytes, int res, int window,
                                        int delta, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || window <= 0 ||
      res % window != 0 || rows % ((long)res * res) != 0 || delta < 0 ||
      delta >= res || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  const int chunks_per_row = row_bytes / 16;
  const long chunks = rows * chunks_per_row;
  const int threads = 256;
  const long blocks = (chunks + threads - 1) / threads;
  window_transition_kernel<<<(unsigned)blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), chunks,
      chunks_per_row, Geometry{res, window, delta});
  return cudaGetLastError();
}
