// B11: the standalone window transition, a permuting copy of the window
// layout from one shift layout to another (the end-of-stage move back to
// shift 0 on the window-resident path; with the shifts swapped, its own VJP).
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// window_transition_fused, which gathers rows with one-hot P4 products on the
// MXU. Bound on the H100: bytes, each row read once and written once, no
// arithmetic on the data. Design: a warp moves a group of whole rows (about
// 256 16-byte chunks, up to 8 a lane, all loads issued before the stores);
// lane j of the warp computes the source row of the group's row j once, in
// 32-bit arithmetic, and the lanes read it by shuffle while they walk the
// group's chunks (a row of C = 192 bf16 is 24 chunks); the grid is sized to
// the card (four CTAs an SM) and loops over the groups.
#include <algorithm>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "window_layout.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32, kPerLane = 8;

// window_layout.cuh's map_row(kMapTransition) in 32-bit arithmetic: the row of
// the FROM layout that output row r of the TO layout reads
__device__ __forceinline__ int transition_source(int r, const Geometry& g) {
  const int n = g.window * g.window, wn = g.res / g.window, per_img = g.res * g.res;
  const int img = r / per_img, f = r - img * per_img;
  const int w = f / n, p = f - w * n;
  const int wy = w / wn, wx = w - wy * wn, py = p / g.window, px = p - py * g.window;
  int y = wy * g.window + py + g.delta, x = wx * g.window + px + g.delta;
  if (y >= g.res) y -= g.res;
  if (x >= g.res) x -= g.res;
  const int sy = y / g.window, sx = x / g.window;
  return ((img * wn + sy) * wn + sx) * n + (y - sy * g.window) * g.window + (x - sx * g.window);
}

__global__ void __launch_bounds__(kThreads)
    window_transition_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int rows,
                             int chunks_per_row, int group_rows, Geometry geo) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps * group_rows;
  for (int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * group_rows; r0 < rows;
       r0 += stride) {
    const int src = lane < group_rows && r0 + lane < rows ? transition_source(r0 + lane, geo) : 0;
    const int have = min(group_rows, rows - r0) * chunks_per_row;
    const uint4* from = x;
    uint4* to = out + (long)r0 * chunks_per_row;
    // chunk base + 32 k + lane of the group: row j of it, chunk ch of that row
    int j = lane / chunks_per_row, ch = lane - j * chunks_per_row;
    for (int base = 0; base < have; base += 32 * kPerLane) {
      uint4 v[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int s = __shfl_sync(0xffffffffu, src, j & 31);
        if (base + 32 * k + lane < have) v[k] = __ldg(from + (long)s * chunks_per_row + ch);
        ch += 32;
        while (ch >= chunks_per_row) {
          ch -= chunks_per_row;
          ++j;
        }
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int idx = base + 32 * k + lane;
        if (idx < have) to[idx] = v[k];
      }
    }
  }
}

}  // namespace

// x, out (rows, row_bytes) with row_bytes a multiple of 16 and both pointers
// 16-byte aligned; rows = images * res^2 in window layout; group_rows (1-32)
// rows a warp moves at a time (ops/swin_block_fused.py::
// transition_group_rows: about 32 * kPerLane chunks).
extern "C" int window_transition_launch(const void* x, void* out, long rows,
                                        int row_bytes, int res, int window,
                                        int delta, int group_rows, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || window <= 0 ||
      res % window != 0 || rows % ((long)res * res) != 0 || delta < 0 ||
      delta >= res || rows <= 0 || rows > INT_MAX / 2 || group_rows < 1 ||
      group_rows > 32 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  const int chunks_per_row = row_bytes / 16;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long groups = (rows + group_rows - 1) / group_rows;
  const long blocks = std::min<long>((groups + kWarps - 1) / kWarps, 4L * sms);
  window_transition_kernel<<<(unsigned)blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), (int)rows,
      chunks_per_row, group_rows, Geometry{res, window, delta});
  return cudaGetLastError();
}
