// B5: the MLP half of a Swin block, out = x + fc2(GELU(fc1(LN2(x)))) over
// flat rows (R, C).
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// swin_mlp_half_fused (dense branch, `_mlp_half_kernel`). The TPU kernel keeps
// a row tile's (rows, 4C) hidden activation in VMEM; a thread block here has
// 227 KB of shared memory and 64 K registers, and at C = 768 a 64-row tile's
// fp32 output accumulators alone are 196 KB.
//
// Bound on the H100: operations. 16 C^2 flops per row against 4 C bytes of x
// in and out (bf16) is 4 C flop/byte, 768 to 3072 at Swin-L's widths, far
// above the card's balance point. bf16 runs on the tensor cores through
// nvcuda::wmma, fp32 on the CUDA cores as full fp32 (fused_linear.cuh); both
// are still far under the bound that PERF.md states beside their times (no
// multi-stage pipeline, no wgmma yet).
//
// Design: two launches of the shared product at every width (C = 192, 384,
// 768), because one block cannot hold a useful row tile of both the hidden
// activation and the output accumulators:
//   1. hidden = GELU(LN2(x) @ W1 + b1)   LayerNorm prologue, GELU epilogue
//   2. out    = x + hidden @ W2 + b2     residual epilogue
// The hidden activation (R, 4C) goes through device memory once each way:
// 16 C bytes per row in bf16 beside the 4 C the function must move (at the
// card's memory rate under a tenth of the time the products take today).
// Keeping it on the chip (row tiles of 32 with the hidden dimension walked in
// chunks) is the next step for this kernel.
#include "fused_linear.cuh"

template <typename T>
static cudaError_t launch_typed(const void* x, const float* ln_g,
                                const float* ln_b, const void* w1,
                                const float* b1, const void* w2,
                                const float* b2, void* hidden, void* out,
                                int rows, int c, int hid, float eps,
                                const float* m2, int rows_per_image,
                                cudaStream_t s) {
  LinearArgs p = {};
  p.a = x; p.w = w1; p.bias = b1; p.ln_g = ln_g; p.ln_b = ln_b;
  p.out = hidden; p.M = rows; p.N = hid; p.K = c;
  p.a_map = kMapIdentity; p.segs = 1; p.eps = eps; p.gelu = 1;
  cudaError_t err = launch_linear_wide<T>(p, s);
  if (err != cudaSuccess) return err;
  LinearArgs q = {};
  q.a = hidden; q.w = w2; q.bias = b2; q.resid = x; q.resid_map = kMapIdentity;
  q.out = out; q.M = rows; q.N = c; q.K = hid;
  q.a_map = kMapIdentity; q.segs = 1; q.eps = eps;
  q.row_scale = m2; q.scale_rows = rows_per_image;
  return launch_linear_wide<T>(q, s);
}

static int mlp_half_dispatch(const void* x, const void* ln_g, const void* ln_b,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* hidden, void* out, int rows,
                             int c, int hid, float eps, const void* m2,
                             int rows_per_image, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fm2 = static_cast<const float*>(m2);
  if (dtype == kFloat32)
    return launch_typed<float>(x, g, b, w1, fb1, w2, fb2, hidden, out, rows, c,
                               hid, eps, fm2, rows_per_image, s);
  if (dtype == kBFloat16)
    return launch_typed<__nv_bfloat16>(x, g, b, w1, fb1, w2, fb2, hidden, out,
                                       rows, c, hid, eps, fm2, rows_per_image, s);
  return cudaErrorInvalidValue;
}

// x, out (rows, c); w1 (c, hid), w2 (hid, c) in the storage type; LayerNorm
// parameters and biases fp32; hidden is (rows, hid) scratch.
extern "C" int swin_mlp_half_launch(const void* x, const void* ln_g,
                                    const void* ln_b, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* hidden, void* out,
                                    int rows, int c, int hid, float eps,
                                    int dtype, void* stream) {
  return mlp_half_dispatch(x, ln_g, ln_b, w1, b1, w2, b2, hidden, out, rows, c,
                           hid, eps, nullptr, 1, dtype, stream);
}

// B10b, the training forward (`_mlp_half_train_fwd_call`): the same with the
// per-image stochastic-depth scale on the branch, out = x + m2[image] * mlp,
// where row r belongs to image r / rows_per_image; m2 is fp32 (rows /
// rows_per_image). The scale multiplies the rounded fc2 output in fp32 in
// launch 2's epilogue, before the residual add and its rounding.
extern "C" int swin_mlp_half_train_launch(const void* x, const void* ln_g,
                                          const void* ln_b, const void* w1,
                                          const void* b1, const void* w2,
                                          const void* b2, const void* m2,
                                          void* hidden, void* out, int rows,
                                          int c, int hid, int rows_per_image,
                                          float eps, int dtype, void* stream) {
  if (m2 == nullptr || rows_per_image <= 0 || rows % rows_per_image != 0)
    return cudaErrorInvalidValue;
  return mlp_half_dispatch(x, ln_g, ln_b, w1, b1, w2, b2, hidden, out, rows, c,
                           hid, eps, m2, rows_per_image, dtype, stream);
}
