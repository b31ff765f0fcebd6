// B12: the int8 product of a w8a8 linear, y = (q(x) @ Wq^T) * (s_x * s_w) + b,
// fp32 out, q(x) = clip(rint(x / s_x), -127, 127) with one scale s_x for the
// whole tensor.
//
// Replaces on_device_image_captioning_tpu/ops/quant_matmul.py::
// quantized_matmul_pallas, which quantizes its activation tile in VMEM, runs
// the int8 MXU product with int32 accumulation and rescales in one pass. The
// numbers follow deploy/quantization.py::quantized_matmul, the function the
// JAX model runs: the quotient x / s_x is taken in x's own dtype when s_x is
// the dynamic scale (so rounded to bf16 for bf16 x), in fp32 when s_x is a
// calibrated fp32 scale; s_x itself (max|x| / 127 in x's dtype, or the
// calibrated value) comes in as a device scalar, computed by the wrapper, so
// no launch waits for the host.
//
// Bound on the H100: operations at the caption head's and the backbone's
// large products (2 M N K int8 ops at 1979 TOPS against M K + N K bytes in and
// 4 M N out), bytes at decode (M = 24 rows: the weight, read once, is all of
// it). Design: the shared product of int8_linear.cuh (int8 tensor cores,
// 128 x 128 tiles, x read in its own dtype and quantized in registers on the
// way to shared memory, so the int8 x never goes through device memory). It
// is the simple form: no wgmma, no TMA, one slab in flight; at M = 24 most of
// each 128-row tile is idle. PERF.md has its times beside the bound.
#include "int8_linear.cuh"

// x (M, K) fp32 or bf16; x_scale one fp32 value on the device; w_q (N, K)
// int8; w_scale (N) fp32; bias (N) fp32 or null; out (M, N) fp32; xq_out
// (M, K) int8 or null (the quantized x, for checks).
extern "C" int quant_matmul_launch(const void* x, const void* x_scale, int round_bf16,
                                   const void* w_q, const void* w_scale, const void* bias,
                                   void* out, void* xq_out, int M, int N, int K, int dtype,
                                   void* stream) {
  Int8LinearArgs p = {};
  p.a = x;
  p.a_scale = static_cast<const float*>(x_scale);
  p.a_scale_stride = 0;
  p.round_bf16 = round_bf16;
  p.w = static_cast<const int8_t*>(w_q);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.a_q_out = static_cast<int8_t*>(xq_out);
  p.M = M; p.N = N; p.K = K;
  p.epi = kEpiScale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_int8_linear<float, float>(p, s);
  if (dtype == kBFloat16) return launch_int8_linear<__nv_bfloat16, float>(p, s);
  return cudaErrorInvalidValue;
}
