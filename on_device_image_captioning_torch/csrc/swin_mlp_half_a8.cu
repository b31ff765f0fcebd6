// B13: the MLP half of a Swin block with int8 activations and weights (w8a8),
// out = x + fc2(GELU(fc1(LN2(x)))) over flat rows (R, C), each product int8 x
// int8 with int32 accumulation and a per-row dynamic activation scale.
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// _mlp_half_kernel_a8 (reached through swin_mlp_half_fused on w8a8 nodes),
// which keeps a row tile's int8 rows and (rows, 4C) hidden activation in VMEM.
// Its arithmetic, step for step: LN2 with fp32 statistics, rounded to x's
// dtype; per row s = max(max|h|, 1e-8) / 127 and q = clip(rint(h / s)) in
// fp32; y = acc * (s_h * s1) + b1; GELU of the unrounded fp32 y (the exact
// erf here; the TPU kernel's polynomial erf is a Mosaic workaround); y
// quantized per row the same way; z = acc * (s_y * s2) + b2; out = x + T(z)
// in x's dtype T.
//
// Bound on the H100: operations, 4 C H int8 ops a row (H = 4C) against
// 4 C bytes of x in and out in bf16: 4 C ops a byte, far above the card's
// balance point. Design: a chain of three launches.
//   1. row pass: one warp a row; LN2, the row's absmax, the int8 row and its
//      scale; it also zeroes the row's hidden absmax;
//   2. int8 fc1 (int8_linear.cuh, A already int8) with the GELU epilogue: the
//      fp32 hidden row goes to device memory and its absmax to hmax;
//   3. int8 fc2, quantizing the fp32 hidden rows by max(hmax, 1e-8) / 127 as
//      it loads them, with the residual epilogue.
// The hidden activation goes through device memory in fp32 (16 H bytes a row
// each way, against 4 C that the function must move): keeping it on the chip
// needs the row's absmax before its first value is quantized, so a fused form
// would hold the whole (rows, 4C) fp32 tile or compute fc1 twice. That is the
// next step for this kernel; PERF.md has its times beside the bound.
#include "int8_linear.cuh"

__device__ __forceinline__ float a8_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float a8_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp a row: h = T(LN(x)), s = max(max|h|, 1e-8) / 127, q = clip(rint(h / s)).
template <typename T>
__global__ void ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
                                     const float* __restrict__ b, int8_t* __restrict__ xq,
                                     float* __restrict__ xs, float* __restrict__ hmax,
                                     int rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const long r = (long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* row = x + r * c;
  float s = 0.f;
  for (int k = lane; k < c; k += 32) s += to_f<T>(row[k]);
  const float mean = a8_warp_sum(s) / c;
  float q = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float d = to_f<T>(row[k]) - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = 1.0f / sqrtf(a8_warp_sum(q) / c + eps);
  auto ln = [&](int k) {
    return round_t<T>(__fadd_rn(__fmul_rn(__fmul_rn(to_f<T>(row[k]) - mean, rstd), g[k]), b[k]));
  };
  float amax = 0.f;
  for (int k = lane; k < c; k += 32) amax = fmaxf(amax, fabsf(ln(k)));
  const float scale = __fdiv_rn(fmaxf(a8_warp_max(amax), 1e-8f), 127.0f);
  for (int k = lane; k < c; k += 32) xq[r * c + k] = i8_quantize(ln(k), scale, 0);
  if (lane == 0) {
    xs[r] = scale;
    hmax[r] = 0.f;
  }
}

template <typename T>
static cudaError_t launch_typed(const void* x, const float* ln_g, const float* ln_b,
                                const void* w1q, const float* s1, const float* b1,
                                const void* w2q, const float* s2, const float* b2,
                                int8_t* xq, float* xs, float* hidden, float* hmax, void* out,
                                int rows, int c, int hid, float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = 8;
  ln_quant_rows_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                            s>>>(static_cast<const T*>(x), ln_g, ln_b, xq, xs, hmax, rows, c,
                                 eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Int8LinearArgs p = {};
  p.a = xq; p.a_scale = xs; p.a_scale_stride = 1;
  p.w = static_cast<const int8_t*>(w1q); p.w_scale = s1; p.bias = b1;
  p.out = hidden; p.row_amax = hmax;
  p.M = rows; p.N = hid; p.K = c; p.epi = kEpiGeluAmax;
  err = launch_int8_linear<int8_t, float>(p, s);
  if (err != cudaSuccess) return err;
  Int8LinearArgs q = {};
  q.a = hidden; q.a_scale = hmax; q.a_scale_stride = 1; q.a_scale_is_amax = 1;
  q.w = static_cast<const int8_t*>(w2q); q.w_scale = s2; q.bias = b2;
  q.out = out; q.resid = x;
  q.M = rows; q.N = c; q.K = hid; q.epi = kEpiResidual;
  return launch_int8_linear<float, T>(q, s);
}

// x, out (rows, c) fp32 or bf16; LayerNorm parameters fp32 (c); w1q (hid, c)
// and w2q (c, hid) int8 with fp32 scales (hid), (c) and biases (or null);
// scratch: xq (rows, c) int8, xs (rows) fp32, hidden (rows, hid) fp32, hmax
// (rows) fp32.
extern "C" int swin_mlp_half_a8_launch(const void* x, const void* ln_g, const void* ln_b,
                                       const void* w1q, const void* s1, const void* b1,
                                       const void* w2q, const void* s2, const void* b2,
                                       void* xq, void* xs, void* hidden, void* hmax, void* out,
                                       int rows, int c, int hid, float eps, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const float* fs1 = static_cast<const float*>(s1);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fs2 = static_cast<const float*>(s2);
  const float* fb2 = static_cast<const float*>(b2);
  int8_t* q = static_cast<int8_t*>(xq);
  float* fxs = static_cast<float*>(xs);
  float* fh = static_cast<float*>(hidden);
  float* fm = static_cast<float*>(hmax);
  if (rows <= 0 || c % 16 != 0 || hid % 16 != 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_typed<float>(x, g, b, w1q, fs1, fb1, w2q, fs2, fb2, q, fxs, fh, fm, out, rows,
                               c, hid, eps, s);
  if (dtype == kBFloat16)
    return launch_typed<__nv_bfloat16>(x, g, b, w1q, fs1, fb1, w2q, fs2, fb2, q, fxs, fh, fm, out,
                                       rows, c, hid, eps, s);
  return cudaErrorInvalidValue;
}
