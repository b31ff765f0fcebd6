// The int8 quantize rule the two w8a8 kernels share: B12 (quant_matmul.cu),
// which replaces on_device_image_captioning_tpu/ops/quant_matmul.py::
// quantized_matmul_pallas, and B13 (swin_mlp_half_a8.cu), which replaces
// ops/swin_block_fused.py::_mlp_half_kernel_a8. Both TPU kernels quantize as
// the JAX model does:
//
//   q = clip(rint(v / s), -127, 127)      the quotient an IEEE fp32 division
//
// and B12's bf16 path rounds the quotient to bf16 before the rint, where JAX
// divides in bf16. Each kernel runs its own int8 product on the tensor cores
// (B12 mma.sync m16n8k32, B13 wgmma m64nNk32): this header holds only the
// rule, so that the two cannot round differently. It moves no bytes itself.
// i8_quantize_by gives i8_quantize's result (without the bf16 rounding) from
// a multiplication by the scale's reciprocal wherever that cannot change the
// rint, which is all but a few values in a million: an IEEE division is some
// twenty instructions, and B13 quantizes every one of its hidden values.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

// round_bf16: the quotient is rounded to bf16 before the rint (B12, where JAX
// divides in bf16)
__device__ __forceinline__ int8_t i8_quantize(float v, float s, int round_bf16) {
  float q = __fdiv_rn(v, s);
  if (round_bf16) q = __bfloat162float(__float2bfloat16_rn(q));
  q = fminf(fmaxf(rintf(q), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// clip(rint(v / s), -127, 127) as i8_quantize(v, s, 0) forms it, with inv =
// 1 / s: v * inv is within 1.5e-5 of v / s for |v / s| <= 128 (two roundings
// of 2^-24 relative), so its rint is the quotient's unless it lies within
// 1e-4 of a half-integer, where the division decides.
__device__ __forceinline__ int8_t i8_quantize_by(float v, float s, float inv) {
  float q = __fmul_rn(v, inv);
  if (fabsf(fabsf(q - rintf(q)) - 0.5f) < 1e-4f) q = __fdiv_rn(v, s);
  q = fminf(fmaxf(rintf(q), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}
