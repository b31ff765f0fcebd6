// The int8 product of B13's two launches (B12 shares only i8_quantize):
//
//   out = epilogue(acc * (s_a[r] * w_scale[n]) + bias[n])
//   acc = sum_k q(A)[r, k] * Wq[n, k]          (int32, exact)
//
// A (M, K) is int8 already, or fp32 / bf16 quantized while its tile is loaded:
// q = clip(rint(A / s_a[r]), -127, 127), the quotient taken in fp32 (__fdiv_rn).
// s_a is one scale (stride 0) or one per row (the per-row scales of the int8
// MLP half); it may be given as row absmaxes,
// from which the kernel forms max(amax, 1e-8) / 127 as the TPU code does. Wq is
// (N, K) int8, k-contiguous like A, so both tiles move in 16-byte chunks.
//
// The products run on the int8 tensor cores (nvcuda::wmma m16n16k16, signed
// char in, int32 accumulators): 256 threads as 2 x 4 warps over a 128 x 128
// output tile, each warp 64 x 32 as 4 x 2 accumulators, K in slabs of 64. A
// slab sits in shared memory as four planes of 16 k-values ([plane][row][16]),
// so every fragment starts on a 32-byte boundary, as wmma's 8-bit loads need;
// the next slab is fetched into registers (and A quantized there) while the
// current one is multiplied.
//
// The epilogue is the TPU code's, in its order and without contraction:
// __fmul_rn(float(acc), __fmul_rn(s_a, w_scale)) then __fadd_rn(bias); then
//   kEpiGeluAmax  exact-erf GELU in fp32, fp32 out, and the row's absmax of
//                 the GELU output into row_amax by atomicMax on the float's
//                 bits (all >= 0, so their order is the ints'), for the next
//                 product's per-row scale (B13's fc1);
//   kEpiResidual  out = T(resid + T(v)) in the storage type T (B13's fc2).
// int32 cannot overflow: |acc| <= K * 127^2, under 2^31 for K < 133000.
#pragma once

#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

enum Int8Epilogue { kEpiGeluAmax = 1, kEpiResidual = 2 };

struct Int8LinearArgs {
  const void* a;          // (M, K): int8, or fp32 / bf16 quantized on load
  const float* a_scale;   // s_a of row r at a_scale[r * a_scale_stride]
  int a_scale_stride;     // 0: one scale for every row
  int a_scale_is_amax;    // a_scale holds absmaxes: s_a = max(amax, 1e-8) / 127
  const int8_t* w;        // (N, K) int8
  const float* w_scale;   // (N)
  const float* bias;      // (N) or null
  void* out;              // (M, N): fp32, or the storage type for kEpiResidual
  const void* resid;      // (M, N) storage type (kEpiResidual)
  float* row_amax;        // (M) fp32 set to 0 before the launch (kEpiGeluAmax)
  int M, N, K;
  int epi;
};

constexpr int kI8Threads = 256, kI8BM = 128, kI8BN = 128, kI8BK = 64;
constexpr int kI8Planes = kI8BK / 16;

__device__ __forceinline__ float i8_gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float i8_row_scale(const Int8LinearArgs& p, long r) {
  const float s = p.a_scale[r * p.a_scale_stride];
  return p.a_scale_is_amax ? __fdiv_rn(fmaxf(s, 1e-8f), 127.0f) : s;
}

// round_bf16: the quotient is rounded to bf16 before the rint (B12, where JAX
// divides in bf16)
__device__ __forceinline__ int8_t i8_quantize(float v, float s, int round_bf16) {
  float q = __fdiv_rn(v, s);
  if (round_bf16) q = __bfloat162float(__float2bfloat16_rn(q));
  q = fminf(fmaxf(rintf(q), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// One 16-value chunk of an A row, as loaded from device memory.
template <typename TA>
struct AChunk {
  static constexpr int kVecs = 16 * (int)sizeof(TA) / 16;  // uint4 per chunk
  uint4 v[kVecs];
};

template <typename TA, typename TO>
__global__ void __launch_bounds__(kI8Threads) int8_linear_kernel(Int8LinearArgs p) {
  using namespace nvcuda;
  constexpr int BM = kI8BM, BN = kI8BN, BK = kI8BK;
  // chunks of 16 k-values in a slab: A and W each 2 per thread
  constexpr int kPer = BM * (BK / 16) / kI8Threads;
  static_assert(BM == BN && kPer * kI8Threads == BM * (BK / 16), "tile");
  __shared__ __align__(128) int8_t As[kI8Planes][BM][16];
  __shared__ __align__(128) int8_t Bs[kI8Planes][BN][16];
  __shared__ __align__(32) int Cw[kI8Threads / 32][16 * 16];
  __shared__ float s_row[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 64 x 32 piece
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const TA* a = static_cast<const TA*>(p.a);

  for (int m = tid; m < BM; m += kI8Threads)
    s_row[m] = m0 + m < p.M ? i8_row_scale(p, m0 + m) : 0.f;
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  // chunk e of a slab: row e / 4, plane e % 4 (16 k-values each)
  AChunk<TA> ra[kPer];
  uint4 rb[kPer];
  bool a_ok[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kI8Threads, m = e / kI8Planes, kc = (e % kI8Planes) * 16;
      const long r = m0 + m;
      a_ok[i] = r < p.M && k0 + kc < p.K;
      if (a_ok[i]) {
        const uint4* src = reinterpret_cast<const uint4*>(a + r * p.K + k0 + kc);
#pragma unroll
        for (int v = 0; v < AChunk<TA>::kVecs; ++v) ra[i].v[v] = src[v];
      }
      const int n = e / kI8Planes;
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < p.N && k0 + kc < p.K)
        rb[i] = *reinterpret_cast<const uint4*>(p.w + (long)(n0 + n) * p.K + k0 + kc);
    }
  };
  auto stash = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kI8Threads, m = e / kI8Planes, plane = e % kI8Planes;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (a_ok[i]) {
        if constexpr (std::is_same<TA, int8_t>::value) {
          q = ra[i].v[0];
        } else {
          const TA* h = reinterpret_cast<const TA*>(ra[i].v);
          int8_t* qb = reinterpret_cast<int8_t*>(&q);
          const float s = s_row[m];
#pragma unroll
          for (int j = 0; j < 16; ++j) qb[j] = i8_quantize(to_f<TA>(h[j]), s, 0);
        }
      }
      *reinterpret_cast<uint4*>(&As[plane][m][0]) = q;
      *reinterpret_cast<uint4*>(&Bs[plane][e / kI8Planes][0]) = rb[i];
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    stash(k0);
    __syncthreads();
    if (k0 + BK < p.K) fetch(k0 + BK);
#pragma unroll
    for (int plane = 0; plane < kI8Planes; ++plane) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &As[plane][64 * wm + 16 * i][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[plane][32 * wn + 16 * j][0], 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: a lane takes 8 consecutive columns of one row of each 16 x 16
  // accumulator, passed through the warp's patch of shared memory
  int* patch = Cw[warp];
  const int pr = lane >> 1, pc = (lane & 1) * 8;
  TO* out = static_cast<TO*>(p.out);
  const TO* resid = static_cast<const TO*>(p.resid);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 64 * wm + 16 * i + pr;
    const long r = m0 + m;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int c0 = n0 + 32 * wn + 16 * j + pc;
      if (r < p.M) {
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = c0 + e;
          if (c >= p.N) break;
          const float mult = __fmul_rn(s_row[m], p.w_scale[c]);
          float v = __fmul_rn(__int2float_rn(patch[pr * 16 + pc + e]), mult);
          if (p.bias != nullptr) v = __fadd_rn(v, p.bias[c]);
          const long at = r * p.N + c;
          if (p.epi == kEpiGeluAmax) {
            v = i8_gelu(v);
            amax = fmaxf(amax, fabsf(v));
          }
          if (p.epi == kEpiResidual)
            out[at] = from_f<TO>(__fadd_rn(to_f<TO>(resid[at]), round_t<TO>(v)));
          else
            out[at] = from_f<TO>(v);
        }
        if (p.epi == kEpiGeluAmax)
          atomicMax(reinterpret_cast<int*>(p.row_amax + r), __float_as_int(amax));
      }
      __syncwarp();
    }
  }
}

// Launch on `stream`. K must be a multiple of 16 and A, W 16-byte aligned
// (the wrappers check); fp32 outputs only for kEpiGeluAmax.
template <typename TA, typename TO>
static cudaError_t launch_int8_linear(const Int8LinearArgs& p, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.K % 16 != 0 || p.a_scale == nullptr ||
      p.w_scale == nullptr)
    return cudaErrorInvalidValue;
  if (p.epi == kEpiResidual ? p.resid == nullptr
                            : !std::is_same<TO, float>::value)
    return cudaErrorInvalidValue;
  if (p.epi == kEpiGeluAmax && p.row_amax == nullptr) return cudaErrorInvalidValue;
  dim3 grid((unsigned)((p.M + kI8BM - 1) / kI8BM), (unsigned)((p.N + kI8BN - 1) / kI8BN));
  int8_linear_kernel<TA, TO><<<grid, kI8Threads, 0, stream>>>(p);
  return cudaGetLastError();
}
