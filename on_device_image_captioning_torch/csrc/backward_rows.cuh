// Row passes of the training backwards (csrc/swin_mlp_bwd.cu,
// csrc/swin_attn_bwd.cu): what the TPU backward kernels
// (ops/swin_block_fused.py `_mlp_bwd_kernel`, `_attn_bwd_kernel`) do between
// their matrix products. All are bound by bytes: a row is read, a few flops
// are spent on each value, a row is written.
//
//   rows_prep    xn = round(LN(x)): the recomputed LayerNorm output that
//                enters the first product and a weight gradient; beside it
//                d = round(dy * m[image of the row]) (dproj = dx2 * m1, dmlp
//                = dy * m2, rounded AFTER the scale) and the column sums of
//                the rounded d (dbproj, db2)
//   ln_bwd       `_ln_bwd` on fp32 xhat and rstd recomputed from x, with the
//                residual gradient added: dx = round(resid + dx_ln), and the
//                column sums dgamma, dbeta of fp32 values
//
// A warp takes a row at a time, a lane 8 columns at a time (16-byte chunks of
// the storage type: chunk lane, lane + 32, ... of the row, rows up to kRowMaxC).
// A CTA takes kRowPassRows rows, two to a warp; a column sum is a warp's
// register partials, added over its rows in order, then over the CTA's eight
// warps in order into row blockIdx.x of a (ceil(rows / kRowPassRows), c)
// partial, which sum_partials_kernel (fused_linear.cuh) adds up in order: no
// atomics, so two launches agree bit for bit.
#pragma once

#include "common.cuh"

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowPassRows = 16;  // rows of a CTA: 2 a warp (enough CTAs at 2304 rows)
constexpr int kRowMaxC = 1024;    // widest row (4 chunks a lane)

__device__ __forceinline__ float row_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// eight values of the storage type at p (16-byte aligned), as fp32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}
// rounded to the storage type
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// mean and 1 / sqrt(var + eps) of a row the warp holds in x (fp32, two passes)
template <int CPL>
__device__ __forceinline__ void row_stats8(const float (&x)[CPL][8], const bool (&ok)[CPL], int c,
                                           float eps, float* mean, float* rstd) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < CPL; ++t)
    if (ok[t])
#pragma unroll
      for (int e = 0; e < 8; ++e) s += x[t][e];
  const float mu = row_warp_sum(s) / c;
  float q = 0.f;
#pragma unroll
  for (int t = 0; t < CPL; ++t)
    if (ok[t])
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = x[t][e] - mu;
        q = fmaf(d, d, q);
      }
  *mean = mu;
  *rstd = 1.0f / sqrtf(row_warp_sum(q) / c + eps);
}

// The CTA's column sums: each warp's register partials (its chunks) through
// shared memory, added over the eight warps in order into part row blockIdx.x.
template <int CPL>
__device__ __forceinline__ void cta_col_sums(const float (&acc)[CPL][8], float (*red)[kRowMaxC],
                                             float* part, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int col = (lane + 32 * t) * 8;
    if (col < c)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[warp][col + e] = acc[t][e];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < c; col += kRowThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) s += red[w][col];
    part[static_cast<long>(blockIdx.x) * c + col] = s;
  }
  __syncthreads();
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kRowThreads) rows_prep_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    T* __restrict__ xn, const T* __restrict__ dy, const float* __restrict__ m,
    T* __restrict__ d, float* __restrict__ d_part, long rows, int c, int rows_per_image,
    float eps) {
  __shared__ float red[kRowWarps][kRowMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool ok[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) ok[t] = (lane + 32 * t) * 8 < c;
  float dsum[CPL][8];
#pragma unroll
  for (int t = 0; t < CPL; ++t)
#pragma unroll
    for (int e = 0; e < 8; ++e) dsum[t][e] = 0.f;
  const long rbeg =
      static_cast<long>(blockIdx.x) * kRowPassRows + warp * (kRowPassRows / kRowWarps);
  for (int i = 0; i < kRowPassRows / kRowWarps; ++i) {
    const long r = rbeg + i;
    if (r >= rows) break;
    float v[CPL][8], dv[CPL][8];
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (ok[t]) {
        load8(x + r * c + (lane + 32 * t) * 8, v[t]);
        load8(dy + r * c + (lane + 32 * t) * 8, dv[t]);
      }
    float mean, rstd;
    row_stats8<CPL>(v, ok, c, eps, &mean, &rstd);
    const float mr = m[r / rows_per_image];
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (ok[t]) {
        const int col = (lane + 32 * t) * 8;
        const float4* gp = reinterpret_cast<const float4*>(g + col);
        const float4* bp = reinterpret_cast<const float4*>(b + col);
        const float4 g4[2] = {gp[0], gp[1]}, b4[2] = {bp[0], bp[1]};
        const float* gf = reinterpret_cast<const float*>(g4);
        const float* bf = reinterpret_cast<const float*>(b4);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[t][e] = (v[t][e] - mean) * rstd * gf[e] + bf[e];
          dv[t][e] = round_t<T>(dv[t][e] * mr);
          dsum[t][e] += dv[t][e];
        }
        store8(xn + r * c + col, v[t]);
        store8(d + r * c + col, dv[t]);
      }
  }
  cta_col_sums<CPL>(dsum, red, d_part, c);
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kRowThreads) ln_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dxn, const float* __restrict__ g,
    const T* __restrict__ resid, T* __restrict__ dx, float* __restrict__ dg_part,
    float* __restrict__ db_part, long rows, int c, float eps) {
  __shared__ float red[kRowWarps][kRowMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool ok[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) ok[t] = (lane + 32 * t) * 8 < c;
  float dg[CPL][8], db[CPL][8];
#pragma unroll
  for (int t = 0; t < CPL; ++t)
#pragma unroll
    for (int e = 0; e < 8; ++e) dg[t][e] = db[t][e] = 0.f;
  const long rbeg =
      static_cast<long>(blockIdx.x) * kRowPassRows + warp * (kRowPassRows / kRowWarps);
  for (int i = 0; i < kRowPassRows / kRowWarps; ++i) {
    const long r = rbeg + i;
    if (r >= rows) break;
    float xh[CPL][8], dy[CPL][8];
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (ok[t]) {
        load8(x + r * c + (lane + 32 * t) * 8, xh[t]);
        load8(dxn + r * c + (lane + 32 * t) * 8, dy[t]);
      }
    float mean, rstd;
    row_stats8<CPL>(xh, ok, c, eps, &mean, &rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (ok[t]) {
        const int col = (lane + 32 * t) * 8;
        const float4* gp = reinterpret_cast<const float4*>(g + col);
        const float4 g4[2] = {gp[0], gp[1]};
        const float* gf = reinterpret_cast<const float*>(g4);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xh[t][e] = (xh[t][e] - mean) * rstd;
          dg[t][e] = fmaf(dy[t][e], xh[t][e], dg[t][e]);
          db[t][e] += dy[t][e];
          dy[t][e] *= gf[e];  // dxhat
          s1 += dy[t][e];
          s2 = fmaf(dy[t][e], xh[t][e], s2);
        }
      }
    const float m1 = row_warp_sum(s1) / c, m2 = row_warp_sum(s2) / c;
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (ok[t]) {
        const int col = (lane + 32 * t) * 8;
        float rv[8];
        load8(resid + r * c + col, rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) rv[e] += rstd * (dy[t][e] - m1 - xh[t][e] * m2);
        store8(dx + r * c + col, rv);
      }
  }
  cta_col_sums<CPL>(dg, red, dg_part, c);
  cta_col_sums<CPL>(db, red, db_part, c);
}

// The partial sums' rows: one per CTA of the row passes.
static inline int row_parts(long rows) {
  return static_cast<int>((rows + kRowPassRows - 1) / kRowPassRows);
}

template <typename T, int CPL>
static cudaError_t launch_rows_prep_c(const void* x, const float* g, const float* b, void* xn,
                                      const void* dy, const float* m, void* d, float* d_part,
                                      long rows, int c, int rows_per_image, float eps,
                                      cudaStream_t s) {
  rows_prep_kernel<T, CPL><<<row_parts(rows), kRowThreads, 0, s>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(xn), static_cast<const T*>(dy), m,
      static_cast<T*>(d), d_part, rows, c, rows_per_image, eps);
  return cudaGetLastError();
}

// xn = round(LN(x)), d = round(dy * m[row / rows_per_image]) and the column
// sums of d into d_part (row_parts(rows), c). c a multiple of 8, at most
// kRowMaxC.
template <typename T>
static cudaError_t launch_rows_prep(const void* x, const float* g, const float* b, void* xn,
                                    const void* dy, const float* m, void* d, float* d_part,
                                    long rows, int c, int rows_per_image, float eps,
                                    cudaStream_t s) {
  if (c % 8 != 0 || c > kRowMaxC || rows <= 0) return cudaErrorInvalidValue;
  if (c <= 256)
    return launch_rows_prep_c<T, 1>(x, g, b, xn, dy, m, d, d_part, rows, c, rows_per_image, eps, s);
  if (c <= 512)
    return launch_rows_prep_c<T, 2>(x, g, b, xn, dy, m, d, d_part, rows, c, rows_per_image, eps, s);
  if (c <= 768)
    return launch_rows_prep_c<T, 3>(x, g, b, xn, dy, m, d, d_part, rows, c, rows_per_image, eps, s);
  return launch_rows_prep_c<T, 4>(x, g, b, xn, dy, m, d, d_part, rows, c, rows_per_image, eps, s);
}

template <typename T, int CPL>
static cudaError_t launch_ln_bwd_c(const void* x, const float* dxn, const float* g,
                                   const void* resid, void* dx, float* dg_part, float* db_part,
                                   long rows, int c, float eps, cudaStream_t s) {
  ln_bwd_kernel<T, CPL><<<row_parts(rows), kRowThreads, 0, s>>>(
      static_cast<const T*>(x), dxn, g, static_cast<const T*>(resid), static_cast<T*>(dx),
      dg_part, db_part, rows, c, eps);
  return cudaGetLastError();
}

// dx = round(resid + LayerNorm backward(dxn)) and the column sums of dgamma,
// dbeta into dg_part, db_part (row_parts(rows), c).
template <typename T>
static cudaError_t launch_ln_bwd(const void* x, const float* dxn, const float* g,
                                 const void* resid, void* dx, float* dg_part, float* db_part,
                                 long rows, int c, float eps, cudaStream_t s) {
  if (c % 8 != 0 || c > kRowMaxC || rows <= 0) return cudaErrorInvalidValue;
  if (c <= 256)
    return launch_ln_bwd_c<T, 1>(x, dxn, g, resid, dx, dg_part, db_part, rows, c, eps, s);
  if (c <= 512)
    return launch_ln_bwd_c<T, 2>(x, dxn, g, resid, dx, dg_part, db_part, rows, c, eps, s);
  if (c <= 768)
    return launch_ln_bwd_c<T, 3>(x, dxn, g, resid, dx, dg_part, db_part, rows, c, eps, s);
  return launch_ln_bwd_c<T, 4>(x, dxn, g, resid, dx, dg_part, db_part, rows, c, eps, s);
}
