// Row passes of the training backwards (csrc/swin_mlp_bwd.cu,
// csrc/swin_attn_bwd.cu): what the TPU backward kernels
// (ops/swin_block_fused.py `_mlp_bwd_kernel`, `_attn_bwd_kernel`) do between
// their matrix products. All are bound by bytes: a row is read, a few flops
// are spent on each value, a row is written.
//
//   ln_rows      xn = round(LN(x)): the recomputed LayerNorm output that
//                enters the first product and the weight gradient
//   scale_rows   out = round(in * m[image of the row]): dproj = dx2 * m1,
//                dmlp = dy * m2, rounded AFTER the scale
//   col_sum      out[c] += sum over rows of in[r, c] in fp32: the bias
//                gradients (of the rounded dproj, dmlp, dh1; of the fp32 dqkv,
//                which the pass also writes out rounded to the storage type)
//   ln_bwd       `_ln_bwd` on fp32 xhat and rstd recomputed from x, with the
//                residual gradient added: dx = round(resid + dx_ln), and
//                dgamma, dbeta summed over the rows in fp32
//
// Sums over all rows of the grid (col_sum, dgamma, dbeta) are per-CTA
// partials in registers or shared memory, added into the zeroed fp32 output
// with one atomicAdd per CTA and column.
#pragma once

#include "common.cuh"

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

__device__ __forceinline__ float row_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and 1 / sqrt(var + eps) of one row, by one warp (fp32, two passes)
template <typename T>
__device__ __forceinline__ void warp_row_stats(const T* row, int c, float eps, int lane,
                                               float* mean, float* rstd) {
  float s = 0.f;
  for (int j = lane; j < c; j += 32) s += to_f<T>(row[j]);
  const float mu = row_warp_sum(s) / c;
  float q = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float d = to_f<T>(row[j]) - mu;
    q = fmaf(d, d, q);
  }
  *mean = mu;
  *rstd = 1.0f / sqrtf(row_warp_sum(q) / c + eps);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads) ln_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    T* __restrict__ out, long rows, int c, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long r = (long)blockIdx.x * kRowWarps + warp;
  if (r >= rows) return;
  const T* row = x + r * c;
  float mean, rstd;
  warp_row_stats<T>(row, c, eps, lane, &mean, &rstd);
  for (int j = lane; j < c; j += 32)
    out[r * c + j] = from_f<T>((to_f<T>(row[j]) - mean) * rstd * g[j] + b[j]);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads) scale_rows_kernel(
    const T* __restrict__ in, const float* __restrict__ m, T* __restrict__ out, long total,
    int c, int rows_per_image) {
  const long per_image = (long)rows_per_image * c;
  for (long i = (long)blockIdx.x * kRowThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kRowThreads)
    out[i] = from_f<T>(to_f<T>(in[i]) * m[i / per_image]);
}

// A CTA sums kColRows rows of 32 columns: thread (cx, ry) walks rows ry,
// ry + 8, ... of column cx, the eight partials meet in shared memory.
constexpr int kColRows = 1024;

template <typename TIN, typename TOUT>
__global__ void __launch_bounds__(kRowThreads) col_sum_kernel(
    const TIN* __restrict__ in, float* __restrict__ out, TOUT* __restrict__ rounded, long rows,
    int n) {
  __shared__ float part[kRowWarps][33];
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + cx;
  const long r0 = (long)blockIdx.y * kColRows;
  const long r1 = r0 + kColRows < rows ? r0 + kColRows : rows;
  float s = 0.f;
  if (col < n)
    for (long r = r0 + ry; r < r1; r += kRowWarps) {
      const float v = to_f<TIN>(in[r * n + col]);
      s += v;
      if (rounded != nullptr) rounded[r * n + col] = from_f<TOUT>(v);
    }
  part[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && col < n) {
#pragma unroll
    for (int k = 1; k < kRowWarps; ++k) s += part[k][cx];
    atomicAdd(out + col, s);
  }
}

// A CTA takes kLnBwdRows rows, a warp a row at a time; dgamma and dbeta of
// the CTA's rows gather in shared memory (c <= kLnBwdMaxC).
constexpr int kLnBwdRows = 64;
constexpr int kLnBwdMaxC = 1024;

template <typename T>
__global__ void __launch_bounds__(kRowThreads) ln_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dxn, const float* __restrict__ g,
    const T* __restrict__ resid, T* __restrict__ dx, float* __restrict__ dgamma,
    float* __restrict__ dbeta, long rows, int c, float eps) {
  __shared__ float dg_s[kLnBwdMaxC], db_s[kLnBwdMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < c; j += kRowThreads) dg_s[j] = db_s[j] = 0.f;
  __syncthreads();
  const long r0 = (long)blockIdx.x * kLnBwdRows;
  for (int k = warp; k < kLnBwdRows; k += kRowWarps) {
    const long r = r0 + k;
    if (r >= rows) break;
    const T* row = x + r * c;
    const float* dy = dxn + r * c;
    float mean, rstd;
    warp_row_stats<T>(row, c, eps, lane, &mean, &rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float xhat = (to_f<T>(row[j]) - mean) * rstd;
      const float dyf = dy[j];
      atomicAdd(dg_s + j, dyf * xhat);
      atomicAdd(db_s + j, dyf);
      const float dxhat = dyf * g[j];
      s1 += dxhat;
      s2 = fmaf(dxhat, xhat, s2);
    }
    const float m1 = row_warp_sum(s1) / c, m2 = row_warp_sum(s2) / c;
    for (int j = lane; j < c; j += 32) {
      const float xhat = (to_f<T>(row[j]) - mean) * rstd;
      const float dxhat = dy[j] * g[j];
      const float d = rstd * (dxhat - m1 - xhat * m2);
      dx[r * c + j] = from_f<T>(to_f<T>(resid[r * c + j]) + d);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < c; j += kRowThreads) {
    atomicAdd(dgamma + j, dg_s[j]);
    atomicAdd(dbeta + j, db_s[j]);
  }
}

template <typename T>
static cudaError_t launch_ln_rows(const void* x, const float* g, const float* b, void* out,
                                  long rows, int c, float eps, cudaStream_t s) {
  ln_rows_kernel<T><<<(unsigned)((rows + kRowWarps - 1) / kRowWarps), kRowThreads, 0, s>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(out), rows, c, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_scale_rows(const void* in, const float* m, void* out, long rows,
                                     int c, int rows_per_image, cudaStream_t s) {
  const long total = rows * c;
  long blocks = (total + kRowThreads - 1) / kRowThreads;
  if (blocks > 4096) blocks = 4096;
  scale_rows_kernel<T><<<(unsigned)blocks, kRowThreads, 0, s>>>(
      static_cast<const T*>(in), m, static_cast<T*>(out), total, c, rows_per_image);
  return cudaGetLastError();
}

// `rounded` (rows, n) in TOUT takes a copy of the input as the pass reads it,
// or is null.
template <typename TIN, typename TOUT>
static cudaError_t launch_col_sum(const void* in, float* out, void* rounded, long rows, int n,
                                  cudaStream_t s) {
  dim3 grid((unsigned)((n + 31) / 32), (unsigned)((rows + kColRows - 1) / kColRows));
  col_sum_kernel<TIN, TOUT><<<grid, kRowThreads, 0, s>>>(
      static_cast<const TIN*>(in), out, static_cast<TOUT*>(rounded), rows, n);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_ln_bwd(const void* x, const float* dxn, const float* g,
                                 const void* resid, void* dx, float* dgamma, float* dbeta,
                                 long rows, int c, float eps, cudaStream_t s) {
  if (c > kLnBwdMaxC) return cudaErrorInvalidValue;
  ln_bwd_kernel<T><<<(unsigned)((rows + kLnBwdRows - 1) / kLnBwdRows), kRowThreads, 0, s>>>(
      static_cast<const T*>(x), dxn, g, static_cast<const T*>(resid), static_cast<T*>(dx),
      dgamma, dbeta, rows, c, eps);
  return cudaGetLastError();
}
