// K1: Swin window-attention core on the flat qkv layout.
//
// Replaces on_device_image_captioning_tpu/ops/window_attention.py::
// window_attention_pallas and, on the same math, ops/swin_block_fused.py::
// attention_core_fused. For one window w and head h:
//   out[w, i, h*dk:(h+1)*dk] = softmax_j(q_i . k_j * scale + bias[h, i, j]
//                                        + mask[w % nW, i, j]) . v
// qkv is (BW, N, 3C) with columns [q | k | v] and per-head dk blocks inside
// each; bias is (H, N, N) fp32; mask is (nW, N, N) fp32 or null. Scores,
// softmax and accumulation are fp32; probabilities are rounded to the qkv
// dtype before P.V, as the Pallas kernel does.
//
// Bound on the H100: at Swin-L shapes (N = 144, dk = 32) the work is
// 4 * N^2 * dk flops per (window, head) against 4 * N * dk * itemsize bytes of
// q/k/v in and out, about 70 flop/byte in bf16 - below the tensor-core
// balance point (~295) but far above the fp32 CUDA-core one (~20), so this
// simple kernel is bound by CUDA-core fp32 throughput. Design: one CTA per
// (window, head); K and V (144 x 32 each, 18 KB in fp32) sit whole in
// shared memory; one thread per query row keeps q and the output row in
// registers, reads each K/V row as a shared-memory broadcast, and makes two
// passes over the keys (online max/sum, then normalized probabilities times
// V), so the N x N score matrix never exists in memory. That kernel
// (window_attention_kernel) serves fp32, whose products must stay fp32.
//
// bf16 windows of 144 tokens run on the tensor cores
// (window_attention_mma_kernel, built for N = 144): one CTA per (window,
// head) with one warp per strip of 16 query rows. K and V sit in shared
// memory as bf16; a warp forms its 16 x N scores with nvcuda::wmma
// (m16n16k16, fp32 accumulators) into its own fp32 patch of shared memory,
// adds the strip's bias and mask (contiguous runs, read coalesced), takes
// the softmax row by row across its lanes, writes the probabilities as bf16
// over the start of their own rows, and multiplies them with V on the tensor
// cores again. The score matrix exists only in shared memory (111 KB a CTA,
// two CTAs per SM), and bias and mask, not q/k/v, are most of the bytes a
// CTA reads.
//
// Two roundings, chosen by the template flag FUSED: false is
// window_attention_pallas's (q scaled in fp32, probabilities normalized, then
// rounded to the qkv dtype before P.V), which K1 and attention_core_fused's
// callers get; true is `_attention_rows`' (ops/swin_block_fused.py:408-438),
// which the attention half (csrc/swin_attn_half.cu) needs: the scale rounded
// to the qkv dtype and q scaled in that dtype, exp(s - max) rounded to the
// qkv dtype before the product with V, and the division by the fp32 sum
// after it.
#pragma once

#include <mma.h>

#include "common.cuh"

// Swin-L has dk = 32 at every stage; the only head width built and tested.
constexpr int kHeadDim = 32;

template <typename T, int DK, bool FUSED>
__global__ void window_attention_kernel(const T* __restrict__ qkv,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask,
                                        T* __restrict__ out, int n, int c,
                                        int num_windows, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;           // n * DK
  float* vs = smem + n * DK;  // n * DK
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const long row0 = (long)w * n;
  const long c3 = 3L * c;

  for (int idx = threadIdx.x; idx < n * DK; idx += blockDim.x) {
    const int j = idx / DK, d = idx % DK;
    const T* base = qkv + (row0 + j) * c3 + (long)h * DK + d;
    ks[idx] = to_f<T>(base[c]);
    vs[idx] = to_f<T>(base[2L * c]);
  }
  __syncthreads();

  const float* bias_h = bias + (long)h * n * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + (long)(w % num_windows) * n * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T* qrow = qkv + (row0 + i) * c3 + (long)h * DK;
    float q[DK];
#pragma unroll
    for (int d = 0; d < DK; ++d)
      q[d] = FUSED ? round_t<T>(to_f<T>(qrow[d]) * round_t<T>(scale))
                   : to_f<T>(qrow[d]) * scale;
    const float* brow = bias_h + (long)i * n;
    const float* mrow = mask_w == nullptr ? nullptr : mask_w + (long)i * n;

    // pass 1: running max and sum of exp over the keys
    float m = -CUDART_INF_F, l = 0.f;
    for (int j = 0; j < n; ++j) {
      const float* kj = ks + j * DK;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) s = fmaf(q[d], kj[d], s);
      s += __ldg(brow + j);
      if (mrow != nullptr) s += __ldg(mrow + j);
      const float mn = fmaxf(m, s);
      l = l * expf(m - mn) + expf(s - mn);
      m = mn;
    }

    // pass 2: probabilities rounded to T times V; normalized before the
    // rounding (FUSED false) or after the product (FUSED true)
    const float inv_l = 1.0f / l;
    float acc[DK];
#pragma unroll
    for (int d = 0; d < DK; ++d) acc[d] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float* kj = ks + j * DK;
      const float* vj = vs + j * DK;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) s = fmaf(q[d], kj[d], s);
      s += __ldg(brow + j);
      if (mrow != nullptr) s += __ldg(mrow + j);
      const float p = round_t<T>(FUSED ? expf(s - m) : expf(s - m) / l);
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(p, vj[d], acc[d]);
    }
    T* orow = out + (row0 + i) * c + (long)h * DK;
#pragma unroll
    for (int d = 0; d < DK; ++d)
      orow[d] = from_f<T>(FUSED ? acc[d] * inv_l : acc[d]);
  }
}

template <typename T, int DK, bool FUSED>
static cudaError_t launch_attention_typed(const void* qkv, const void* bias,
                                const void* mask, void* out, int bw, int n,
                                int c, int heads, int num_windows, float scale,
                                cudaStream_t stream) {
  const size_t smem = 2 * (size_t)n * DK * sizeof(float);
  int threads = ((n + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  dim3 grid(bw, heads);
  window_attention_kernel<T, DK, FUSED><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), n, c,
      num_windows, scale);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores ----------------------------------------------
constexpr int kWindowTokens = 144;     // the window the tensor-core kernel is built for
constexpr int kAttnLd = kHeadDim + 8;  // bf16 row stride of K and V in shared memory

template <bool FUSED, int N>
__global__ void __launch_bounds__(2 * N)
window_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            __nv_bfloat16* __restrict__ out, int c,
                            int num_windows, float scale) {
  using namespace nvcuda;
  typedef __nv_bfloat16 T;
  constexpr int DK = kHeadDim, LD = kAttnLd;
  constexpr int NT = N / 16;   // strips of 16 query rows = warps
  constexpr int LDS = N + 8;   // fp32 row stride of a score patch
  constexpr int LDP = 2 * LDS; // the same rows read as bf16 probabilities
  constexpr int JT = (N + 31) / 32;
  __shared__ __align__(128) T Ks[N * LD];
  __shared__ __align__(128) T Vs[N * LD];
  extern __shared__ __align__(128) float Sall[];  // N x LDS, then N row sums

  const int w = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, wt = threadIdx.x >> 5;
  const long row0 = (long)w * N;
  const long c3 = 3L * c;

  for (int idx = threadIdx.x; idx < N * (DK / 8); idx += blockDim.x) {
    const int j = idx / (DK / 8), ch = (idx % (DK / 8)) * 8;
    const T* base = qkv + (row0 + j) * c3 + (long)h * DK + ch + c;
    *reinterpret_cast<uint4*>(Ks + j * LD + ch) = *reinterpret_cast<const uint4*>(base);
    *reinterpret_cast<uint4*>(Vs + j * LD + ch) = *reinterpret_cast<const uint4*>(base + c);
  }
  __syncthreads();

  const int i0 = 16 * wt;
  float* S = Sall + i0 * LDS;
  float* L = Sall + N * LDS + i0;

  // scores of the strip: Q (16 x DK, read from device memory) . K^T (DK x N)
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fq[DK / 16];
    const float scale_t = round_t<T>(scale);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      wmma::load_matrix_sync(fq[kk], qkv + (row0 + i0) * c3 + (long)h * DK + 16 * kk,
                             (unsigned)c3);
      if (FUSED)  // q scaled in the storage type, by the scale rounded to it
        for (int t = 0; t < fq[kk].num_elements; ++t)
          fq[kk].x[t] = __float2bfloat16(__bfloat162float(fq[kk].x[t]) * scale_t);
    }
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, Ks + 16 * jt * LD + 16 * kk, LD);
        wmma::mma_sync(acc, fq[kk], fk, acc);
      }
      wmma::store_matrix_sync(S + 16 * jt, acc, LDS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // + bias + mask over the whole strip: its 16 rows of bias (and of mask) are
  // one contiguous run, read coalesced with many loads in flight
  {
    const float* brun = bias + ((long)h * N + i0) * N;
    const float* mrun =
        mask == nullptr ? nullptr : mask + ((long)(w % num_windows) * N + i0) * N;
#pragma unroll 8
    for (int idx = lane; idx < 16 * N; idx += 32) {
      const int r = idx / N, j = idx - r * N;
      float sv = (FUSED ? S[r * LDS + j] : S[r * LDS + j] * scale) + __ldg(brun + idx);
      if (mrun != nullptr) sv += __ldg(mrun + idx);
      S[r * LDS + j] = sv;
    }
  }
  __syncwarp();

  // softmax row by row, the lanes across the columns; the probabilities are
  // written as bf16 over the start of their own fp32 row (a column's bf16
  // lands on fp32 columns read in the same or an earlier step)
  for (int r = 0; r < 16; ++r) {
    float* srow = S + r * LDS;
    T* prow = reinterpret_cast<T*>(srow);
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      if (j < N) mx = fmaxf(mx, srow[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float e[JT];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      e[t] = j < N ? expf(srow[j] - mx) : 0.f;
      sum += e[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();  // every lane has read its columns of this row
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      // normalized before the rounding (FUSED false) or after the product
      if (j < N) prow[j] = __float2bfloat16(FUSED ? e[t] : e[t] / sum);
    }
    if (lane == 0) L[r] = sum;
  }
  __syncwarp();

  // P (16 x N) . V (N x DK), then the strip's output through the score patch
  {
    const T* P = reinterpret_cast<const T*>(S);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DK / 16];
#pragma unroll
    for (int nn = 0; nn < DK / 16; ++nn) wmma::fill_fragment(acc[nn], 0.0f);
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, P + 16 * kt, LDP);
#pragma unroll
      for (int nn = 0; nn < DK / 16; ++nn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + 16 * kt * LD + 16 * nn, LD);
        wmma::mma_sync(acc[nn], fp, fv, acc[nn]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int nn = 0; nn < DK / 16; ++nn)
      wmma::store_matrix_sync(S + 16 * nn, acc[nn], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  {
    const int r = lane >> 1, c0 = (lane & 1) * (DK / 2);
    const float inv = FUSED ? 1.0f / L[r] : 1.0f;  // division after the product
    T* orow = out + (row0 + i0 + r) * c + (long)h * DK + c0;
#pragma unroll
    for (int v8 = 0; v8 < DK / 2; v8 += 8) {
      uint4 raw;
      T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e8 = 0; e8 < 8; ++e8)
        o[e8] = __float2bfloat16(S[r * LDS + c0 + v8 + e8] * inv);
      *reinterpret_cast<uint4*>(orow + v8) = raw;
    }
  }
}

template <bool FUSED>
static cudaError_t launch_attention_mma(const void* qkv, const void* bias,
                                        const void* mask, void* out, int bw,
                                        int c, int heads, int num_windows,
                                        float scale, cudaStream_t stream) {
  constexpr int N = kWindowTokens;
  const size_t smem = (size_t)N * (N + 8) * sizeof(float) + N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_mma_kernel<FUSED, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bw, heads);
  window_attention_mma_kernel<FUSED, N><<<grid, 2 * N, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), c,
      num_windows, scale);
  return cudaGetLastError();
}

// qkv (BW, N, 3C) -> out (BW, N, C) on `stream`; dtype is a DType code. bf16
// windows the tensor-core kernel takes go to it, everything else to the
// CUDA-core kernel.
template <bool FUSED>
static cudaError_t launch_window_attention(const void* qkv, const void* bias,
                                           const void* mask, void* out, int bw,
                                           int n, int c, int heads,
                                           int num_windows, float scale,
                                           int dtype, cudaStream_t s) {
  if (heads * kHeadDim != c) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_attention_typed<float, kHeadDim, FUSED>(qkv, bias, mask, out, bw, n, c,
                                                heads, num_windows, scale, s);
  if (dtype == kBFloat16 && n == kWindowTokens)
    return launch_attention_mma<FUSED>(qkv, bias, mask, out, bw, c, heads,
                                       num_windows, scale, s);
  if (dtype == kBFloat16)
    return launch_attention_typed<__nv_bfloat16, kHeadDim, FUSED>(
        qkv, bias, mask, out, bw, n, c, heads, num_windows, scale, s);
  return cudaErrorInvalidValue;
}
