// B9b: backward of the attention half of a Swin block,
// x2 = x + m1 * proj(window_attention(LN1(x))), from the saved x and the
// gradient dx2 of the mid-block residual, on the window layout (BW, N, C).
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// _attn_bwd_call and _attn_bwd_call_emit (`_attn_bwd_kernel`,
// `_attn_bwd_emit_kernel`). The two TPU forms are one function: the emit form
// slices the heads and forms the weight gradients outside the kernel only
// because bias, dbias and the accumulators do not fit its scoped VMEM at
// C = 768. The TPU kernel holds a strip of windows and every accumulator in
// VMEM over a sequential grid; here it is a chain of launches, every product
// the port's own (fused_linear.cuh and the core below, which follows the
// forward's core in window_attention.cuh rounding for rounding),
// and the sums over all windows (dbias, the weight, bias and LayerNorm
// gradients) are atomic adds into outputs the wrapper has zeroed.
//
// Bound on the H100: operations, 22 C^2 flops a row of products with the
// weights (qkv recomputed 6, dao 2, dWproj 2, dWqkv 6, dxn1 6) plus 12 N C of
// attention (the scores, formed once, 2; the forward rows e . v 2; dp, dq,
// dk, dv 8) against 6 C bytes of x, dx2 and dx in bf16.
//
//   1. xn1   = round(LN1(x))                              ln_rows
//   2. qkv   = round(xn1 @ Wqkv + b)                      fused_linear
//   3. dproj = round(dx2 * m1[image]), dbproj = sum dproj scale_rows, col_sum
//   4. dao   = round(dproj @ Wproj^T)
//   5. core, one CTA per (window, head): the scores and exp(s - max) formed
//      once; from them the forward attention rows attn = (e . v) * inv and
//      p = e * inv; dp = dao . v^T, ds = p * (dp - sum(dp * p)), dbias += ds,
//      dq = (ds . k) * scale, dk = ds^T . q, dv = p^T . dao   -> dqkv (fp32)
//   6. dWproj = attn^T @ dproj
//   7. dbqkv = sum of the fp32 dqkv, which the same pass rounds to the
//      storage type; dWqkv = xn1^T @ round(dqkv)
//   8. dxn1 = round(dqkv) @ Wqkv^T (fp32)
//   9. dx = round(dx2 + LN1 backward(dxn1)), dg1, dbe1    ln_bwd
// The roundings are `_attn_bwd_kernel`'s: q * scale is a product in the
// storage type by the scale rounded to it; p, ds, dao and dqkv are rounded to
// the storage type before they enter a product, while dbias and dbqkv sum
// the fp32 values; dq is scaled by the fp32 scale after its product; the
// forward rows that feed dWproj are the forward's own, exp(s - max) rounded
// before the product with v and the division by the fp32 sum after it.
#include "backward_rows.cuh"
#include "fused_linear.cuh"
#include "window_attention.cuh"

namespace {

constexpr int kCoreThreads = 288;
constexpr int kDK = kHeadDim;

// The core of the backward for one (window, head) on the CUDA cores, in both
// types (products of the stored values in fp32): the two N x N matrices (p,
// then round(p); dp, then round(ds)) and k, v sit in shared memory as fp32,
// 205 KB at N = 144; q and dao rows are read from device memory (L1). The
// warp that takes a row's softmax also forms that row of the forward
// attention output, a lane per column of the head.
template <typename T>
__global__ void __launch_bounds__(kCoreThreads) attn_bwd_core_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao, const float* __restrict__ bias,
    const float* __restrict__ mask, T* __restrict__ attn, float* __restrict__ dqkv,
    float* __restrict__ dbias, int n, int c, int num_windows, float scale) {
  static_assert(kDK == 32, "a lane per column of the head");
  extern __shared__ float smem[];
  const int lds = n + 1;
  float* S = smem;                // n x lds: scores, p, round(p)
  float* D = S + n * lds;         // n x lds: dp, round(ds)
  float* ks = D + n * lds;        // n x (kDK + 1)
  float* vs = ks + n * (kDK + 1);
  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row0 = (long)w * n;
  const long c3 = 3L * c;
  const float scale_t = round_t<T>(scale);
  const T* q_base = qkv + row0 * c3 + (long)h * kDK;
  const T* dao_base = dao + row0 * c + (long)h * kDK;

  for (int idx = tid; idx < n * kDK; idx += kCoreThreads) {
    const int j = idx / kDK, d = idx % kDK;
    const T* base = q_base + j * c3 + d;
    ks[j * (kDK + 1) + d] = to_f<T>(base[c]);
    vs[j * (kDK + 1) + d] = to_f<T>(base[2L * c]);
  }
  __syncthreads();

  // scores and dp
  const float* bias_h = bias + (long)h * n * n;
  const float* mask_w = mask == nullptr ? nullptr : mask + (long)(w % num_windows) * n * n;
  for (int idx = tid; idx < n * n; idx += kCoreThreads) {
    const int i = idx / n, j = idx - i * n;
    const T* qrow = q_base + i * c3;
    const T* drow = dao_base + (long)i * c;
    const float* kj = ks + j * (kDK + 1);
    const float* vj = vs + j * (kDK + 1);
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < kDK; ++d) {
      s = fmaf(round_t<T>(to_f<T>(qrow[d]) * scale_t), kj[d], s);
      dp = fmaf(to_f<T>(drow[d]), vj[d], dp);
    }
    s += bias_h[idx];
    if (mask_w != nullptr) s += mask_w[idx];
    S[i * lds + j] = s;
    D[i * lds + j] = dp;
  }
  __syncthreads();

  // softmax, ds and dbias: a warp a row
  for (int i = warp; i < n; i += kCoreThreads / 32) {
    float* srow = S + i * lds;
    float* drow = D + i * lds;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    sum = row_warp_sum(sum);
    __syncwarp();
    float av = 0.f;  // the forward row: (round(e) . v) * inv
    for (int j = 0; j < n; ++j) av = fmaf(round_t<T>(srow[j]), vs[j * (kDK + 1) + lane], av);
    attn[(row0 + i) * c + (long)h * kDK + lane] = from_f<T>(av * (1.0f / sum));
    __syncwarp();  // every lane has read the row's e
    float dot = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = srow[j] / sum;
      srow[j] = p;
      dot = fmaf(drow[j], p, dot);
    }
    dot = row_warp_sum(dot);
    for (int j = lane; j < n; j += 32) {
      const float p = srow[j];
      const float ds = p * (drow[j] - dot);
      atomicAdd(dbias + ((long)h * n + i) * n + j, ds);
      srow[j] = round_t<T>(p);
      drow[j] = round_t<T>(ds);
    }
  }
  __syncthreads();

  // dq, dk, dv: thread (row, d) of each, lanes across d
  for (int idx = tid; idx < n * kDK; idx += kCoreThreads) {
    const int r = idx / kDK, d = idx % kDK;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    const float* drow = D + r * lds;
    for (int j = 0; j < n; ++j) dq = fmaf(drow[j], ks[j * (kDK + 1) + d], dq);
    dq *= scale;
    for (int i = 0; i < n; ++i) {
      const float qs = round_t<T>(to_f<T>(q_base[i * c3 + d]) * scale_t);
      dk = fmaf(D[i * lds + r], qs, dk);
      dv = fmaf(S[i * lds + r], to_f<T>(dao_base[(long)i * c + d]), dv);
    }
    const long at = (row0 + r) * c3 + (long)h * kDK + d;
    dqkv[at] = dq;
    dqkv[at + c] = dk;
    dqkv[at + 2L * c] = dv;
  }
}

// The same core for bf16 windows of 144 tokens on the tensor cores
// (nvcuda::wmma m16n16k16, fp32 accumulators): one CTA per (window, head),
// one warp per strip of 16 rows. q * scale (rounded), k, v and dao sit in
// shared memory as bf16, the two N x N matrices as fp32 (216 KB in all). A
// warp forms the scores and dp of its 16 query rows, takes the softmax and ds
// row by row across its lanes, adds ds into dbias and writes round(p) and
// round(ds) as bf16 over the start of their own fp32 rows, round(e) behind
// round(p) and the row's sum at the end of the score row; it then forms its
// rows of the forward attention output, (round(e) . v) / sum, through the
// columns of its dp rows that round(ds) left free; after a barrier it
// forms dq of its query rows (ds . k) and dk, dv of its 16 key rows (ds^T . q,
// p^T . dao: the transposes are column-major fragment loads) and stores them
// to the fp32 dqkv in device memory.
constexpr int kCoreLds = kWindowTokens + 8;  // fp32 row stride of the N x N matrices
constexpr size_t kCoreMmaSmem = 2 * (size_t)kWindowTokens * kCoreLds * sizeof(float) +
                                4 * (size_t)kWindowTokens * kAttnLd * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kCoreThreads) attn_bwd_core_mma_kernel(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dao,
    const float* __restrict__ bias, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ attn, float* __restrict__ dqkv, float* __restrict__ dbias, int c,
    int num_windows, float scale) {
  using namespace nvcuda;
  typedef __nv_bfloat16 T;
  constexpr int N = kWindowTokens, LD = kAttnLd, NT = N / 16, LDS = kCoreLds, LDP = 2 * LDS;
  constexpr int JT = (N + 31) / 32, KT = kDK / 16;
  static_assert(kCoreThreads == 32 * NT, "one warp per strip of 16 rows");
  // a score row of LDS floats holds N bf16 of round(p), N of round(e) and,
  // in its last float but one, the row's sum
  constexpr int SUM_AT = LDS - 2, PARK_AT = N / 2;
  static_assert(N <= SUM_AT && PARK_AT % 8 == 0 && PARK_AT + kDK <= LDS, "the rows' spare room");
  extern __shared__ __align__(128) unsigned char core_smem[];
  float* S = reinterpret_cast<float*>(core_smem);  // scores, then round(p) as bf16
  float* D = S + N * LDS;                          // dp, then round(ds) as bf16
  T* Qs = reinterpret_cast<T*>(D + N * LDS);       // round(q * scale)
  T* Ks = Qs + N * LD;
  T* Vs = Ks + N * LD;
  T* Gs = Vs + N * LD;                             // dao

  const int w = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, wt = threadIdx.x >> 5;
  const long row0 = (long)w * N;
  const long c3 = 3L * c;
  const float scale_t = round_t<T>(scale);

  for (int idx = threadIdx.x; idx < N * (kDK / 8); idx += kCoreThreads) {
    const int j = idx / (kDK / 8), ch = (idx % (kDK / 8)) * 8;
    const T* base = qkv + (row0 + j) * c3 + (long)h * kDK + ch;
    uint4 qraw = *reinterpret_cast<const uint4*>(base);
    T* q8 = reinterpret_cast<T*>(&qraw);
#pragma unroll
    for (int e = 0; e < 8; ++e) q8[e] = __float2bfloat16(__bfloat162float(q8[e]) * scale_t);
    *reinterpret_cast<uint4*>(Qs + j * LD + ch) = qraw;
    *reinterpret_cast<uint4*>(Ks + j * LD + ch) = *reinterpret_cast<const uint4*>(base + c);
    *reinterpret_cast<uint4*>(Vs + j * LD + ch) = *reinterpret_cast<const uint4*>(base + 2L * c);
    *reinterpret_cast<uint4*>(Gs + j * LD + ch) =
        *reinterpret_cast<const uint4*>(dao + (row0 + j) * c + (long)h * kDK + ch);
  }
  __syncthreads();

  // scores and dp of the warp's 16 query rows
  const int i0 = 16 * wt;
  float* Sw = S + i0 * LDS;
  float* Dw = D + i0 * LDS;
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fq[KT], fg[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      wmma::load_matrix_sync(fq[kk], Qs + i0 * LD + 16 * kk, LD);
      wmma::load_matrix_sync(fg[kk], Gs + i0 * LD + 16 * kk, LD);
    }
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_d;
      wmma::fill_fragment(acc_s, 0.0f);
      wmma::fill_fragment(acc_d, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fk, fv;
        wmma::load_matrix_sync(fk, Ks + 16 * jt * LD + 16 * kk, LD);
        wmma::load_matrix_sync(fv, Vs + 16 * jt * LD + 16 * kk, LD);
        wmma::mma_sync(acc_s, fq[kk], fk, acc_s);
        wmma::mma_sync(acc_d, fg[kk], fv, acc_d);
      }
      wmma::store_matrix_sync(Sw + 16 * jt, acc_s, LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(Dw + 16 * jt, acc_d, LDS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // softmax, ds and dbias row by row, the lanes across the columns
  const float* mask_w = mask == nullptr ? nullptr : mask + (long)(w % num_windows) * N * N;
  for (int r = 0; r < 16; ++r) {
    float* srow = Sw + r * LDS;
    float* drow = Dw + r * LDS;
    const long at = ((long)h * N + i0 + r) * N;
    const float* mrow = mask_w == nullptr ? nullptr : mask_w + (long)(i0 + r) * N;
    float sv[JT], dpv[JT];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      sv[t] = -CUDART_INF_F;
      dpv[t] = 0.f;
      if (j < N) {
        sv[t] = srow[j] + __ldg(bias + at + j);
        if (mrow != nullptr) sv[t] += __ldg(mrow + j);
        dpv[t] = drow[j];
        mx = fmaxf(mx, sv[t]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      sv[t] = lane + 32 * t < N ? expf(sv[t] - mx) : 0.f;
      sum += sv[t];
    }
    sum = row_warp_sum(sum);
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < JT; ++t) dot = fmaf(dpv[t], sv[t] / sum, dot);
    dot = row_warp_sum(dot);
    __syncwarp();  // every lane has read its columns of this row
    T* prow = reinterpret_cast<T*>(srow);
    T* dsrow = reinterpret_cast<T*>(drow);
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        const float p = sv[t] / sum;
        const float ds = p * (dpv[t] - dot);
        atomicAdd(dbias + at + j, ds);
        prow[j] = __float2bfloat16(p);
        prow[N + j] = __float2bfloat16(sv[t]);
        dsrow[j] = __float2bfloat16(ds);
      }
    }
    if (lane == 0) srow[SUM_AT] = sum;
  }
  __syncwarp();

  // the forward attention output of the warp's query rows: (round(e) . v),
  // parked as fp32 in the free columns of its dp rows, then divided by the sum
  {
    const T* E = reinterpret_cast<const T*>(Sw) + N;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KT];
#pragma unroll
    for (int nn = 0; nn < KT; ++nn) wmma::fill_fragment(acc[nn], 0.0f);
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fe;
      wmma::load_matrix_sync(fe, E + 16 * kt, LDP);
#pragma unroll
      for (int nn = 0; nn < KT; ++nn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + 16 * kt * LD + 16 * nn, LD);
        wmma::mma_sync(acc[nn], fe, fv, acc[nn]);
      }
    }
#pragma unroll
    for (int nn = 0; nn < KT; ++nn)
      wmma::store_matrix_sync(Dw + PARK_AT + 16 * nn, acc[nn], LDS, wmma::mem_row_major);
    __syncwarp();
    const int r = lane >> 1, c0 = (lane & 1) * (kDK / 2);
    const float inv = 1.0f / Sw[r * LDS + SUM_AT];
    T* orow = attn + (row0 + i0 + r) * c + (long)h * kDK + c0;
#pragma unroll
    for (int v8 = 0; v8 < kDK / 2; v8 += 8) {
      uint4 raw;
      T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e8 = 0; e8 < 8; ++e8)
        o[e8] = __float2bfloat16(Dw[r * LDS + PARK_AT + c0 + v8 + e8] * inv);
      *reinterpret_cast<uint4*>(orow + v8) = raw;
    }
  }
  __syncthreads();

  const T* P = reinterpret_cast<const T*>(S);
  const T* dS = reinterpret_cast<const T*>(D);
  float* out = dqkv + (row0 + i0) * c3 + (long)h * kDK;

  // dq of the warp's query rows: (ds . k) * scale
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[KT];
#pragma unroll
    for (int nn = 0; nn < KT; ++nn) wmma::fill_fragment(acc[nn], 0.0f);
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, dS + i0 * LDP + 16 * kt, LDP);
#pragma unroll
      for (int nn = 0; nn < KT; ++nn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Ks + 16 * kt * LD + 16 * nn, LD);
        wmma::mma_sync(acc[nn], fa, fb, acc[nn]);
      }
    }
#pragma unroll
    for (int nn = 0; nn < KT; ++nn) {
      for (int t = 0; t < acc[nn].num_elements; ++t) acc[nn].x[t] *= scale;
      wmma::store_matrix_sync(out + 16 * nn, acc[nn], (unsigned)c3, wmma::mem_row_major);
    }
  }

  // dk, dv of the warp's key rows: ds^T . q and p^T . dao
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[KT], acc_v[KT];
#pragma unroll
    for (int nn = 0; nn < KT; ++nn) {
      wmma::fill_fragment(acc_k[nn], 0.0f);
      wmma::fill_fragment(acc_v[nn], 0.0f);
    }
#pragma unroll
    for (int it = 0; it < NT; ++it) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> fds, fp;
      wmma::load_matrix_sync(fds, dS + 16 * it * LDP + i0, LDP);
      wmma::load_matrix_sync(fp, P + 16 * it * LDP + i0, LDP);
#pragma unroll
      for (int nn = 0; nn < KT; ++nn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fq, fg;
        wmma::load_matrix_sync(fq, Qs + 16 * it * LD + 16 * nn, LD);
        wmma::load_matrix_sync(fg, Gs + 16 * it * LD + 16 * nn, LD);
        wmma::mma_sync(acc_k[nn], fds, fq, acc_k[nn]);
        wmma::mma_sync(acc_v[nn], fp, fg, acc_v[nn]);
      }
    }
#pragma unroll
    for (int nn = 0; nn < KT; ++nn) {
      wmma::store_matrix_sync(out + c + 16 * nn, acc_k[nn], (unsigned)c3, wmma::mem_row_major);
      wmma::store_matrix_sync(out + 2L * c + 16 * nn, acc_v[nn], (unsigned)c3,
                              wmma::mem_row_major);
    }
  }
}

// bf16 windows of 144 tokens go to the tensor-core kernel, everything else to
// the CUDA-core one.
template <typename T>
cudaError_t launch_core(const void* qkv, const void* dao, const float* bias,
                        const float* mask, void* attn, float* dqkv, float* dbias, int bw, int n,
                        int c, int heads, int num_windows, float scale, cudaStream_t s) {
  dim3 grid(bw, heads);
  if (sizeof(T) == 2 && n == kWindowTokens) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_core_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kCoreMmaSmem);
    if (err != cudaSuccess) return err;
    attn_bwd_core_mma_kernel<<<grid, kCoreThreads, kCoreMmaSmem, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dao), bias,
        mask, static_cast<__nv_bfloat16*>(attn), dqkv, dbias, c, num_windows, scale);
    return cudaGetLastError();
  }
  const size_t smem = (2 * (size_t)n * (n + 1) + 2 * (size_t)n * (kDK + 1)) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_core_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_core_kernel<T><<<grid, kCoreThreads, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dao), bias, mask, static_cast<T*>(attn),
      dqkv, dbias, n, c, num_windows, scale);
  return cudaGetLastError();
}

struct AttnBwdArgs {
  const void *x, *dx2, *wqkv, *wproj;
  const float *g1, *b1, *bqkv, *bias, *mask, *m1;
  void *xn1, *qkv, *attn, *dproj, *dao, *dqkv_t, *dx;
  float *dqkv, *dxn1, *dwqkv, *dbqkv, *dwproj, *dbproj, *dg1, *dbe1, *dbias;
  int bw, n, c, heads, num_windows, windows_per_image, dtype;
  int qkv_form;  // the recomputed qkv product's tile form (bf16)
  float scale, eps;
};

template <typename T>
cudaError_t attn_bwd_typed(const AttnBwdArgs& p, cudaStream_t s) {
  const int rows = p.bw * p.n, c = p.c;
  cudaError_t err = launch_ln_rows<T>(p.x, p.g1, p.b1, p.xn1, rows, c, p.eps, s);
  if (err != cudaSuccess) return err;

  LinearArgs lin = {};
  lin.a = p.xn1; lin.w = p.wqkv; lin.bias = p.bqkv; lin.out = p.qkv;
  lin.M = rows; lin.N = 3 * c; lin.K = c;
  lin.a_map = kMapIdentity; lin.segs = 1; lin.eps = p.eps;
  if ((err = launch_linear_wide<T>(lin, p.qkv_form, s)) != cudaSuccess) return err;

  if ((err = launch_scale_rows<T>(p.dx2, p.m1, p.dproj, rows, c, p.windows_per_image * p.n,
                                  s)) != cudaSuccess)
    return err;
  if ((err = launch_col_sum<T, T>(p.dproj, p.dbproj, nullptr, rows, c, s)) != cudaSuccess)
    return err;
  GemmArgs dao = input_grad_args(p.dproj, p.wproj, rows, c, c);
  dao.out_t = p.dao;
  if ((err = launch_gemm<T>(dao, 1, s)) != cudaSuccess) return err;

  // fp32: the rounded dqkv is the fp32 dqkv itself
  void* dqkv_t = sizeof(T) == 4 ? static_cast<void*>(p.dqkv) : p.dqkv_t;
  if ((err = launch_core<T>(p.qkv, p.dao, p.bias, p.mask, p.attn, p.dqkv, p.dbias, p.bw, p.n,
                            c, p.heads, p.num_windows, p.scale, s)) != cudaSuccess)
    return err;
  if ((err = launch_weight_grad<T>(p.attn, p.dproj, p.dwproj, rows, c, c, s)) != cudaSuccess)
    return err;
  if ((err = launch_col_sum<float, T>(p.dqkv, p.dbqkv, sizeof(T) == 4 ? nullptr : p.dqkv_t,
                                      rows, 3 * c, s)) != cudaSuccess)
    return err;
  if ((err = launch_weight_grad<T>(p.xn1, dqkv_t, p.dwqkv, rows, c, 3 * c, s)) != cudaSuccess)
    return err;
  GemmArgs dxn = input_grad_args(dqkv_t, p.wqkv, rows, c, 3 * c);
  dxn.out_f = p.dxn1;
  if ((err = launch_gemm<T>(dxn, 1, s)) != cudaSuccess) return err;
  return launch_ln_bwd<T>(p.x, p.dxn1, p.g1, p.dx2, p.dx, p.dg1, p.dbe1, rows, c, p.eps, s);
}

}  // namespace

// x, dx2, dx (bw, n, c); wqkv (c, 3c), wproj (c, c) in the storage type; g1,
// b1, bqkv (may be null) fp32; bias (heads, n, n) fp32; mask (num_windows, n,
// n) fp32 or null; m1 (bw / windows_per_image) fp32. Scratch in the storage
// type: xn1, attn, dproj, dao (bw, n, c), qkv and dqkv_t (bw, n, 3c; dqkv_t
// unused in fp32); fp32: dqkv (bw, n, 3c), dxn1 (bw, n, c). Outputs dwqkv
// (c, 3c), dbqkv (3c), dwproj (c, c), dbproj (c), dg1, dbe1 (c), dbias
// (heads, n, n) are fp32 and must arrive zeroed. Heads of 32. qkv_form is the
// tile form of the recomputed qkv product (the launch plan's, ignored in fp32).
extern "C" int swin_attn_bwd_launch(
    const void* x, const void* dx2, const void* g1, const void* b1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bias, const void* mask, const void* m1,
    void* xn1, void* qkv, void* attn, void* dproj, void* dao, void* dqkv, void* dqkv_t,
    void* dxn1, void* dx, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dg1,
    void* dbe1, void* dbias, int bw, int n, int c, int heads, int num_windows,
    int windows_per_image, float scale, float eps, int qkv_form, int dtype, void* stream) {
  if (bw <= 0 || n <= 0 || c != heads * kDK || num_windows <= 0 || windows_per_image <= 0 ||
      bw % windows_per_image != 0)
    return cudaErrorInvalidValue;
  AttnBwdArgs p = {};
  p.x = x; p.dx2 = dx2; p.wqkv = wqkv; p.wproj = wproj;
  p.g1 = static_cast<const float*>(g1); p.b1 = static_cast<const float*>(b1);
  p.bqkv = static_cast<const float*>(bqkv); p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask); p.m1 = static_cast<const float*>(m1);
  p.xn1 = xn1; p.qkv = qkv; p.attn = attn; p.dproj = dproj; p.dao = dao;
  p.dqkv_t = dqkv_t; p.dx = dx;
  p.dqkv = static_cast<float*>(dqkv); p.dxn1 = static_cast<float*>(dxn1);
  p.dwqkv = static_cast<float*>(dwqkv); p.dbqkv = static_cast<float*>(dbqkv);
  p.dwproj = static_cast<float*>(dwproj); p.dbproj = static_cast<float*>(dbproj);
  p.dg1 = static_cast<float*>(dg1); p.dbe1 = static_cast<float*>(dbe1);
  p.dbias = static_cast<float*>(dbias);
  p.bw = bw; p.n = n; p.c = c; p.heads = heads; p.num_windows = num_windows;
  p.windows_per_image = windows_per_image; p.dtype = dtype; p.qkv_form = qkv_form;
  p.scale = scale; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return attn_bwd_typed<float>(p, s);
  if (dtype == kBFloat16) return attn_bwd_typed<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}
