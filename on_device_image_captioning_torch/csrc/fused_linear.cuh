// The matrix product the window-resident backbone kernels share:
//
//   out = epilogue(prologue(gather(A)) @ W)      A (.., K)  W (K, N)  out (M, N)
//
// written as device functions (gather_rows, row_stats, block_gemm, epilogue)
// and two kernels that string them together. The TPU kernels compute this
// product in their own bodies (`_linear`, ops/swin_block_fused.py:120), so it
// is hand-written here too: products of the stored values accumulated in
// fp32, no library GEMM.
//
//   gather    the A row of output row r is found by index arithmetic
//             (window_layout.cuh): identity, a window transition, raster ->
//             window layout, or the four rows of a 2x2 patch merge laid side
//             by side along K (segs = 4);
//   prologue  optional row LayerNorm over K (fp32 statistics, two passes,
//             result rounded to the storage type as the TPU kernel's `_ln`);
//   epilogue  + bias (fp32) and round; exact-erf GELU and round; + residual
//             row (gathered by its own map) and round; optional row
//             LayerNorm over N when one block holds whole output rows.
//
// Every rounding sits where the TPU kernels round (`_ln`, `_linear`,
// `_gelu_exact(...).astype`), so bf16 results agree with them to a bf16 ulp.
//
// Two kernels compute it, with the same gather, prologue and epilogue:
//
// fused_linear_kernel (fp32, and the patch embed in either type): 256 threads
//   as 16 x 16; a thread owns rows ty + 16 i and columns tx + 16 j of a
//   (16 TM) x (16 TN) block tile and walks K in slabs of 16 through shared
//   memory (A stored k-major so a warp reads it as broadcasts, W row-major so
//   a warp reads consecutive banks); fp32 FMAs, so fp32 inputs stay full fp32.
// fused_linear_mma_kernel (bf16): the same 128 x 96 block tile on the tensor
//   cores. Eight warps as 4 x 2, each holding a 32 x 48 piece as 2 x 3
//   nvcuda::wmma accumulators (m16n16k16, bf16 in, fp32 out); A and W slabs
//   of 32 go through shared memory as bf16, loaded 16 bytes a thread into
//   registers while the slab before is multiplied, the LayerNorm prologue
//   applied between the load and the store; each warp passes its
//   accumulators through a 16 x 16 fp32 patch of shared memory to apply the
//   epilogue, 8 consecutive columns a lane, stored as 16 bytes.
// See each .cu for what bounds it.
#pragma once

#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "window_layout.cuh"

constexpr int kThreads = 256;
constexpr int kBK = 16;

struct LinearArgs {
  const void* a;        // A source rows of length K / segs
  const void* w;        // (K, N) row-major, storage type
  const float* bias;    // (N) or null
  const float* ln_g;    // (K) LayerNorm prologue scale, null = no prologue
  const float* ln_b;    // (K)
  const void* resid;    // residual rows of length N, or null
  const float* ln2_g;   // (N) LayerNorm epilogue scale (LN_OUT kernels only)
  const float* ln2_b;   // (N)
  void* out;            // (M, N)
  int M, N, K;
  int a_map, resid_map, segs;
  Geometry geo;
  float eps;
  int gelu;
  // per-image scale on the product before the residual add (the training
  // forwards' stochastic-depth scale): row r takes row_scale[r / scale_rows];
  // null = 1
  const float* row_scale;
  int scale_rows;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// src_row[seg][m]: the A row that output row m0 + m reads, -1 past the end.
template <int BM>
__device__ __forceinline__ void gather_rows(const LinearArgs& p, long m0,
                                            long (*src_row)[BM]) {
  for (int idx = threadIdx.x; idx < p.segs * BM; idx += kThreads) {
    const int seg = idx / BM, m = idx % BM;
    const long r = m0 + m;
    src_row[seg][m] = r < p.M ? map_row(p.a_map, r, seg, p.geo) : -1;
  }
}

// Mean and 1/sqrt(var + eps) of each gathered A row (fp32, two passes). Eight
// lanes share a row and read it in 16-byte chunks, so a warp works on four
// rows at a time.
template <typename T, int BM>
__device__ __forceinline__ void row_stats(const LinearArgs& p,
                                          const long (*src_row)[BM],
                                          float* mean_s, float* rstd_s) {
  constexpr int V = 16 / sizeof(T);  // values in a chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & 7, grp = lane >> 3;
  const int ks = p.K / p.segs, chunks = ks / V;
  const T* a = static_cast<const T*>(p.a);
  for (int m = warp * 4 + grp; m < BM; m += kThreads / 8) {
    const bool ok = src_row[0][m] >= 0;
    float s = 0.f;
    if (ok)
      for (int seg = 0; seg < p.segs; ++seg) {
        const uint4* row = reinterpret_cast<const uint4*>(a + src_row[seg][m] * ks);
        for (int ch = sub; ch < chunks; ch += 8) {
          const uint4 raw = row[ch];
          const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < V; ++j) s += to_f<T>(h[j]);
        }
      }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / p.K;
    float q = 0.f;
    if (ok)
      for (int seg = 0; seg < p.segs; ++seg) {
        const uint4* row = reinterpret_cast<const uint4*>(a + src_row[seg][m] * ks);
        for (int ch = sub; ch < chunks; ch += 8) {
          const uint4 raw = row[ch];
          const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float d = to_f<T>(h[j]) - mean;
            q = fmaf(d, d, q);
          }
        }
      }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    if (sub == 0) {
      mean_s[m] = ok ? mean : 0.f;
      rstd_s[m] = ok ? 1.0f / sqrtf(q / p.K + p.eps) : 0.f;
    }
  }
}

// One output value through the epilogue: + bias and round; GELU and round;
// + residual and round. `res` is the residual value (ignored without one) and
// `m` the row's scale on the rounded product (1 without one: res + 1 * v is
// res + v exactly).
template <typename T>
__device__ __forceinline__ float epilogue(const LinearArgs& p, float v, int c,
                                          bool has_resid, float res, float m) {
  if (p.bias != nullptr) v += p.bias[c];
  v = round_t<T>(v);
  if (p.gelu) v = round_t<T>(gelu_exact(v));
  if (has_resid) v = round_t<T>(res + m * v);
  return v;
}

__device__ __forceinline__ float row_scale_of(const LinearArgs& p, long r) {
  return p.row_scale == nullptr ? 1.0f : p.row_scale[r / p.scale_rows];
}

// acc += As^T . Bs for one K slab already in shared memory.
template <int TM, int TN>
__device__ __forceinline__ void block_gemm(float (&acc)[TM][TN],
                                           const float (*As)[16 * TM + 1],
                                           const float (*Bs)[16 * TN], int ty,
                                           int tx) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, int TM, int TN, bool LN_OUT>
__global__ void __launch_bounds__(kThreads) fused_linear_kernel(LinearArgs p) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  __shared__ float As[kBK][BM + 1];
  __shared__ float Bs[kBK][BN];
  __shared__ long src_row[4][BM];
  __shared__ float mean_s[BM], rstd_s[BM];
  __shared__ float Cs[LN_OUT ? BM : 1][LN_OUT ? BN + 1 : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ks = p.K / p.segs;  // length of one gathered A row
  const T* a = static_cast<const T*>(p.a);
  const T* w = static_cast<const T*>(p.w);

  gather_rows<BM>(p, m0, src_row);
  __syncthreads();
  if (p.ln_g != nullptr) {
    row_stats<T, BM>(p, src_row, mean_s, rstd_s);
    __syncthreads();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    const int seg = k0 / ks;  // a slab never straddles two gathered rows
    const int kseg = k0 - seg * ks;
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int kk = e % kBK, m = e / kBK;
      const long src = src_row[seg][m];
      float v = 0.f;
      if (src >= 0) {
        v = to_f<T>(a[src * ks + kseg + kk]);
        if (p.ln_g != nullptr)
          v = round_t<T>((v - mean_s[m]) * rstd_s[m] * p.ln_g[k0 + kk] +
                         p.ln_b[k0 + kk]);
      }
      As[kk][m] = v;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int n = e % BN, kk = e / BN;
      Bs[kk][n] = n0 + n < p.N ? to_f<T>(w[(long)(k0 + kk) * p.N + n0 + n]) : 0.f;
    }
    __syncthreads();
    block_gemm<TM, TN>(acc, As, Bs, ty, tx);
    __syncthreads();
  }

  const T* resid = static_cast<const T*>(p.resid);
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
    const long rr = resid == nullptr ? 0 : map_row(p.resid_map, r, 0, p.geo);
    const float m = row_scale_of(p, r);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= p.N) continue;
      const bool has_resid = resid != nullptr;
      const float v = epilogue<T>(
          p, acc[i][j], c, has_resid, has_resid ? to_f<T>(resid[rr * p.N + c]) : 0.f, m);
      if constexpr (LN_OUT)
        Cs[ty + 16 * i][tx + 16 * j] = v;
      else
        out[r * p.N + c] = from_f<T>(v);
    }
  }

  if constexpr (LN_OUT) {  // one block holds whole output rows (N <= BN)
    __syncthreads();
    for (int m = warp; m < BM; m += kThreads / 32) {
      const long r = m0 + m;
      if (r >= p.M) continue;
      float s = 0.f;
      for (int c = lane; c < p.N; c += 32) s += Cs[m][c];
      const float mean = warp_sum(s) / p.N;
      float q = 0.f;
      for (int c = lane; c < p.N; c += 32) {
        const float d = Cs[m][c] - mean;
        q = fmaf(d, d, q);
      }
      const float rstd = 1.0f / sqrtf(warp_sum(q) / p.N + p.eps);
      for (int c = lane; c < p.N; c += 32)
        out[r * p.N + c] =
            from_f<T>((Cs[m][c] - mean) * rstd * p.ln2_g[c] + p.ln2_b[c]);
    }
  }
}

// The bf16 product on the tensor cores (see the head of this file).
constexpr int kMmaBM = 128, kMmaBN = 96, kMmaBK = 32;
constexpr int kLdA = kMmaBK + 8, kLdB = kMmaBN + 8;  // bf16 elements, 16-byte rows

__global__ void __launch_bounds__(kThreads) fused_linear_mma_kernel(LinearArgs p) {
  using namespace nvcuda;
  typedef __nv_bfloat16 T;
  constexpr int BM = kMmaBM, BN = kMmaBN, BK = kMmaBK;
  __shared__ __align__(32) T As[BM][kLdA];
  __shared__ __align__(32) T Bs[BK][kLdB];
  __shared__ __align__(32) float Cw[kThreads / 32][16 * 16];
  __shared__ long src_row[4][BM];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's 32 x 48 piece
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ks = p.K / p.segs;
  const T* a = static_cast<const T*>(p.a);
  const T* w = static_cast<const T*>(p.w);
  const bool ln = p.ln_g != nullptr;

  gather_rows<BM>(p, m0, src_row);
  __syncthreads();
  if (ln) {
    row_stats<T, BM>(p, src_row, mean_s, rstd_s);
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // Slabs move in 16-byte chunks of 8 values, a thread taking every 256th
  // chunk (so all of its A chunks share their 8 columns of the slab). A slab
  // is fetched into registers while the one before it is multiplied, and
  // goes to shared memory (through the LayerNorm) after it.
  constexpr int kChunksA = BK / 8, kChunksB = BN / 8;
  constexpr int kPerA = BM * kChunksA / kThreads;
  constexpr int kPerB = (BK * kChunksB + kThreads - 1) / kThreads;
  static_assert(kThreads % kChunksA == 0, "a thread's A chunks share their columns");
  const int kc = (tid % kChunksA) * 8;
  uint4 ra[kPerA], rb[kPerB];
  float4 g[2], b[2];  // LayerNorm scale and bias of the thread's 8 columns
  auto fetch = [&](int k0) {
    const int seg = k0 / ks;  // a slab never straddles two gathered rows
    const int kseg = k0 - seg * ks;
#pragma unroll
    for (int i = 0; i < kPerA; ++i) {
      const long src = src_row[seg][(tid + i * kThreads) / kChunksA];
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (src >= 0) ra[i] = *reinterpret_cast<const uint4*>(a + src * ks + kseg + kc);
    }
#pragma unroll
    for (int i = 0; i < kPerB; ++i) {
      const int e = tid + i * kThreads;
      const int nc = (e % kChunksB) * 8, kk = e / kChunksB;
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kk < BK && n0 + nc < p.N)
        rb[i] = *reinterpret_cast<const uint4*>(w + (long)(k0 + kk) * p.N + n0 + nc);
    }
    if (ln) {
      const float4* gp = reinterpret_cast<const float4*>(p.ln_g + k0 + kc);
      const float4* bp = reinterpret_cast<const float4*>(p.ln_b + k0 + kc);
      g[0] = gp[0], g[1] = gp[1], b[0] = bp[0], b[1] = bp[1];
    }
  };
  auto stash = [&]() {
    const float* gf = reinterpret_cast<const float*>(g);
    const float* bf = reinterpret_cast<const float*>(b);
#pragma unroll
    for (int i = 0; i < kPerA; ++i) {
      const int m = (tid + i * kThreads) / kChunksA;
      if (ln && src_row[0][m] >= 0) {
        T* h = reinterpret_cast<T*>(&ra[i]);
        const float mean = mean_s[m], rstd = rstd_s[m];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          h[j] = __float2bfloat16((__bfloat162float(h[j]) - mean) * rstd * gf[j] + bf[j]);
      }
      *reinterpret_cast<uint4*>(&As[m][kc]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kPerB; ++i) {
      const int e = tid + i * kThreads;
      const int nc = (e % kChunksB) * 8, kk = e / kChunksB;
      if (kk < BK) *reinterpret_cast<uint4*>(&Bs[kk][nc]) = rb[i];
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < p.K) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[3];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[32 * wm + 16 * i][kk], kLdA);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk][48 * wn + 16 * j], kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: a lane takes 8 consecutive columns of one row of each 16 x 16
  // accumulator, passed through the warp's patch of shared memory
  const T* resid = static_cast<const T*>(p.resid);
  T* out = static_cast<T*>(p.out);
  float* patch = Cw[warp];
  const int pr = lane >> 1, pc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long r = m0 + 32 * wm + 16 * i + pr;
    const bool row_ok = r < p.M;
    const long rr = (row_ok && resid != nullptr) ? map_row(p.resid_map, r, 0, p.geo) : 0;
    const float m = row_ok ? row_scale_of(p, r) : 1.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int c = n0 + 48 * wn + 16 * j + pc;
      if (row_ok && c < p.N) {
        uint4 res_raw = make_uint4(0u, 0u, 0u, 0u);
        if (resid != nullptr)
          res_raw = *reinterpret_cast<const uint4*>(resid + rr * p.N + c);
        const T* res = reinterpret_cast<const T*>(&res_raw);
        float4 acc4[2];
        acc4[0] = *reinterpret_cast<const float4*>(patch + pr * 16 + pc);
        acc4[1] = *reinterpret_cast<const float4*>(patch + pr * 16 + pc + 4);
        const float* accf = reinterpret_cast<const float*>(acc4);
        uint4 out_raw;
        T* o = reinterpret_cast<T*>(&out_raw);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = __float2bfloat16(epilogue<T>(p, accf[e], c + e, resid != nullptr,
                                              __bfloat162float(res[e]), m));
        *reinterpret_cast<uint4*>(out + r * p.N + c) = out_raw;
      }
      __syncwarp();
    }
  }
}

// Launch on `stream`; the K slabs must not straddle gathered rows.
template <typename T, int TM, int TN, bool LN_OUT>
static cudaError_t launch_linear(const LinearArgs& p, cudaStream_t stream) {
  if (p.M <= 0 || p.segs < 1 || p.segs > 4 || p.K % p.segs != 0 ||
      (p.K / p.segs) % kBK != 0)
    return cudaErrorInvalidValue;
  if (LN_OUT && (p.N > 16 * TN || p.ln2_g == nullptr)) return cudaErrorInvalidValue;
  dim3 grid((unsigned)((p.M + 16 * TM - 1) / (16 * TM)),
            (unsigned)((p.N + 16 * TN - 1) / (16 * TN)));
  fused_linear_kernel<T, TM, TN, LN_OUT><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The 128 x 96 tile for the large products (every width of Swin-L is a
// multiple of 96): fp32 on the CUDA cores, bf16 on the tensor cores.
template <typename T>
static cudaError_t launch_linear_wide(const LinearArgs& p, cudaStream_t s) {
  return launch_linear<T, 8, 6, false>(p, s);
}
template <>
cudaError_t launch_linear_wide<__nv_bfloat16>(const LinearArgs& p, cudaStream_t s) {
  // 16-byte accesses: rows of A, W, the residual and the output start on
  // multiples of 8 values, and no K slab straddles two gathered rows
  if (p.M <= 0 || p.segs < 1 || p.segs > 4 || p.K % p.segs != 0 ||
      (p.K / p.segs) % kMmaBK != 0 || p.N % 8 != 0)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)((p.M + kMmaBM - 1) / kMmaBM),
            (unsigned)((p.N + kMmaBN - 1) / kMmaBN));
  fused_linear_mma_kernel<<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}
// 32 x 192 with the row-LayerNorm epilogue for the patch embed, whose output
// row is 192 wide (bound by bytes: CUDA cores in both types).
template <typename T>
static cudaError_t launch_linear_rows(const LinearArgs& p, cudaStream_t s) {
  return launch_linear<T, 2, 12, true>(p, s);
}

// ---------------------------------------------------------------------------
// The products of the training backwards. The TPU backward kernels
// (ops/swin_block_fused.py `_mlp_bwd_kernel`, `_attn_bwd_kernel`) form, beside
// x @ W, the two shapes a forward never needs:
//   dY @ W^T   contract over the OUTPUT width of W (the input gradients), and
//   A^T @ B    reduced over the rows (the weight gradients, fp32 sums).
// One kernel serves all three: operands are addressed by strides,
//   A(m, k) = a[m * sam + k * sak]     B(k, n) = b[k * sbk + n * sbn],
// so a transpose is a swap of two strides. Products of the stored values are
// summed in fp32 (fp32 inputs on the CUDA cores as full fp32, bf16 inputs on
// the tensor cores), as `preferred_element_type=float32` does there.
//
// The TPU kernels carry the weight-gradient sums across a sequential grid in
// resident accumulators. Here the rows are split over blockIdx.z and every
// CTA adds its partial tile into the fp32 output with atomicAdd; the caller
// zeroes the output. The order of those additions varies from run to run.
//
// Epilogues (what the backward bodies do right after a product):
//   kEpiPlain    v = acc + bias; stored as fp32 (out_f) and/or rounded (out_t)
//   kEpiGeluFwd  v = acc + bias kept in fp32 (aux), out_t = round(GELU(v)):
//                the recomputed h1 and g of `_mlp_bwd_kernel`
//   kEpiGeluBwd  out_t = round(acc * GELU'(aux)): dh1 = dg * GELU'(h1)
// gemm_kernel (fp32) loads its tiles element by element, at any stride;
// gemm_mma_kernel (bf16) moves them in 16-byte chunks and takes the three
// operand layouts the backwards give it. PERF.md has the times.
enum GemmEpilogue { kEpiPlain = 0, kEpiGeluFwd = 1, kEpiGeluBwd = 2 };

struct GemmArgs {
  const void* a;
  long sam, sak;
  const void* b;
  long sbk, sbn;
  int M, N, K;
  int k_chunk;        // reduction length of one blockIdx.z (set by launch_gemm)
  const float* bias;  // (N) or null
  float* out_f;       // fp32 (M, N): stored, or added atomically when split
  void* out_t;        // storage type (M, N), rounded; or null
  float* aux;         // fp32 (M, N) pre-activation of the GELU epilogues
  int epi;
};

// d/dv of the exact GELU: Phi(v) + v phi(v)
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.7071067811865476f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

template <typename T>
__device__ __forceinline__ void gemm_store(const GemmArgs& p, long r, int c, float v) {
  const long at = r * p.N + c;
  if (p.epi == kEpiGeluBwd) {
    v *= gelu_grad(p.aux[at]);
  } else if (p.bias != nullptr) {
    v += p.bias[c];
  }
  if (p.epi == kEpiGeluFwd) {
    p.aux[at] = v;
    v = gelu_exact(v);
  }
  if (p.out_f != nullptr) {
    if (gridDim.z > 1)
      atomicAdd(p.out_f + at, v);
    else
      p.out_f[at] = v;
  }
  if (p.out_t != nullptr) static_cast<T*>(p.out_t)[at] = from_f<T>(v);
}

// fp32 on the CUDA cores: the 128 x 96 tile and block_gemm of above.
template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_kernel(GemmArgs p) {
  constexpr int TM = 8, TN = 6, BM = 16 * TM, BN = 16 * TN;
  __shared__ float As[kBK][BM + 1];
  __shared__ float Bs[kBK][BN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    // consecutive threads along whichever index is contiguous in memory
    for (int e = tid; e < BM * kBK; e += kThreads) {
      int m, kk;
      if (p.sak == 1) { kk = e % kBK; m = e / kBK; } else { m = e % BM; kk = e / BM; }
      const long r = m0 + m;
      const int k = k0 + kk;
      As[kk][m] = (r < p.M && k < kend) ? to_f<T>(a[r * p.sam + k * p.sak]) : 0.f;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      int n, kk;
      if (p.sbn == 1) { n = e % BN; kk = e / BN; } else { kk = e % kBK; n = e / kBK; }
      const int c = n0 + n, k = k0 + kk;
      Bs[kk][n] = (c < p.N && k < kend) ? to_f<T>(b[k * p.sbk + c * p.sbn]) : 0.f;
    }
    __syncthreads();
    block_gemm<TM, TN>(acc, As, Bs, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < p.N) gemm_store<T>(p, r, c, acc[i][j]);
    }
  }
}

// bf16 on the tensor cores: the warp layout of fused_linear_mma_kernel, the
// tiles moved in 16-byte chunks of 8 values, for operands whose contiguous
// index is known and whose sizes, strides and pointers are multiples of 8
// values (launch_gemm checks, and refuses any other). A_T: A is given
// transposed, contiguous along m (the weight gradients' A^T), and sits in
// shared memory as [k][m], read as a column-major fragment; else contiguous
// along k, as [m][k]. B_T: B is contiguous along k (the input gradients' W^T),
// held as [n][k] and read column-major; else contiguous along n, as [k][n].
// A slab is fetched into registers while the one before it is multiplied.
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(kThreads) gemm_mma_kernel(GemmArgs p) {
  using namespace nvcuda;
  typedef __nv_bfloat16 T;
  constexpr int BM = kMmaBM, BN = kMmaBN, BK = kMmaBK;
  constexpr int LDA = A_T ? BM + 8 : kLdA, LDB = B_T ? BK + 8 : kLdB;
  __shared__ __align__(32) T As[(A_T ? BK : BM) * LDA];
  __shared__ __align__(32) T Bs[(B_T ? BN : BK) * LDB];
  __shared__ __align__(32) float Cw[kThreads / 32][16 * 16];
  using LayoutA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  constexpr int kChunksA = BM * BK / 8, kChunksB = BK * BN / 8;
  constexpr int kPerA = kChunksA / kThreads, kPerB = (kChunksB + kThreads - 1) / kThreads;
  static_assert(kChunksA % kThreads == 0, "every thread moves the same number of A chunks");
  uint4 ra[kPerA], rb[kPerB];
  // chunk e of a slab: its place in shared memory, and in the operand from
  // the slab's first k (or a negative offset when it lies outside)
  auto place_a = [&](int e, int* at_s, int* m, int* k) {
    if (A_T) {
      *k = e / (BM / 8), *m = (e % (BM / 8)) * 8;
    } else {
      *m = e / (BK / 8), *k = (e % (BK / 8)) * 8;
    }
    *at_s = A_T ? *k * LDA + *m : *m * LDA + *k;
  };
  auto place_b = [&](int e, int* at_s, int* n, int* k) {
    if (B_T) {
      *n = e / (BK / 8), *k = (e % (BK / 8)) * 8;
    } else {
      *k = e / (BN / 8), *n = (e % (BN / 8)) * 8;
    }
    *at_s = B_T ? *n * LDB + *k : *k * LDB + *n;
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPerA; ++i) {
      int at_s, m, k;
      place_a(tid + i * kThreads, &at_s, &m, &k);
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < p.M && k0 + k < kend)
        ra[i] = *reinterpret_cast<const uint4*>(a + (m0 + m) * p.sam + (long)(k0 + k) * p.sak);
    }
#pragma unroll
    for (int i = 0; i < kPerB; ++i) {
      const int e = tid + i * kThreads;
      if (e >= kChunksB) break;
      int at_s, n, k;
      place_b(e, &at_s, &n, &k);
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < p.N && k0 + k < kend)
        rb[i] = *reinterpret_cast<const uint4*>(b + (long)(k0 + k) * p.sbk +
                                                (long)(n0 + n) * p.sbn);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kPerA; ++i) {
      int at_s, m, k;
      place_a(tid + i * kThreads, &at_s, &m, &k);
      *reinterpret_cast<uint4*>(As + at_s) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kPerB; ++i) {
      const int e = tid + i * kThreads;
      if (e >= kChunksB) break;
      int at_s, n, k;
      place_b(e, &at_s, &n, &k);
      *reinterpret_cast<uint4*>(Bs + at_s) = rb[i];
    }
  };

  fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < kend) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LayoutA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LayoutB> fb[3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = 32 * wm + 16 * i;
        wmma::load_matrix_sync(fa[i], As + (A_T ? kk * LDA + m : m * LDA + kk), LDA);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int n = 48 * wn + 16 * j;
        wmma::load_matrix_sync(fb[j], Bs + (B_T ? n * LDB + kk : kk * LDB + n), LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* patch = Cw[warp];
  const int pr = lane >> 1, pc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long r = m0 + 32 * wm + 16 * i + pr;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int c = n0 + 48 * wn + 16 * j + pc;
      if (r < p.M) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < p.N) gemm_store<T>(p, r, c + e, patch[pr * 16 + pc + e]);
      }
      __syncwarp();
    }
  }
}

// Whether the bf16 operands can move in 16-byte chunks: one stride is 1, the
// other and the extent along the contiguous index are multiples of 8, the
// pointers are 16-byte aligned.
static inline bool gemm_chunked(const GemmArgs& p, bool a_t, bool b_t) {
  const bool a_ok = a_t ? (p.sam == 1 && p.sak % 8 == 0 && p.M % 8 == 0)
                        : (p.sak == 1 && p.sam % 8 == 0 && p.K % 8 == 0);
  const bool b_ok = b_t ? (p.sbk == 1 && p.sbn % 8 == 0 && p.K % 8 == 0)
                        : (p.sbn == 1 && p.sbk % 8 == 0 && p.N % 8 == 0);
  return a_ok && b_ok && reinterpret_cast<uintptr_t>(p.a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.b) % 16 == 0;
}

// Launch with the reduction split `splits` ways over blockIdx.z (1 = no
// split). A split product adds into out_f, which the caller has zeroed, and
// takes neither a bias nor a rounded output nor a GELU epilogue.
template <typename T>
static cudaError_t launch_gemm(GemmArgs p, int splits, cudaStream_t s) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || splits < 1) return cudaErrorInvalidValue;
  p.k_chunk = ((p.K + splits - 1) / splits + kMmaBK - 1) / kMmaBK * kMmaBK;
  const unsigned z = (unsigned)((p.K + p.k_chunk - 1) / p.k_chunk);
  if (z > 1 && (p.bias != nullptr || p.epi != kEpiPlain || p.out_t != nullptr ||
                p.out_f == nullptr))
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)((p.M + kMmaBM - 1) / kMmaBM),
            (unsigned)((p.N + kMmaBN - 1) / kMmaBN), z);
  if constexpr (sizeof(T) == 4) {
    gemm_kernel<T><<<grid, kThreads, 0, s>>>(p);
  } else {
    // x @ W, dY @ W^T and A^T @ B as the backwards give them
    if (gemm_chunked(p, false, false))
      gemm_mma_kernel<false, false><<<grid, kThreads, 0, s>>>(p);
    else if (gemm_chunked(p, false, true))
      gemm_mma_kernel<false, true><<<grid, kThreads, 0, s>>>(p);
    else if (gemm_chunked(p, true, false))
      gemm_mma_kernel<true, false><<<grid, kThreads, 0, s>>>(p);
    else
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// A weight gradient (M, N) = A^T @ B over `rows` rows of A (rows, M) and
// B (rows, N), added into the zeroed fp32 `out`. The rows are split so that
// a few hundred CTAs share the card.
template <typename T>
static cudaError_t launch_weight_grad(const void* a, const void* b, float* out,
                                      int rows, int M, int N, cudaStream_t s) {
  GemmArgs p = {};
  p.a = a; p.sam = 1; p.sak = M;
  p.b = b; p.sbk = N; p.sbn = 1;
  p.M = M; p.N = N; p.K = rows;
  p.out_f = out;
  const int tiles = ((M + kMmaBM - 1) / kMmaBM) * ((N + kMmaBN - 1) / kMmaBN);
  int splits = (528 + tiles - 1) / tiles;
  if (splits > rows / 256) splits = rows / 256;
  if (splits < 1) splits = 1;
  return launch_gemm<T>(p, splits, s);
}

// An input gradient (rows, K_in) = dY (rows, N_out) @ W^T for W (K_in, N_out)
// row-major: the contraction runs over W's output width.
static inline GemmArgs input_grad_args(const void* dy, const void* w, int rows, int k_in,
                                int n_out) {
  GemmArgs p = {};
  p.a = dy; p.sam = n_out; p.sak = 1;
  p.b = w; p.sbk = 1; p.sbn = n_out;
  p.M = rows; p.N = k_in; p.K = n_out;
  return p;
}
