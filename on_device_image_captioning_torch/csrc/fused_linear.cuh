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
// Two kernels compute it, with the same gather and epilogue (the training
// backwards' product, at the end of this file, shares the second one's ring):
//
// fused_linear_kernel (fp32: every product of the fp32 parity route, the
//   patch embed's among them): 256 threads
//   as 16 x 16; a thread owns rows ty + 16 i and columns tx + 16 j of a
//   (16 TM) x (16 TN) block tile and walks K in slabs of 16 through shared
//   memory (A stored k-major so a warp reads it as broadcasts, W row-major so
//   a warp reads consecutive banks), the LayerNorm applied as A is stored;
//   fp32 FMAs, so fp32 inputs stay full fp32.
// linear_wgmma_kernel (bf16, the large products): Hopper's warpgroup MMA
//   (wgmma m64nNk16, bf16 in, fp32 accumulators in registers, W read through
//   the transpose bit as the (K, N) row-major matrix it is). A and W K slabs
//   of 64 (32 for gathered rows of an odd multiple of 32) go through a ring
//   of 3 or 4 stages in shared memory by 16-byte cp.async, S - 1 slabs ahead
//   of the products, every thread moving its share (the gather is per row);
//   mbarriers say when a stage is full (the copies report to it themselves)
//   and when every warpgroup is done with it. A LayerNorm prologue runs
//   before, once per row (ln_rows_kernel: the statistics as row_stats forms
//   them, the normalized rows rounded to bf16 into scratch the product reads
//   in order), not once per column tile in the ring: the same roundings,
//   done once where the ring did them 6 to 24 times (PERF.md has both
//   designs' times). The epilogue applies bias and GELU to the
//   accumulators in registers, stages the rounded tile in the ring and
//   stores whole rows in 16-byte chunks with the residual. The tile (64 or
//   128 rows by 64 or 128 columns, two or three CTAs an SM) comes from a
//   launch plan made in Python from the shapes and the card's SM count
//   (ops/linear_plan.py). K is not split there: every output value is one
//   CTA's sum in a fixed order, so two launches agree bit for bit.
// linear_wgmma_kernel's MERGE form (B8, the patch merging, where its few
//   tiles leave CTA slots idle: ops/linear_plan.py::merge_plan): K split over
//   a cluster of CTAs along z, and no (M, K) scratch. A pre-pass
//   (merge_stats_kernel: a warp a row, the row read once) writes each row's
//   mean and 1/sqrt(var + eps), 8 bytes a row; each warpgroup normalizes its
//   own 64 rows of every gathered A slab in the ring, rounded to bf16 as
//   ln_rows_kernel rounds them, before its products on the slab. Each CTA
//   sums its run of slabs, the partial tiles meet in distributed shared
//   memory and every output value is their sum in rank order, then rounded
//   once: a fixed order, no atomics, so two launches agree bit for bit.
//   Where the tiles fill the card, B8 takes the scratch and the plain form.
// See each .cu for what bounds it.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
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
  // (M, K) scratch: the LayerNorm prologue's rows of a bf16 product, written
  // by ln_rows_kernel and read by the product in their place
  void* ln_rows;
  // the MERGE form (B8): (M) mean and 1/sqrt(var + eps) of each gathered A
  // row, written by merge_stats_kernel; and the K values a blockIdx.z sums
  float2* row_stats;
  int k_chunk;
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
template <int BM, int THREADS = kThreads>
__device__ __forceinline__ void gather_rows(const LinearArgs& p, long m0,
                                            long (*src_row)[BM]) {
  for (int idx = threadIdx.x; idx < p.segs * BM; idx += THREADS) {
    const int seg = idx / BM, m = idx % BM;
    const long r = m0 + m;
    src_row[seg][m] = r < p.M ? map_row(p.a_map, r, seg, p.geo) : -1;
  }
}

// Mean and 1/sqrt(var + eps) of each gathered A row (fp32, two passes). Eight
// lanes share a row and read it in 16-byte chunks, so a warp works on four
// rows at a time; a lane has up to kStatChunks chunks in flight and adds them
// in the order of a lane that read them one by one (chunk sub, sub + 8, ...).
constexpr int kStatChunks = 8;
template <typename T, int BM, int THREADS = kThreads>
__device__ __forceinline__ void row_stats(const LinearArgs& p,
                                          const long (*src_row)[BM],
                                          float* mean_s, float* rstd_s) {
  constexpr int V = 16 / sizeof(T);  // values in a chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & 7, grp = lane >> 3;
  const int ks = p.K / p.segs, chunks = ks / V;
  const T* a = static_cast<const T*>(p.a);
  // the lane's chunks ch, ch + 8, ... of segment seg of row m, in batches
  auto each = [&](int m, auto&& add) {
    for (int seg = 0; seg < p.segs; ++seg) {
      const uint4* row = reinterpret_cast<const uint4*>(a + src_row[seg][m] * ks);
      for (int ch = sub; ch < chunks; ch += 8 * kStatChunks) {
        uint4 raw[kStatChunks];
#pragma unroll
        for (int u = 0; u < kStatChunks; ++u)
          if (ch + 8 * u < chunks) raw[u] = row[ch + 8 * u];
#pragma unroll
        for (int u = 0; u < kStatChunks; ++u)
          if (ch + 8 * u < chunks) {
            const T* h = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
            for (int j = 0; j < V; ++j) add(to_f<T>(h[j]));
          }
      }
    }
  };
  for (int m = warp * 4 + grp; m < BM; m += THREADS / 8) {
    const bool ok = src_row[0][m] >= 0;
    float s = 0.f;
    if (ok) each(m, [&](float v) { s += v; });
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / p.K;
    float q = 0.f;
    if (ok)
      each(m, [&](float v) {
        const float d = v - mean;
        q = fmaf(d, d, q);
      });
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
__device__ __forceinline__ float epilogue_product(const LinearArgs& p, float v) {
  v = round_t<T>(v);  // v already holds the bias
  if (p.gelu) v = round_t<T>(gelu_exact(v));
  return v;
}
template <typename T>
__device__ __forceinline__ float epilogue_resid(float v, float res, float m) {
  return round_t<T>(res + m * v);
}
template <typename T>
__device__ __forceinline__ float epilogue(const LinearArgs& p, float v, int c,
                                          bool has_resid, float res, float m) {
  if (p.bias != nullptr) v += p.bias[c];
  v = epilogue_product<T>(p, v);
  if (has_resid) v = epilogue_resid<T>(v, res, m);
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

// ---------------------------------------------------------------------------
// The bf16 product on Hopper's warpgroup MMA (see the head of this file).

// Tile forms of linear_wgmma_kernel: BM rows (a consumer warpgroup of 128
// threads for every 64), BN columns, K slabs of BK, a ring of STAGES slabs,
// and the CTAs one SM holds at that shared memory (the launch bounds): two or
// three, so that one CTA's epilogue overlaps another's products (forms of one
// CTA an SM, 128 x 256 and 128 x 192, measured slower at every main-path
// shape: PERF.md). The launch plan (ops/linear_plan.py, which reads this
// table in its tests) picks one per product; BK 32 is the form for gathered
// rows of an odd multiple of 32 values, which no product of the main path has.
struct ProductForm {
  int bm, bn, bk, stages, ctas;
};
constexpr ProductForm kProductForms[] = {
    {128, 128, 64, 3, 2},  // 0
    {64, 128, 64, 4, 2},   // 1
    {64, 64, 64, 4, 3},    // 2
    {64, 64, 32, 4, 3},    // 3
};

// Dynamic shared memory of a form: the ring, 1024 bytes to align it (the
// swizzle repeats every 1024), a full and an empty barrier per stage, the
// gathered source rows (4 segments) and the bias of the tile's columns.
constexpr int product_smem(const ProductForm& f) {
  return f.stages * (f.bm * f.bk + f.bk * f.bn) * 2 + 1024 + 2 * f.stages * 8 + 4 * f.bm * 8 +
         f.bn * 4;
}

// The 16-byte chunk that chunk c of row m of an A slab occupies: rows of 128
// bytes (BK 64) in the 128-byte swizzle, of 64 bytes (BK 32) in the 64-byte one,
// as the descriptors name them (an 8-row pattern of 1024 or 512 bytes).
template <int BK>
__device__ __forceinline__ int swizzle_a(int m, int c) {
  return BK == 64 ? c ^ (m & 7) : c ^ ((m >> 1) & 3);
}

// One CTA computes a BM x BN output tile; warpgroup g holds rows 64 g ..
// 64 g + 63 as fp32 accumulators in its registers. Every thread moves its
// share of each K slab (A rows gathered through src_row, W rows of the tile's
// columns) into the ring by 16-byte cp.async, S - 1 slabs ahead of use:
//   slab j sits in stage j % S; full[s] completes when every thread's copies
//   of it have landed (cp.async reports to the barrier itself: no thread
//   waits for its own copies); empty[s] completes when every warpgroup's
//   products on it are done, and only then is the stage refilled with slab
//   j + S.
// A stage holds A as BM rows of BK values (K-major) and W as BK rows of BN
// (MN-major, 64-column blocks of 128-byte rows), both swizzled as the
// descriptors say. The epilogue applies bias and GELU to the accumulators
// where they lie, stages the rounded tile in the ring, then adds the
// residual and stores whole rows in 16-byte chunks. A LayerNorm prologue has
// been applied by ln_rows_kernel before the launch.
//
// MERGE (B8): the A slabs arrive as the raw gathered rows; after a stage is
// full, each warpgroup normalizes its 64 rows of it in place from the
// pre-pass's row statistics (a thread always the same chunk column of four
// rows, or two at BK 32, their statistics held in registers), rounded to
// bf16 as ln_rows_kernel rounds them, fences them for the tensor cores and
// meets its warpgroup at a named barrier before its products (normalizing
// register A fragments for wgmma instead measured slower at b8).
// blockIdx.z sums slabs k_chunk / BK of K only, in a cluster of gridDim.z
// CTAs along z: the fp32 partial tiles meet in the cluster's shared memory
// and each CTA adds a 1 / splits share of the tile's outputs over the ranks
// in order 0, 1, ... and rounds it once.
template <int BM, int BN, int BK, int S, int CTAS, bool MERGE = false>
__global__ void __launch_bounds__(2 * BM, CTAS) linear_wgmma_kernel(LinearArgs p) {
  typedef __nv_bfloat16 T;
  constexpr int THREADS = 2 * BM;
  constexpr int ROW = 2 * BK;  // bytes of an A row in a slab
  constexpr int A_BYTES = BM * ROW, STAGE = A_BYTES + BK * BN * 2;
  constexpr int CPR = BK / 8;  // 16-byte chunks of an A row
  constexpr int A_PER = BM * CPR / THREADS, W_PER = BK * (BN / 8) / THREADS;
  static_assert(THREADS % CPR == 0 && (BK * (BN / 8)) % THREADS == 0 && BN % 64 == 0,
                "every thread moves whole chunks, always the same A chunk of a row");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  long(*src_row)[BM] = reinterpret_cast<long(*)[BM]>(empty + S);
  float* bias_s = reinterpret_cast<float*>(src_row + 4);

  const int tid = threadIdx.x, wg = tid >> 7;
  const long m0 = static_cast<long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int ks = p.K / p.segs;
  // the K values this CTA sums: kbeg .. kbeg + BK slabs - 1 (all of K but in
  // the MERGE form)
  const int kbeg = MERGE ? static_cast<int>(blockIdx.z) * p.k_chunk : 0;
  const int slabs = MERGE ? (min(p.K, kbeg + p.k_chunk) - kbeg) / BK : p.K / BK;
  const T* a = static_cast<const T*>(p.a);
  const T* w = static_cast<const T*>(p.w);
  const uint32_t ring_s = smem_u32(ring);
  const int kc = tid % CPR;  // the thread's chunk of every A row it moves

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], THREADS);
      mbar_init(&empty[s], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  gather_rows<BM, THREADS>(p, m0, src_row);
  for (int i = tid; i < BN; i += THREADS)
    bias_s[i] = (p.bias != nullptr && n0 + i < p.N) ? p.bias[n0 + i] : 0.f;
  __syncthreads();

  auto load = [&](int j) {  // slab j into stage j % S, reported to full[j % S]
    const int k0 = kbeg + j * BK, seg = k0 / ks;  // a slab never straddles two gathered rows
    const int kseg = k0 - seg * ks;
    const uint32_t sa = ring_s + (j % S) * STAGE, sw = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int m = (tid + i * THREADS) / CPR;
      const long src = src_row[seg][m];
      cp_async16(sa + m * ROW + (swizzle_a<BK>(m, kc) << 4),
                 src >= 0 ? a + src * ks + kseg + kc * 8 : a, src >= 0);
    }
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int e = tid + i * THREADS, kr = e / (BN / 8), ch = e % (BN / 8);
      const int n = n0 + ch * 8;
      cp_async16(sw + (ch >> 3) * (BK * 128) + kr * 128 + (((ch & 7) ^ (kr & 7)) << 4),
                 n < p.N ? w + static_cast<long>(k0 + kr) * p.N + n : w, n < p.N);
    }
    mbar_arrive_on_copies(&full[j % S]);
  };

#pragma unroll
  for (int j = 0; j < S - 1; ++j)
    if (j < slabs) load(j);

  // MERGE: the thread normalizes chunk kc of rows 64 wg + (tid % 128) / CPR
  // + i 128 / CPR of every slab, with their statistics held in registers
  constexpr int NORM_ROWS = MERGE ? 64 * CPR / 128 : 1;
  float2 stat[NORM_ROWS];
  if constexpr (MERGE) {
#pragma unroll
    for (int i = 0; i < NORM_ROWS; ++i) {
      const long r = m0 + wg * 64 + (tid & 127) / CPR + i * (128 / CPR);
      stat[i] = r < p.M ? p.row_stats[r] : make_float2(0.f, 0.f);
    }
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_rows = wg * 64 * ROW;  // the warpgroup's 64 rows of a slab
  for (int j = 0; j < slabs; ++j) {
    const int s = j % S;
    if constexpr (MERGE) {
      // the LayerNorm's scale and shift of the thread's chunk, asked for
      // before the wait for the slab
      const int k = kbeg + j * BK + kc * 8;
      const float4* gp = reinterpret_cast<const float4*>(p.ln_g + k);
      const float4* bp = reinterpret_cast<const float4*>(p.ln_b + k);
      const float4 g4[2] = {gp[0], gp[1]}, b4[2] = {bp[0], bp[1]};
      const float* gf = reinterpret_cast<const float*>(g4);
      const float* bf = reinterpret_cast<const float*>(b4);
      mbar_wait(&full[s], (j / S) & 1);
#pragma unroll
      for (int i = 0; i < NORM_ROWS; ++i) {
        const int m = wg * 64 + (tid & 127) / CPR + i * (128 / CPR);
        uint4* chunk = reinterpret_cast<uint4*>(ring + s * STAGE + m * ROW +
                                                (swizzle_a<BK>(m, kc) << 4));
        uint4 raw = *chunk;
        T* h = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = __float2bfloat16((__bfloat162float(h[e]) - stat[i].x) * stat[i].y * gf[e] +
                                  bf[e]);
        *chunk = raw;
      }
      fence_proxy_async();  // the normalized rows, to the tensor cores
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");  // the warpgroup's rows
    } else {
      mbar_wait(&full[s], (j / S) & 1);
      fence_proxy_async();
    }
    const uint32_t sa = ring_s + s * STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tile<BN>(acc, smem_desc(sa + a_rows + kk * 32, 16, 8 * ROW, BK == 64 ? 1 : 2),
                     smem_desc(sa + A_BYTES + kk * 16 * 128, BK * 128, 1024, 1));
    wgmma_commit();
    wgmma_wait<1>();  // the products on slab j - 1 are done
    fence_acc(acc);
    if (j > 0) mbar_arrive(&empty[(j - 1) % S]);
    if (j + S - 1 < slabs) {  // refill the stage of slab j - 1 with slab j + S - 1
      if (j > 0) mbar_wait(&empty[(j - 1) % S], ((j - 1) / S) & 1);
      load(j + S - 1);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();  // every warpgroup is done with the ring: it takes the tile now

  // accumulator d[4 j + 2 h + b] of lane l in warp v of the warpgroup is row
  // 16 v + l / 4 + 8 h, column 8 j + 2 (l % 4) + b of the warpgroup's piece;
  // staged rows are BN values and 16 bytes long (no bank conflicts)
  constexpr int ST = BN * 2 + 16;
  static_assert(BM * ST <= S * STAGE, "the finished tile fits the ring");
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  if constexpr (MERGE) {  // the partial tiles meet in the cluster
    constexpr int PST = BN * 4 + 16;  // bytes of a staged fp32 row
    static_assert(BM * PST <= S * STAGE, "the partial tile fits the ring");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(ring + (r0 + 8 * h) * PST + c * 4) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    cluster.sync();  // every rank's partial tile is in its ring
    const int splits = static_cast<int>(gridDim.z), rank = static_cast<int>(blockIdx.z);
    constexpr int CH = BN / 8;  // 8-column units of a row
    T* out = static_cast<T*>(p.out);
    for (int u = rank * THREADS + tid; u < BM * CH; u += splits * THREADS) {
      const int row = u / CH, ch = u % CH;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int z = 0; z < splits; ++z) {  // rank order: the same sum at every launch
        const float4* part = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(ring + row * PST + ch * 32, z));
        const float4 lo = part[0], hi = part[1];
        v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
        v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
      }
      const long r = m0 + row;
      const int c = n0 + ch * 8;
      if (r < p.M && c < p.N) {
        uint4 raw;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        *reinterpret_cast<uint4*>(out + r * p.N + c) = raw;
      }
    }
    cluster.sync();  // no rank leaves while another reads its partial tile
    return;
  }
  const bool bias = p.bias != nullptr;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (lane & 3) * 2;
    const float b0 = bias_s[c], b1 = bias_s[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      __nv_bfloat162 v;
      v.x = __float2bfloat16(epilogue_product<T>(p, bias ? v0 + b0 : v0));
      v.y = __float2bfloat16(epilogue_product<T>(p, bias ? v1 + b1 : v1));
      *reinterpret_cast<__nv_bfloat162*>(ring + (r0 + 8 * h) * ST + c * 2) = v;
    }
  }
  __syncthreads();
  // a thread's chunks in batches of four: every load of a batch (the
  // residual's included) before any of its stores
  constexpr int CH = BN / 8, PER = BM * CH / THREADS, B = PER < 4 ? PER : 4;
  static_assert(PER % B == 0, "whole batches");
  const T* resid = static_cast<const T*>(p.resid);
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += B) {
    uint4 raw[B], res_raw[B];
    float scale[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int e = tid + (i0 + i) * THREADS, row = e / CH, ch = e % CH;
      const long r = m0 + row;
      raw[i] = *reinterpret_cast<const uint4*>(ring + row * ST + ch * 16);
      if (resid != nullptr && r < p.M && n0 + ch * 8 < p.N) {
        res_raw[i] = *reinterpret_cast<const uint4*>(
            resid + map_row(p.resid_map, r, 0, p.geo) * p.N + n0 + ch * 8);
        scale[i] = row_scale_of(p, r);
      }
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int e = tid + (i0 + i) * THREADS, row = e / CH, ch = e % CH;
      const long r = m0 + row;
      const int c = n0 + ch * 8;
      if (r >= p.M || c >= p.N) continue;
      if (resid != nullptr) {
        const T* res = reinterpret_cast<const T*>(&res_raw[i]);
        T* v = reinterpret_cast<T*>(&raw[i]);
#pragma unroll
        for (int e2 = 0; e2 < 8; ++e2)
          v[e2] = __float2bfloat16(epilogue_resid<T>(__bfloat162float(v[e2]),
                                                     __bfloat162float(res[e2]), scale[i]));
      }
      *reinterpret_cast<uint4*>(out + r * p.N + c) = raw[i];
    }
  }
}

// The LayerNorm prologue of a bf16 product, once per row for all of its
// column tiles: the statistics of the gathered A row (row_stats: fp32, two
// passes, eight lanes a row), then (a - mean) rstd g + b rounded to bf16
// into row m of p.ln_rows (M, K), which the product reads in A's place.
__global__ void __launch_bounds__(kThreads) ln_rows_kernel(LinearArgs p) {
  typedef __nv_bfloat16 T;
  constexpr int R = 32;  // rows a CTA: eight warps of four
  __shared__ long src_row[4][R];
  __shared__ float mean_s[R], rstd_s[R];
  const long m0 = static_cast<long>(blockIdx.x) * R;
  gather_rows<R>(p, m0, src_row);
  __syncthreads();
  row_stats<T, R>(p, src_row, mean_s, rstd_s);
  __syncthreads();
  const int lane = threadIdx.x & 31, sub = lane & 7;
  const int m = (threadIdx.x >> 5) * 4 + (lane >> 3);
  if (src_row[0][m] < 0) return;
  const int ks = p.K / p.segs;
  const float mean = mean_s[m], rstd = rstd_s[m];
  T* dst = static_cast<T*>(p.ln_rows) + (m0 + m) * p.K;
  for (int seg = 0; seg < p.segs; ++seg) {
    const uint4* row = reinterpret_cast<const uint4*>(static_cast<const T*>(p.a) +
                                                      src_row[seg][m] * ks);
    for (int ch = sub; ch < ks / 8; ch += 8) {
      const int k = seg * ks + ch * 8;
      const float4* gp = reinterpret_cast<const float4*>(p.ln_g + k);
      const float4* bp = reinterpret_cast<const float4*>(p.ln_b + k);
      const float4 g4[2] = {gp[0], gp[1]}, b4[2] = {bp[0], bp[1]};
      const float* gf = reinterpret_cast<const float*>(g4);
      const float* bf = reinterpret_cast<const float*>(b4);
      uint4 raw = row[ch];
      T* h = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = __float2bfloat16((__bfloat162float(h[e]) - mean) * rstd * gf[e] + bf[e]);
      *reinterpret_cast<uint4*>(dst + k) = raw;
    }
  }
}

// Source row of segment seg of output row r of the 2x2 merge (kMapMerge's
// map_row) in 32-bit arithmetic: rows below 2^31.
__device__ __forceinline__ int merge_source_row(int r, int seg, int res, int window) {
  const int n = window * window, wn = res / window, wno = wn / 2;
  const int per_img = (res / 2) * (res / 2);
  const int img = r / per_img, f = r - img * per_img, w = f / n, q = f - w * n;
  const int y = (w / wno) * window + q / window, x = (w % wno) * window + q % window;
  const int sy = 2 * y + (seg & 1), sx = 2 * x + (seg >> 1);
  return ((img * wn + sy / window) * wn + sx / window) * n + (sy % window) * window +
         sx % window;
}

// The MERGE form's pre-pass: a warp a row of the 2x2 merge (lanes 0-3 find
// its four source rows, in 32-bit arithmetic), the gathered row read once
// into registers (lane l holds chunks l, l + 32, ... of its K / 8 16-byte
// chunks, NCH of them at most: 3, 6 and 12 at stages 0-2), the fp32 mean,
// then the sum of squares about it from the same registers; 8 bytes a row
// into p.row_stats. (Several rows a warp, 8 or 16 lanes each, measured
// slower at every main-path shape.)
constexpr int kMergeStatChunks = 12;  // rows of up to 3072 bf16 values (stage 2's 4C)
template <int NCH>
__global__ void __launch_bounds__(kThreads) merge_stats_kernel(LinearArgs p) {
  typedef __nv_bfloat16 T;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= p.M) return;  // a whole warp
  const int ks = p.K / 4, cps = ks / 8, chunks = p.K / 8;
  const int mine = lane < 4 ? merge_source_row(r, lane, p.geo.res, p.geo.window) : 0;
  const long s0 = static_cast<long>(__shfl_sync(0xffffffffu, mine, 0)) * ks;
  const long s1 = static_cast<long>(__shfl_sync(0xffffffffu, mine, 1)) * ks;
  const long s2 = static_cast<long>(__shfl_sync(0xffffffffu, mine, 2)) * ks;
  const long s3 = static_cast<long>(__shfl_sync(0xffffffffu, mine, 3)) * ks;
  const T* a = static_cast<const T*>(p.a);
  uint4 raw[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
      const int seg = ch / cps;
      const long base = seg == 0 ? s0 : seg == 1 ? s1 : seg == 2 ? s2 : s3;
      raw[i] = *reinterpret_cast<const uint4*>(a + base + (ch - seg * cps) * 8);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    if (lane + 32 * i < chunks) {
      const T* h = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += __bfloat162float(h[e]);
    }
  const float mean = warp_sum(sum) / p.K;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    if (lane + 32 * i < chunks) {
      const T* h = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __bfloat162float(h[e]) - mean;
        sq = fmaf(d, d, sq);
      }
    }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / p.K + p.eps);
  if (lane == 0) p.row_stats[r] = make_float2(mean, rstd);
}

static cudaError_t merge_stats_launch(const LinearArgs& p, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((p.M + kThreads / 32 - 1) / (kThreads / 32)));
  const int chunks = p.K / 8;
  if (chunks <= 32 * 3)
    merge_stats_kernel<3><<<grid, kThreads, 0, s>>>(p);
  else if (chunks <= 32 * 6)
    merge_stats_kernel<6><<<grid, kThreads, 0, s>>>(p);
  else
    merge_stats_kernel<kMergeStatChunks><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// One launch of form F: the attribute once per form (a process-wide static).
template <int F>
static cudaError_t launch_wgmma(const LinearArgs& p, cudaStream_t s) {
  constexpr ProductForm f = kProductForms[F];
  constexpr int smem = product_smem(f);
  static_assert(smem <= 232448 && f.ctas * (smem + 1024) <= 233472,
                "a CTA's and an SM's shared memory");
  const auto kernel = linear_wgmma_kernel<f.bm, f.bn, f.bk, f.stages, f.ctas>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if ((p.K / p.segs) % f.bk != 0) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((p.N + f.bn - 1) / f.bn),
            static_cast<unsigned>((p.M + f.bm - 1) / f.bm));
  kernel<<<grid, 2 * f.bm, smem, s>>>(p);
  return cudaGetLastError();
}

// The large products of the backbone. fp32 on the CUDA cores in the 128 x 96
// tile; bf16 on linear_wgmma_kernel in the tile form the caller's plan names
// (ops/linear_plan.py: an index of kProductForms), after ln_rows_kernel
// where there is a LayerNorm prologue (p.ln_rows: (M, K) of scratch).
template <typename T>
static cudaError_t launch_linear_wide(const LinearArgs& p, int form, cudaStream_t s) {
  (void)form;
  return launch_linear<T, 8, 6, false>(p, s);
}
template <>
cudaError_t launch_linear_wide<__nv_bfloat16>(const LinearArgs& p, int form, cudaStream_t s) {
  // 16-byte accesses: rows of A, W, the residual and the output start on
  // multiples of 8 values, and no K slab straddles two gathered rows
  if (p.M <= 0 || p.segs < 1 || p.segs > 4 || p.K % p.segs != 0 ||
      (p.K / p.segs) % 32 != 0 || p.N % 8 != 0 || (p.ln_g != nullptr && p.ln_rows == nullptr))
    return cudaErrorInvalidValue;
  LinearArgs q = p;
  if (p.ln_g != nullptr) {  // the product reads the normalized rows, in order
    ln_rows_kernel<<<static_cast<unsigned>((p.M + 31) / 32), kThreads, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    q.a = p.ln_rows;
    q.a_map = kMapIdentity;
    q.segs = 1;
    q.ln_g = q.ln_b = nullptr;
  }
  switch (form) {
    case 0: return launch_wgmma<0>(q, s);
    case 1: return launch_wgmma<1>(q, s);
    case 2: return launch_wgmma<2>(q, s);
    case 3: return launch_wgmma<3>(q, s);
    default: return cudaErrorInvalidValue;
  }
}

// 32 x 192 with the row-LayerNorm epilogue: the fp32 patch embed (and any
// width the bf16 kernel of stage_boundary.cu does not take), on the CUDA cores.
template <typename T>
static cudaError_t launch_linear_rows(const LinearArgs& p, cudaStream_t s) {
  return launch_linear<T, 2, 12, true>(p, s);
}

// One launch of the MERGE form F: `splits` CTAs along z, a cluster of them.
template <int F>
static cudaError_t launch_merge_form(const LinearArgs& p, int splits, cudaStream_t s) {
  constexpr ProductForm f = kProductForms[F];
  constexpr int smem = product_smem(f);
  const auto kernel = linear_wgmma_kernel<f.bm, f.bn, f.bk, f.stages, f.ctas, true>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if ((p.K / p.segs) % f.bk != 0 || p.k_chunk % f.bk != 0) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.N + f.bn - 1) / f.bn),
                     static_cast<unsigned>((p.M + f.bm - 1) / f.bm),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(2 * f.bm);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// B8's bf16 product with its LayerNorm prologue and K split:
// merge_stats_kernel into p.row_stats (M float2) unless `stats_ready`, then
// the MERGE form `form` of kProductForms with K in `splits` chunks of
// p.k_chunk (ops/linear_plan.py::merge_plan). The chunks are whole slabs;
// splits 2 to 8 (a portable cluster).
static cudaError_t launch_merge(const LinearArgs& p, int form, int splits, bool stats_ready,
                                cudaStream_t s) {
  if (p.M <= 0 || p.segs < 1 || p.segs > 4 || p.K % p.segs != 0 || (p.K / p.segs) % 32 != 0 ||
      p.N % 8 != 0 || p.ln_g == nullptr || p.row_stats == nullptr || p.bias != nullptr ||
      p.resid != nullptr || p.gelu || splits < 2 || splits > 8 || p.k_chunk <= 0 ||
      p.K / 8 > 32 * kMergeStatChunks || p.a_map != kMapMerge || p.segs != 4 ||
      p.M >= (1 << 28) ||
      (splits - 1) * p.k_chunk >= p.K || splits * p.k_chunk < p.K)
    return cudaErrorInvalidValue;
  if (!stats_ready) {
    const cudaError_t err = merge_stats_launch(p, s);
    if (err != cudaSuccess) return err;
  }
  switch (form) {
    case 0: return launch_merge_form<0>(p, splits, s);
    case 1: return launch_merge_form<1>(p, splits, s);
    case 2: return launch_merge_form<2>(p, splits, s);
    case 3: return launch_merge_form<3>(p, splits, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The products of the training backwards. The TPU backward kernels
// (ops/swin_block_fused.py `_mlp_bwd_kernel`, `_attn_bwd_kernel`) form, beside
// x @ W, the two shapes a forward never needs:
//   dY @ W^T   contract over the OUTPUT width of W (the input gradients), and
//   X^T @ dY   reduced over the rows (the weight gradients, fp32 sums).
// One product serves all three, in three operand layouts (GradLayout), each
// operand a row-major matrix in memory with row stride lda / ldb:
//   kXW    A (M, K) K-major, B (K, N) MN-major                    x @ W
//   kDYWT  A (M, K) K-major, B(k, n) = W[n][k], K-major           dY @ W^T
//   kATB   A(m, k) = X[k][m], MN-major, B (K, N) MN-major         X^T @ dY
// Products of the stored values are summed in fp32 (fp32 inputs on the CUDA
// cores as full fp32, bf16 inputs on the tensor cores), as
// `preferred_element_type=float32` does there.
//
// The TPU kernels carry the weight-gradient sums across a sequential grid in
// resident accumulators. Here K (the rows) is split into gridDim.z chunks of
// k_chunk rows, as the launch plan says (ops/linear_plan.py::grad_plan): the
// CTAs of chunk z write their fp32 partial tiles to slab z of out_f (splits,
// M, N), and sum_partials_kernel adds the slabs in the order 0, 1, ... No
// floating-point atomics: every sum has one order, and two launches agree bit
// for bit.
//
// Epilogues (what the backward bodies do right after a product):
//   kEpiPlain    v = acc (+ bias); stored as fp32 (out_f) and/or rounded (out_t)
//   kEpiGeluFwd  v = acc + bias kept in fp32 (aux), out_t = round(GELU(v)):
//                the recomputed h1 and g of `_mlp_bwd_kernel`
//   kEpiGeluBwd  out_t = round(acc * GELU'(aux)): dh1 = dg * GELU'(h1)
// and, where col_part is given, the column sums of the rounded out_t over the
// CTA's rows in row order, row tile y's into row y of col_part (row tiles, N):
// db1 of dh1, added up by sum_partials_kernel. bf16 takes the plain epilogue
// without bias only: B9c runs its GELU epilogues in one fused kernel of its
// own (swin_mlp_bwd.cu), which keeps h1 in registers.
//
// bf16 runs grad_wgmma_kernel: linear_wgmma_kernel's ring (16-byte cp.async
// into 128-byte-swizzled stages, full barriers completed by the copies, empty
// barriers by the warpgroups) with either operand in either major-ness
// through wgmma's transpose bits; fp32 runs grad_fp32_kernel on the CUDA
// cores. PERF.md has the times.
enum GemmEpilogue { kEpiPlain = 0, kEpiGeluFwd = 1, kEpiGeluBwd = 2 };
enum GradLayout { kXW = 0, kDYWT = 1, kATB = 2 };

struct GemmArgs {
  const void* a;
  long lda;
  const void* b;
  long ldb;
  int M, N, K;
  int k_chunk;        // K values of one blockIdx.z (the plan's; K itself unless split)
  const float* bias;  // (N) or null
  float* out_f;       // fp32 (gridDim.z, M, N): slab z holds chunk z's sums; or null
  void* out_t;        // storage type (M, N), rounded; or null
  float* aux;         // fp32 (M, N) pre-activation of the GELU epilogues
  float* col_part;    // fp32 (gridDim.y, N): column sums of out_t by row tile; or null
  int epi;
};

// d/dv of the exact GELU: Phi(v) + v phi(v)
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.7071067811865476f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

// Tile forms of grad_wgmma_kernel, as kProductForms: BM rows (a warpgroup for
// every 64), BN columns, K slabs of BK, a ring of STAGES, CTAs an SM. 96
// columns take only a K-major B (an MN-major B is stored in whole 64-column
// blocks). The plan (ops/linear_plan.py, whose tests read this table) picks
// one per product.
struct GradForm {
  int bm, bn, bk, stages, ctas;
};
constexpr GradForm kGradForms[] = {
    {128, 128, 64, 3, 2},  // 0
    {128, 96, 64, 3, 2},   // 1
    {64, 192, 64, 3, 2},   // 2
};

// Dynamic shared memory of a form: the ring, 1024 bytes to align it, a full
// and an empty barrier per stage.
constexpr int grad_smem(const GradForm& f) {
  return f.stages * (f.bm * f.bk + f.bk * f.bn) * 2 + 1024 + 2 * f.stages * 8;
}

// The ring of the backward products: acc (the warpgroup's 64 x BN fp32
// accumulators) = the sum over K values kbeg .. kend - 1 of A B for the tile
// at rows m0, columns n0. A stage holds the A slab then the B slab: a K-major
// operand as rows of 64 K values (128 bytes, chunk c of row m at c ^ (m & 7)),
// an MN-major one as 64-wide blocks of BK rows of 128 bytes (chunk c of k row
// kr at c ^ (kr & 7)), both as the descriptors name them. Loads run S - 1
// slabs ahead of the products, as in linear_wgmma_kernel; values past M, N or
// kend are zero-filled. full[S] and empty[S] are fresh barriers (THREADS
// arrivals each), one set per call; the ring is the caller's again once every
// thread has returned (after a __syncthreads).
template <int BM, int BN, int BK, int S, bool A_MN, bool B_MN>
__device__ __forceinline__ void grad_mainloop(float (&acc)[BN / 2], const __nv_bfloat16* a,
                                              long lda, const __nv_bfloat16* b, long ldb, int M,
                                              int N, long m0, int n0, int kbeg, int kend,
                                              uint32_t ring_s, uint64_t* full, uint64_t* empty) {
  constexpr int THREADS = 2 * BM;
  constexpr int A_BYTES = BM * BK * 2, STAGE = A_BYTES + BK * BN * 2;
  constexpr int CPR = BK / 8;  // 16-byte chunks along K of a K-major row
  constexpr int A_PER = BM * CPR / THREADS, B_PER = BN * CPR / THREADS;
  static_assert(BK == 64 && (BM * CPR) % THREADS == 0 && (BN * CPR) % THREADS == 0,
                "128-byte rows, every thread moves whole chunks");
  static_assert(!B_MN || BN % 64 == 0, "an MN-major B in whole 64-column blocks");
  const int tid = threadIdx.x, wg = tid >> 7;
  const int slabs = (kend - kbeg + BK - 1) / BK;
  auto load = [&](int j) {  // slab j into stage j % S, reported to full[j % S]
    const int k0 = kbeg + j * BK;
    const uint32_t sa = ring_s + (j % S) * STAGE, sb = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * THREADS;
      if constexpr (A_MN) {
        const int kr = e / (BM / 8), ch = e % (BM / 8);
        const bool ok = k0 + kr < kend && m0 + ch * 8 < M;
        cp_async16(sa + (ch >> 3) * (BK * 128) + kr * 128 + (((ch & 7) ^ (kr & 7)) << 4),
                   ok ? a + static_cast<long>(k0 + kr) * lda + m0 + ch * 8 : a, ok);
      } else {
        const int m = e / CPR, ch = e % CPR;
        const bool ok = m0 + m < M && k0 + ch * 8 < kend;
        cp_async16(sa + m * 128 + ((ch ^ (m & 7)) << 4),
                   ok ? a + (m0 + m) * lda + k0 + ch * 8 : a, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * THREADS;
      if constexpr (B_MN) {
        const int kr = e / (BN / 8), ch = e % (BN / 8);
        const bool ok = k0 + kr < kend && n0 + ch * 8 < N;
        cp_async16(sb + (ch >> 3) * (BK * 128) + kr * 128 + (((ch & 7) ^ (kr & 7)) << 4),
                   ok ? b + static_cast<long>(k0 + kr) * ldb + n0 + ch * 8 : b, ok);
      } else {
        const int n = e / CPR, ch = e % CPR;
        const bool ok = n0 + n < N && k0 + ch * 8 < kend;
        cp_async16(sb + n * 128 + ((ch ^ (n & 7)) << 4),
                   ok ? b + static_cast<long>(n0 + n) * ldb + k0 + ch * 8 : b, ok);
      }
    }
    mbar_arrive_on_copies(&full[j % S]);
  };

#pragma unroll
  for (int j = 0; j < S - 1; ++j)
    if (j < slabs) load(j);

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < slabs; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    fence_proxy_async();
    const uint32_t sa = ring_s + s * STAGE, sb = sa + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the warpgroup's 64 rows: its 64-row block (MN-major) or rows 64 wg on
      // (K-major); 16 K values on: two 8-row groups (MN-major) or 32 bytes
      const uint64_t da = A_MN ? smem_desc(sa + wg * (BK * 128) + kk * 2048, BK * 128, 1024, 1)
                               : smem_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024, 1);
      const uint64_t db = B_MN ? smem_desc(sb + kk * 2048, BK * 128, 1024, 1)
                               : smem_desc(sb + kk * 32, 16, 1024, 1);
      wgmma_grad<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products on slab j - 1 are done
    fence_acc(acc);
    if (j > 0) mbar_arrive(&empty[(j - 1) % S]);
    if (j + S - 1 < slabs) {  // refill the stage of slab j - 1 with slab j + S - 1
      if (j > 0) mbar_wait(&empty[(j - 1) % S], ((j - 1) / S) & 1);
      load(j + S - 1);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// One CTA computes the BM x BN tile (blockIdx.y, blockIdx.x) of chunk
// blockIdx.z's sum through grad_mainloop, then the epilogue.
template <int BM, int BN, int BK, int S, int CTAS, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(2 * BM, CTAS) grad_wgmma_kernel(GemmArgs p) {
  typedef __nv_bfloat16 T;
  constexpr int THREADS = 2 * BM;
  constexpr int STAGE = BM * BK * 2 + BK * BN * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid >> 7;
  const long m0 = static_cast<long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const uint32_t ring_s = smem_u32(ring);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], THREADS);
      mbar_init(&empty[s], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
  grad_mainloop<BM, BN, BK, S, A_MN, B_MN>(acc, static_cast<const T*>(p.a), p.lda,
                                           static_cast<const T*>(p.b), p.ldb, p.M, p.N, m0, n0,
                                           kbeg, kend, ring_s, full, empty);
  __syncthreads();  // every warpgroup is done with the ring: it takes the tile now

  // accumulator d[4 j + 2 h + b] of lane l in warp v of the warpgroup is row
  // 16 v + l / 4 + 8 h, column 8 j + 2 (l % 4) + b of the warpgroup's piece;
  // fp32 results are stored from there (a lane quad writes 32 bytes of a
  // row), rounded ones staged in the ring as rows of BN values and 16 bytes
  constexpr int ST = BN * 2 + 16;
  static_assert(BM * ST <= S * STAGE, "the finished tile fits the ring");
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  float* out_f = p.out_f == nullptr ? nullptr
                                    : p.out_f + static_cast<long>(blockIdx.z) * p.M * p.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = m0 + r0 + 8 * h;
      const bool in = r < p.M && n0 + c < p.N;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (out_f != nullptr && in)
        *reinterpret_cast<float2*>(out_f + r * p.N + n0 + c) = make_float2(v0, v1);
      if (p.out_t != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(ring + (r0 + 8 * h) * ST + c * 2) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
  if (p.out_t == nullptr) return;
  __syncthreads();
  constexpr int CH = BN / 8, PER = BM * CH / THREADS;
  static_assert((BM * CH) % THREADS == 0, "whole chunks a thread");
  T* out_t = static_cast<T*>(p.out_t);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS, row = e / CH, ch = e % CH;
    const long r = m0 + row;
    const int c = n0 + ch * 8;
    if (r < p.M && c < p.N)
      *reinterpret_cast<uint4*>(out_t + r * p.N + c) =
          *reinterpret_cast<const uint4*>(ring + row * ST + ch * 16);
  }
}

// fp32 on the CUDA cores: the 128 x 96 tile and block_gemm of above (slabs of
// 16), any of the three layouts, the same epilogues and split.
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kThreads) grad_fp32_kernel(GemmArgs p) {
  constexpr int TM = 8, TN = 6, BM = 16 * TM, BN = 16 * TN;
  __shared__ float As[kBK][BM + 1];
  __shared__ float Bs[kBK][BN];
  __shared__ float colp[16][BN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long m0 = static_cast<long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(p.K, kbeg + p.k_chunk);
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    // consecutive threads along whichever index is contiguous in memory
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int m = A_MN ? e % BM : e / kBK, kk = A_MN ? e / BM : e % kBK;
      const long r = m0 + m;
      const int k = k0 + kk;
      As[kk][m] = (r < p.M && k < kend) ? (A_MN ? a[k * p.lda + r] : a[r * p.lda + k]) : 0.f;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int n = B_MN ? e % BN : e / kBK, kk = B_MN ? e / BN : e % kBK;
      const int c = n0 + n, k = k0 + kk;
      Bs[kk][n] = (c < p.N && k < kend) ? (B_MN ? b[k * p.ldb + c] : b[c * p.ldb + k]) : 0.f;
    }
    __syncthreads();
    block_gemm<TM, TN>(acc, As, Bs, ty, tx);
    __syncthreads();
  }

  float* out_f = p.out_f == nullptr ? nullptr
                                    : p.out_f + static_cast<long>(blockIdx.z) * p.M * p.N;
  float* out_t = static_cast<float*>(p.out_t);
  float csum[TN] = {};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= p.N) continue;
      const long at = r * p.N + c;
      float v = acc[i][j];
      if (p.epi == kEpiGeluBwd) {
        v *= gelu_grad(p.aux[at]);
      } else {
        if (p.bias != nullptr) v += p.bias[c];
        if (p.epi == kEpiGeluFwd) {
          p.aux[at] = v;
          v = gelu_exact(v);
        }
      }
      if (out_f != nullptr) out_f[at] = v;
      if (out_t != nullptr) out_t[at] = v;
      csum[j] += v;
    }
  }
  if (p.col_part == nullptr) return;
#pragma unroll
  for (int j = 0; j < TN; ++j) colp[ty][tx + 16 * j] = csum[j];
  __syncthreads();
  if (tid < BN && n0 + tid < p.N) {
    float sum = 0.f;
    for (int k = 0; k < 16; ++k) sum += colp[k][tid];
    p.col_part[static_cast<long>(blockIdx.y) * p.N + n0 + tid] = sum;
  }
}

template <int F, bool A_MN, bool B_MN>
static cudaError_t launch_grad_form(const GemmArgs& p, cudaStream_t s) {
  constexpr GradForm f = kGradForms[F];
  constexpr int smem = grad_smem(f);
  static_assert(smem <= 232448 && f.ctas * (smem + 1024) <= 233472,
                "a CTA's and an SM's shared memory");
  const auto kernel = grad_wgmma_kernel<f.bm, f.bn, f.bk, f.stages, f.ctas, A_MN, B_MN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (p.k_chunk % f.bk != 0 && p.k_chunk < p.K) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((p.N + f.bn - 1) / f.bn),
            static_cast<unsigned>((p.M + f.bm - 1) / f.bm),
            static_cast<unsigned>((p.K + p.k_chunk - 1) / p.k_chunk));
  kernel<<<grid, 2 * f.bm, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool A_MN, bool B_MN>
static cudaError_t launch_grad_bf16(const GemmArgs& p, int form, cudaStream_t s) {
  switch (form) {
    case 0: return launch_grad_form<0, A_MN, B_MN>(p, s);
    case 1:
      if constexpr (!B_MN) return launch_grad_form<1, A_MN, B_MN>(p, s);
      return cudaErrorInvalidValue;
    case 2: return launch_grad_form<2, A_MN, B_MN>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool A_MN, bool B_MN>
static cudaError_t launch_grad_fp32(const GemmArgs& p, cudaStream_t s) {
  if (p.k_chunk % kBK != 0 && p.k_chunk < p.K) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((p.N + 95) / 96), static_cast<unsigned>((p.M + 127) / 128),
            static_cast<unsigned>((p.K + p.k_chunk - 1) / p.k_chunk));
  grad_fp32_kernel<A_MN, B_MN><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// One backward product in `layout`, bf16 in tile form `form` of kGradForms
// (the plan's), fp32 in the CUDA cores' tile. A split K (k_chunk < K) takes
// only fp32 partial slabs: no bias, GELU, rounded output or column sums.
template <typename T>
static cudaError_t launch_grad(const GemmArgs& p, int layout, int form, cudaStream_t s) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.k_chunk <= 0 || layout < kXW || layout > kATB)
    return cudaErrorInvalidValue;
  if (p.k_chunk < p.K && (p.bias != nullptr || p.epi != kEpiPlain || p.out_t != nullptr ||
                          p.col_part != nullptr || p.out_f == nullptr))
    return cudaErrorInvalidValue;
  if (p.col_part != nullptr && p.out_t == nullptr) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    if (layout == kXW) return launch_grad_fp32<false, true>(p, s);
    if (layout == kDYWT) return launch_grad_fp32<false, false>(p, s);
    return launch_grad_fp32<true, true>(p, s);
  }
  // bf16: the plain epilogue (B9c's GELU epilogues run fused, swin_mlp_bwd.cu)
  if (form < 0 || form >= static_cast<int>(sizeof(kGradForms) / sizeof(kGradForms[0])) ||
      p.epi != kEpiPlain || p.bias != nullptr || p.col_part != nullptr)
    return cudaErrorInvalidValue;
  // 16-byte chunks: the contiguous extents and the row strides are multiples
  // of 8 values, the operands 16-byte aligned
  if (p.N % 8 != 0 || p.K % 8 != 0 || (layout == kATB && p.M % 8 != 0) || p.lda % 8 != 0 ||
      p.ldb % 8 != 0 || reinterpret_cast<uintptr_t>(p.a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.b) % 16 != 0)
    return cudaErrorInvalidValue;
  if (layout == kXW) return launch_grad_bf16<false, true>(p, form, s);
  if (layout == kDYWT) return launch_grad_bf16<false, false>(p, form, s);
  return launch_grad_bf16<true, true>(p, form, s);
}

// x @ W for x (rows, k) and W (k, n), both row-major.
static inline GemmArgs xw_args(const void* x, const void* w, int rows, int k, int n) {
  GemmArgs p = {};
  p.a = x; p.lda = k;
  p.b = w; p.ldb = n;
  p.M = rows; p.N = n; p.K = k; p.k_chunk = k;
  return p;
}

// An input gradient (rows, k_in) = dY (rows, n_out) @ W^T for W (k_in, n_out)
// row-major: the contraction runs over W's output width.
static inline GemmArgs input_grad_args(const void* dy, const void* w, int rows, int k_in,
                                       int n_out) {
  GemmArgs p = {};
  p.a = dy; p.lda = n_out;
  p.b = w; p.ldb = n_out;
  p.M = rows; p.N = k_in; p.K = n_out; p.k_chunk = n_out;
  return p;
}

// A weight gradient (m, n) = X^T @ dY over `rows` rows of X (rows, m) and dY
// (rows, n), in chunks of k_chunk rows: fp32 partial slabs into part
// (chunks, m, n).
static inline GemmArgs weight_grad_args(const void* x, const void* dy, float* part, int rows,
                                        int m, int n, int k_chunk) {
  GemmArgs p = {};
  p.a = x; p.lda = m;
  p.b = dy; p.ldb = n;
  p.M = m; p.N = n; p.K = rows; p.k_chunk = k_chunk;
  p.out_f = part;
  return p;
}

// ---------------------------------------------------------------------------
// The fixed-order sums of the backwards' partials: out[i] = part[0][i] +
// part[1][i] + ... + part[count - 1][i], in that order, for up to kMaxSums
// (part, out) pairs in one launch (blockIdx.y picks the pair).
struct PartialSum {
  const float* part;  // (count, len)
  float* out;         // (len)
  int count;
  int len;
};
constexpr int kMaxSums = 8;
struct PartialSums {
  PartialSum job[kMaxSums];
  int n;
};

// A sum of few partials is a thread's, its partials loaded kSumBatch at a
// time (in flight together), then added in order. A sum of kSumWarpFrom or
// more is a warp's: lane l adds partials l, l + 32, ... in order (kSumBatch
// loads in flight), then the lanes' sums meet in a fixed butterfly. Either
// way the order is fixed.
constexpr int kSumBatch = 8;
constexpr int kSumWarpFrom = 32;
__global__ void __launch_bounds__(kThreads) sum_partials_kernel(PartialSums sums) {
  const PartialSum q = sums.job[blockIdx.y];
  if (q.count >= kSumWarpFrom) {
    const int lane = threadIdx.x & 31;
    for (long i = (static_cast<long>(blockIdx.x) * kThreads + threadIdx.x) / 32; i < q.len;
         i += static_cast<long>(gridDim.x) * (kThreads / 32)) {
      const float* src = q.part + i;
      float s = 0.f;
      int c = lane;
      for (; c + 32 * (kSumBatch - 1) < q.count; c += 32 * kSumBatch) {
        float v[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          v[u] = __ldg(src + static_cast<long>(c + 32 * u) * q.len);
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) s += v[u];
      }
      for (; c < q.count; c += 32) s += __ldg(src + static_cast<long>(c) * q.len);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) q.out[i] = s;
    }
    return;
  }
  for (long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x; i < q.len;
       i += static_cast<long>(gridDim.x) * kThreads) {
    const float* src = q.part + i;
    float s = 0.f;
    int c = 0;
    for (; c + kSumBatch <= q.count; c += kSumBatch) {
      float v[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) v[u] = __ldg(src + static_cast<long>(c + u) * q.len);
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) s += v[u];
    }
    for (; c < q.count; ++c) s += __ldg(src + static_cast<long>(c) * q.len);
    q.out[i] = s;
  }
}

static cudaError_t launch_sum_partials(const PartialSums& sums, cudaStream_t s) {
  if (sums.n < 1 || sums.n > kMaxSums) return cudaErrorInvalidValue;
  long threads = 0;  // the most a job has work for
  for (int i = 0; i < sums.n; ++i) {
    const PartialSum& q = sums.job[i];
    if (q.count < 1 || q.len < 1) return cudaErrorInvalidValue;
    const long t = static_cast<long>(q.len) * (q.count >= kSumWarpFrom ? 32 : 1);
    threads = t > threads ? t : threads;
  }
  long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  sum_partials_kernel<<<dim3(static_cast<unsigned>(blocks), sums.n), kThreads, 0, s>>>(sums);
  return cudaGetLastError();
}
