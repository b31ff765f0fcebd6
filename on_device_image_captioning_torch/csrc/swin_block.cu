// B6: a whole Swin block in one launch on the window layout,
//   x1  = x' + proj(window_attention(LN1(x')))
//   out = x1 + fc2(GELU(fc1(LN2(x1))))
// where x' is x itself or, with a transition, x read from the previous block's
// shift layout.
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// swin_block_fused (`_block_body`, with `_transition_strip` folded in). The TPU
// kernel holds a strip of windows, all of the block's weights and every
// intermediate in VMEM. What it keeps out of device memory is kept out here
// too: qkv, the attention output, the post-attention x1, LN2(x1) and the MLP
// hidden activation live only in shared memory and registers; x is read
// through the transition's map_row gather and out is written once. (B4 + B5
// move 32 C extra bytes a row in bf16 over five launches.)
//
// Bound on the H100: operations, 24 C^2 + 4 N C flops a row against 4 C bytes
// in bf16 (about 6 C flop/byte). bf16 products and the attention run on the
// tensor cores (nvcuda::wmma, fp32 accumulators), fp32 on the CUDA cores as
// full fp32.
//
// Design. A thread block has 227 KB of shared memory; a window of 144 rows at
// C = 384 in fp32 is 221 KB for one copy of x alone, so a block cannot hold a
// window's x, LN1(x) and attention output at every width and type. Everything
// but the keys and values is row-local, so the unit of work is a (window, tile
// of 48 query rows) pair: 192 threads (6 warps) a CTA, and the three CTAs of a
// window form a thread-block cluster that shares the keys and values through
// distributed shared memory:
//   per head h   qkv_h (48 x 96) = LN1(x'_tile) @ Wqkv[:, head h] + b for the
//                tile's own rows (LN1(x') staged from L2 in K slabs of 96, the
//                weights streamed from L2 in slabs through shared memory); q
//                scaled in the storage type; cluster barrier; the k and v of
//                the window's other 96 rows copied from the two other CTAs'
//                shared memory; cluster barrier; scores of the tile's 48 rows
//                against the 144 keys + bias + mask, softmax in fp32,
//                exp(s - max) rounded, . v, division after the product
//                (`_attention_rows`); the 48 x 32 result into the tile's
//                attention buffer (48 x C);
//   proj         x1 = x'_tile + attn @ Wproj + b          -> shared memory
//   LN2          LN2(x1) over the attention buffer
//   MLP          the hidden dimension in chunks of 96: fc1 chunk -> exact-erf
//                GELU -> shared memory -> fc2 accumulated in registers over
//                the chunks (48 x C fp32 accumulators a CTA)
//   out          x1 + fc2 + b, written once.
// The price of the row tiles is that each CTA streams every weight from L2
// for 48 rows only, and reads its rows of x' once per head (from L2 after the
// first). In exchange one form serves both widths and both types, and a stage
// of few windows still fills the card (96 CTAs at stage 1, B = 2).
// Every rounding sits where `_block_body` rounds: LN outputs, every product
// + bias, GELU, both residual sums.
#include <cooperative_groups.h>
#include <mma.h>

#include "common.cuh"
#include "window_layout.cuh"

namespace {

using namespace nvcuda;
namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kN = 144;        // tokens of a window
constexpr int kDK = 32;        // head width
constexpr int kR = 48;         // query rows of a CTA
constexpr int kTiles = kN / kR;
constexpr int kThreads = 192;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 96;        // columns of a product tile
constexpr int kKS = 96;        // K slab of LN1(x') staged at a time

// Shared-memory strides (elements). bf16 rows are padded to multiples of 8
// (wmma wants 16-byte row strides and 32-byte tile origins); fp32 strides are
// chosen against bank conflicts.
template <typename T> struct Lay;
// LDP: bf16 probabilities are written over the start of their own fp32 score
// row.
template <> struct Lay<bf16> {
  static constexpr int PAD = 8, LDB = kBN + 8, LDQ = 96 + 8, LDAS = kKS + 8,
                       LDS = kN + 4, LDP = 2 * (kN + 4), LDH = kBN + 8;
};
template <> struct Lay<float> {
  static constexpr int PAD = 4, LDB = kBN, LDQ = 97, LDAS = kKS + 4,
                       LDS = kN + 1, LDP = 0, LDH = kBN + 4;
};

constexpr int kHeadBytes = 1024;                 // row statistics, row sums, source rows
constexpr int kPatchBytes = kWarps * 256 * 4;    // a 16 x 16 fp32 patch a warp
// Rows of a W slab. bf16 moves a whole 96 x 96 slab per barrier pair (what a
// CTA waits for is the slab's way from L2, not its size), but half of one at
// C = 384, so that two CTAs fit an SM there too: a CTA's 48 rows are a long
// serial chain, and a second CTA on the SM fills its waits.
template <typename T, int NT> __host__ __device__ constexpr int slab_rows() {
  return sizeof(T) == 2 ? (NT == 4 ? 48 : 96) : 16;
}
template <typename T, int NT> __host__ __device__ constexpr int fixed_bytes() {
  return kHeadBytes + kPatchBytes + slab_rows<T, NT>() * Lay<T>::LDB * (int)sizeof(T);
}

template <typename T, int NT>
constexpr size_t smem_bytes() {
  using L = Lay<T>;
  constexpr size_t lda = 96 * NT + L::PAD;
  constexpr size_t att = kR * lda * sizeof(T);
  // the staged slab of LN1(x') and the scores are never live together
  constexpr size_t slab = (size_t)kR * L::LDAS * sizeof(T), sc = (size_t)kR * L::LDS * 4;
  constexpr size_t phase1 = (size_t)kN * L::LDQ * sizeof(T) + (slab > sc ? slab : sc);
  constexpr size_t phase2 = kR * lda * sizeof(T) + (size_t)kR * L::LDH * sizeof(T);
  return fixed_bytes<T, NT>() + att + (phase1 > phase2 ? phase1 : phase2);
}

struct BlockArgs {
  const void* x;
  void* out;
  const float *g1, *b1, *g2, *b2;
  const void *wqkv, *wproj, *wfc1, *wfc2;
  const float *bqkv, *bproj, *bfc1, *bfc2;  // null = no bias
  const float *bias, *mask;                  // (H, N, N); (nW, N, N) or null
  int bw, heads, hidden, num_windows;
  float scale, eps;
  int map;
  Geometry geo;
  // training forward (B9a): per-image scales on the two branches (null = 1),
  // window w of image w / windows_per_image, and the mid-block residual out
  const float *m1, *m2;
  void* x2;
  int windows_per_image;
};

// Column of W that column n of a 96-wide product tile reads: contiguous
// (seg = 32) or the q, k and v blocks of one head (seg = C).
struct WCols {
  int n0, seg;
  __device__ __forceinline__ int operator()(int n) const {
    return n0 + (n >> 5) * seg + (n & 31);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// Accumulators of a 48 x 96 product tile held by the CTA.
//   bf16: warp (wm = warp % 3, wn = warp / 3) holds rows 16 wm .. 16 wm + 16,
//         columns 48 wn + 16 j, as wmma fragments;
//   fp32: thread (ty = tid / 16, tx = tid % 16) holds rows ty + 12 i, columns
//         tx + 16 j.
template <typename T> struct Acc;
template <> struct Acc<bf16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[3];
};
template <> struct Acc<float> {
  float v[4][6];
};

__device__ __forceinline__ void acc_zero(Acc<bf16>& a) {
#pragma unroll
  for (int j = 0; j < 3; ++j) wmma::fill_fragment(a.f[j], 0.0f);
}
__device__ __forceinline__ void acc_zero(Acc<float>& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) a.v[i][j] = 0.f;
}

// acc += A (48 x K, shared memory, row stride lda) @ W[0:K, cols] where W
// rows have stride ldw in device memory; the W slabs go through Bs. Every
// thread of the CTA calls it; it starts with a barrier (so what the caller
// wrote to A is visible) and ends without one.
template <int BK>
__device__ __forceinline__ void gemm_acc(Acc<bf16>& acc, const bf16* A, int lda,
                                         const bf16* w, int ldw, WCols cols, int K,
                                         bf16* Bs) {
  using L = Lay<bf16>;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % 3, wn = warp / 3;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * (kBN / 8); e += kThreads) {
      const int kk = e / (kBN / 8), n = (e % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + kk * L::LDB + n) =
          *reinterpret_cast<const uint4*>(w + (long)(k0 + kk) * ldw + cols(n));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * L::LDB + 48 * wn + 16 * j, L::LDB);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, A + (long)(16 * wm) * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < 3; ++j) wmma::mma_sync(acc.f[j], fa, fb[j], acc.f[j]);
    }
  }
}

template <int BK>
__device__ __forceinline__ void gemm_acc(Acc<float>& acc, const float* A, int lda,
                                         const float* w, int ldw, WCols cols, int K,
                                         float* Bs) {
  using L = Lay<float>;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * (kBN / 4); e += kThreads) {
      const int kk = e / (kBN / 4), n = (e % (kBN / 4)) * 4;
      *reinterpret_cast<float4*>(Bs + kk * L::LDB + n) =
          *reinterpret_cast<const float4*>(w + (long)(k0 + kk) * ldw + cols(n));
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[6];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(long)(ty + 12 * i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < 6; ++j) b[j] = Bs[kk * L::LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc.v[i][j] = fmaf(a[i], b[j], acc.v[i][j]);
    }
  }
}

// f(row, column, value) for every element of the tile.
template <typename F>
__device__ __forceinline__ void gemm_epilogue(Acc<bf16>& acc, float* patches, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % 3, wn = warp / 3;
  float* patch = patches + warp * 256;
  const int pr = lane >> 1, pc = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    wmma::store_matrix_sync(patch, acc.f[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f(16 * wm + pr, 48 * wn + 16 * j + pc + e, patch[pr * 16 + pc + e]);
    __syncwarp();
  }
}

template <typename F>
__device__ __forceinline__ void gemm_epilogue(Acc<float>& acc, float*, F f) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) f(ty + 12 * i, tx + 16 * j, acc.v[i][j]);
}

__device__ __forceinline__ float bias_at(const float* b, int c) {
  return b == nullptr ? 0.f : b[c];
}

// Scores of the tile's 48 query rows against the window's 144 keys of one
// head, raw (bias, mask and softmax follow), into S (48 x LDS fp32).
__device__ __forceinline__ void scores(const bf16* qkv, int row0, float* S) {
  using L = Lay<bf16>;
  const int warp = threadIdx.x >> 5;
  for (int tt = warp; tt < (kR / 16) * (kN / 16); tt += kWarps) {
    const int i = tt / (kN / 16), j = tt % (kN / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kDK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
      wmma::load_matrix_sync(fq, qkv + (row0 + 16 * i) * L::LDQ + kk, L::LDQ);
      wmma::load_matrix_sync(fk, qkv + 16 * j * L::LDQ + kDK + kk, L::LDQ);
      wmma::mma_sync(acc, fq, fk, acc);
    }
    wmma::store_matrix_sync(S + 16 * i * L::LDS + 16 * j, acc, L::LDS, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void scores(const float* qkv, int row0, float* S) {
  using L = Lay<float>;
  for (int idx = threadIdx.x; idx < kR * kN; idx += kThreads) {
    const int r = idx / kN, j = idx % kN;
    const float* q = qkv + (row0 + r) * L::LDQ;
    const float* k = qkv + j * L::LDQ + kDK;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kDK; ++d) s = fmaf(q[d], k[d], s);
    S[r * L::LDS + j] = s;
  }
}

// (P . v) / row sum of one head into the tile's attention buffer, columns
// col0 .. col0 + 32. P holds exp(s - max) rounded to the storage type.
__device__ __forceinline__ void weighted_values(const bf16* qkv, const bf16* P, const float*,
                                                const float* sums, float* patches,
                                                bf16* att, int lda, int col0) {
  using L = Lay<bf16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = warp / 2, nn = warp % 2;  // 3 x 2 tiles of 16 x 16, one a warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll
  for (int kt = 0; kt < kN / 16; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
    wmma::load_matrix_sync(fp, P + 16 * i * L::LDP + 16 * kt, L::LDP);
    wmma::load_matrix_sync(fv, qkv + 16 * kt * L::LDQ + 2 * kDK + 16 * nn, L::LDQ);
    wmma::mma_sync(acc, fp, fv, acc);
  }
  float* patch = patches + warp * 256;
  wmma::store_matrix_sync(patch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int pr = lane >> 1, pc = (lane & 1) * 8;
  const float inv = 1.0f / sums[16 * i + pr];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    att[(16 * i + pr) * lda + col0 + 16 * nn + pc + e] =
        __float2bfloat16(patch[pr * 16 + pc + e] * inv);
  __syncwarp();
}

__device__ __forceinline__ void weighted_values(const float* qkv, const float*, const float* S,
                                                const float* sums, float*, float* att,
                                                int lda, int col0) {
  using L = Lay<float>;
  for (int idx = threadIdx.x; idx < kR * kDK; idx += kThreads) {
    const int r = idx / kDK, c = idx % kDK;
    const float* p = S + r * L::LDS;
    const float* v = qkv + 2 * kDK + c;
    float o = 0.f;
    for (int j = 0; j < kN; ++j) o = fmaf(p[j], v[j * L::LDQ], o);
    att[r * lda + col0 + c] = o * (1.0f / sums[r]);
  }
}

// Two CTAs share an SM where their shared memory allows it (bf16).
template <typename T, int NT>
__global__ void __cluster_dims__(kTiles, 1, 1)
    __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    swin_block_kernel(const BlockArgs p) {
  using L = Lay<T>;
  constexpr int C = 96 * NT, LDA = C + L::PAD;
  constexpr int V = 16 / sizeof(T);  // values of a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  float* mean1 = reinterpret_cast<float*>(smem);       // LN1 statistics of the tile's rows
  float* rstd1 = mean1 + kR;
  float* sums = rstd1 + kR;                            // kR row sums of exp
  int* src_row = reinterpret_cast<int*>(sums + kR);    // the tile's kR source rows of x
  float* patches = reinterpret_cast<float*>(smem + kHeadBytes);
  T* Bs = reinterpret_cast<T*>(smem + kHeadBytes + kPatchBytes);
  constexpr int BK = slab_rows<T, NT>();
  T* att = reinterpret_cast<T*>(smem + fixed_bytes<T, NT>());   // kR x LDA: attention, then LN2(x1)
  unsigned char* u = smem + fixed_bytes<T, NT>() + kR * LDA * sizeof(T);
  // while the heads run
  T* qkv = reinterpret_cast<T*>(u);                    // kN x LDQ: q | k | v of one head
  T* As = qkv + kN * L::LDQ;                           // kR x LDAS slab of LN1(x'), or
  float* S = reinterpret_cast<float*>(As);             // kR x LDS scores (never both)
  T* P = reinterpret_cast<T*>(S);                      // bf16: over the rows of S
  // after them, over the same bytes
  T* x1 = reinterpret_cast<T*>(u);                     // kR x LDA
  T* hc = x1 + kR * LDA;                               // kR x LDH hidden chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cg::cluster_group cluster = cg::this_cluster();     // the window's kTiles CTAs
  const int tile = (int)cluster.block_rank();
  const int w = blockIdx.x / kTiles, row0 = tile * kR;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const T* wqkv = static_cast<const T*>(p.wqkv);
  const T* wproj = static_cast<const T*>(p.wproj);
  const T* wfc1 = static_cast<const T*>(p.wfc1);
  const T* wfc2 = static_cast<const T*>(p.wfc2);
  const float s1 = p.m1 == nullptr ? 1.0f : p.m1[w / p.windows_per_image];
  const float s2 = p.m2 == nullptr ? 1.0f : p.m2[w / p.windows_per_image];
  T* x2 = static_cast<T*>(p.x2);

  for (int m = tid; m < kR; m += kThreads)
    src_row[m] = (int)map_row(p.map, (long)w * kN + row0 + m, 0, p.geo);
  __syncthreads();

  // LN1 statistics of the tile's rows (fp32, two passes)
  for (int m = warp; m < kR; m += kWarps) {
    const T* row = x + (long)src_row[m] * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f<T>(row[c]);
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f<T>(row[c]) - mean;
      q = fmaf(d, d, q);
    }
    q = warp_sum(q);
    if (lane == 0) {
      mean1[m] = mean;
      rstd1[m] = 1.0f / sqrtf(q / C + p.eps);
    }
  }
  __syncthreads();

  // ---- attention sublayer, a head at a time --------------------------------
  const float scale_t = round_t<T>(p.scale);
  const float* mask_w =
      p.mask == nullptr ? nullptr : p.mask + (long)(w % p.num_windows) * kN * kN;
  for (int h = 0; h < p.heads; ++h) {
    {
      // q, k and v of the tile's own rows
      Acc<T> acc;
      acc_zero(acc);
      const WCols cols{h * kDK, C};
      for (int k0 = 0; k0 < C; k0 += kKS) {
        __syncthreads();  // the slab before has been multiplied
        for (int e = tid; e < kR * (kKS / V); e += kThreads) {
          const int m = e / (kKS / V), kc = (e % (kKS / V)) * V;
          uint4 raw = *reinterpret_cast<const uint4*>(x + (long)src_row[m] * C + k0 + kc);
          T* hv = reinterpret_cast<T*>(&raw);
          const float mean = mean1[m], rstd = rstd1[m];
#pragma unroll
          for (int j = 0; j < V; ++j)
            hv[j] = from_f<T>((to_f<T>(hv[j]) - mean) * rstd * p.g1[k0 + kc + j] +
                              p.b1[k0 + kc + j]);
          *reinterpret_cast<uint4*>(As + m * L::LDAS + kc) = raw;
        }
        gemm_acc<BK>(acc, As, L::LDAS, wqkv + (long)k0 * 3 * C, 3 * C, cols, kKS, Bs);
      }
      gemm_epilogue(acc, patches, [&](int r, int n, float v) {
        v = round_t<T>(v + bias_at(p.bqkv, cols(n)));
        if (n < kDK) v = round_t<T>(v * scale_t);  // q scaled in the storage type
        qkv[(row0 + r) * L::LDQ + n] = from_f<T>(v);
      });
    }
    // k and v of the window's other rows, from the shared memory of the CTAs
    // that computed them
    cluster.sync();
    {
      constexpr bool kVec = (L::LDQ * sizeof(T)) % 16 == 0;
      constexpr int W = kVec ? V : 1, kPerRow = 2 * kDK / W;
      for (int e = tid; e < (kTiles - 1) * kR * kPerRow; e += kThreads) {
        const int peer = (tile + 1 + e / (kR * kPerRow)) % kTiles;
        const int r = (e / kPerRow) % kR, c = kDK + (e % kPerRow) * W;
        const int at = (peer * kR + r) * L::LDQ + c;
        const T* theirs = cluster.map_shared_rank(qkv, peer);
        if constexpr (kVec)
          *reinterpret_cast<uint4*>(qkv + at) = *reinterpret_cast<const uint4*>(theirs + at);
        else
          qkv[at] = theirs[at];
      }
    }
    cluster.sync();  // every CTA has its copy: the rows may be overwritten
    scores(qkv, row0, S);
    __syncthreads();
    // + bias + mask: the tile's 48 rows of either are one contiguous run, read
    // coalesced with many loads in flight
    {
      const float* brun = p.bias + ((long)h * kN + row0) * kN;
      const float* mrun = mask_w == nullptr ? nullptr : mask_w + (long)row0 * kN;
#pragma unroll 6
      for (int idx = tid; idx < kR * kN; idx += kThreads) {
        const int r = idx / kN, j = idx - r * kN;
        float sv = S[r * L::LDS + j] + __ldg(brun + idx);
        if (mrun != nullptr) sv += __ldg(mrun + idx);
        S[r * L::LDS + j] = sv;
      }
    }
    __syncthreads();
    // softmax pieces: a warp a row, its lanes across the keys
    for (int r = warp; r < kR; r += kWarps) {
      float sv[(kN + 31) / 32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < (kN + 31) / 32; ++t) {
        const int j = lane + 32 * t;
        sv[t] = j < kN ? S[r * L::LDS + j] : -CUDART_INF_F;
        mx = fmaxf(mx, sv[t]);
      }
      mx = warp_max(mx);  // every lane has read its columns of this row
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < (kN + 31) / 32; ++t) {
        const int j = lane + 32 * t;
        if (j < kN) {
          const float e = expf(sv[t] - mx);
          sum += e;
          if constexpr (sizeof(T) == 2)
            P[r * L::LDP + j] = from_f<T>(e);
          else
            S[r * L::LDS + j] = e;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) sums[r] = sum;
    }
    __syncthreads();
    weighted_values(qkv, P, S, sums, patches, att, LDA, h * kDK);
  }

  // ---- proj + residual: x1 --------------------------------------------------
#pragma unroll 1
  for (int nt = 0; nt < NT; ++nt) {
    Acc<T> acc;
    acc_zero(acc);
    gemm_acc<BK>(acc, att, LDA, wproj, C, WCols{nt * kBN, 32}, C, Bs);
    gemm_epilogue(acc, patches, [&](int r, int n, float v) {
      const int c = nt * kBN + n;
      v = round_t<T>(v + bias_at(p.bproj, c));
      const float res = to_f<T>(x[(long)src_row[r] * C + c]);
      // rounded to the storage type here: LN2, the residual and the backward
      // all read this value
      const T mid = from_f<T>(res + s1 * v);
      x1[r * LDA + c] = mid;
      if (x2 != nullptr) x2[((long)w * kN + row0 + r) * C + c] = mid;
    });
  }
  __syncthreads();

  // ---- LN2(x1) over the attention buffer --------------------------------------
  for (int r = warp; r < kR; r += kWarps) {
    const T* row = x1 + r * LDA;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f<T>(row[c]);
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f<T>(row[c]) - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = 1.0f / sqrtf(warp_sum(q) / C + p.eps);
    for (int c = lane; c < C; c += 32)
      att[r * LDA + c] = from_f<T>((to_f<T>(row[c]) - mean) * rstd * p.g2[c] + p.b2[c]);
  }

  // ---- MLP: hidden chunks of 96, fc2 accumulated in registers -----------------
  Acc<T> acc2[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc_zero(acc2[nt]);
#pragma unroll 1
  for (int ch = 0; ch < p.hidden / kBN; ++ch) {
    {
      Acc<T> acc1;
      acc_zero(acc1);
      gemm_acc<BK>(acc1, att, LDA, wfc1, p.hidden, WCols{ch * kBN, 32}, C, Bs);
      gemm_epilogue(acc1, patches, [&](int r, int n, float v) {
        v = round_t<T>(v + bias_at(p.bfc1, ch * kBN + n));
        hc[r * L::LDH + n] = from_f<T>(gelu_exact(v));
      });
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      gemm_acc<BK>(acc2[nt], hc, L::LDH, wfc2 + (long)ch * kBN * C, C, WCols{nt * kBN, 32},
                  kBN, Bs);
  }

  // ---- out = x1 + fc2 + b ---------------------------------------------------------
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    gemm_epilogue(acc2[nt], patches, [&](int r, int n, float v) {
      const int c = nt * kBN + n;
      v = round_t<T>(v + bias_at(p.bfc2, c));
      out[((long)w * kN + row0 + r) * C + c] = from_f<T>(to_f<T>(x1[r * LDA + c]) + s2 * v);
    });
}

template <typename T, int NT>
cudaError_t launch_typed(const BlockArgs& p, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, NT>();
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(swin_block_kernel<T, NT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  swin_block_kernel<T, NT><<<p.bw * kTiles, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x, out (bw, 144, c); LayerNorm parameters and biases fp32; weights (in, out)
// in the storage type; bias (heads, 144, 144) fp32; mask (num_windows, 144,
// 144) fp32 or null. transition != 0 reads x through the window transition of
// a res grid with delta = (to_shift - from_shift) mod res. Built for windows
// of 144 tokens, heads of 32 and c = 192 or 384.
static int block_dispatch(
    const void* x, const void* g1, const void* b1, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* g2, const void* b2,
    const void* wfc1, const void* bfc1, const void* wfc2, const void* bfc2,
    const void* bias, const void* mask, void* out, int bw, int n, int c, int heads,
    int hidden, int num_windows, float scale, float eps, int transition, int res,
    int window, int delta, const void* m1, const void* m2, void* x2,
    int windows_per_image, int dtype, void* stream) {
  if (n != kN || c != heads * kDK || (c != 192 && c != 384) || hidden <= 0 ||
      hidden % kBN != 0 || bw <= 0 || num_windows <= 0)
    return cudaErrorInvalidValue;
  BlockArgs p = {};
  p.x = x; p.out = out;
  p.g1 = static_cast<const float*>(g1); p.b1 = static_cast<const float*>(b1);
  p.g2 = static_cast<const float*>(g2); p.b2 = static_cast<const float*>(b2);
  p.wqkv = wqkv; p.wproj = wproj; p.wfc1 = wfc1; p.wfc2 = wfc2;
  p.bqkv = static_cast<const float*>(bqkv); p.bproj = static_cast<const float*>(bproj);
  p.bfc1 = static_cast<const float*>(bfc1); p.bfc2 = static_cast<const float*>(bfc2);
  p.bias = static_cast<const float*>(bias); p.mask = static_cast<const float*>(mask);
  p.bw = bw; p.heads = heads; p.hidden = hidden; p.num_windows = num_windows;
  p.scale = scale; p.eps = eps;
  p.map = kMapIdentity;
  p.geo = Geometry{0, 0, 0};
  p.m1 = static_cast<const float*>(m1); p.m2 = static_cast<const float*>(m2);
  p.x2 = x2; p.windows_per_image = windows_per_image;
  if (transition) {
    if (window <= 0 || window * window != n || res % window != 0 ||
        bw % ((res / window) * (res / window)) != 0 || delta < 0 || delta >= res)
      return cudaErrorInvalidValue;
    p.map = kMapTransition;
    p.geo = Geometry{res, window, delta};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return c == 192 ? launch_typed<float, 2>(p, s) : launch_typed<float, 4>(p, s);
  if (dtype == kBFloat16)
    return c == 192 ? launch_typed<bf16, 2>(p, s) : launch_typed<bf16, 4>(p, s);
  return cudaErrorInvalidValue;
}

extern "C" int swin_block_launch(
    const void* x, const void* g1, const void* b1, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* g2, const void* b2,
    const void* wfc1, const void* bfc1, const void* wfc2, const void* bfc2,
    const void* bias, const void* mask, void* out, int bw, int n, int c, int heads,
    int hidden, int num_windows, float scale, float eps, int transition, int res,
    int window, int delta, int dtype, void* stream) {
  return block_dispatch(x, g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2,
                        bias, mask, out, bw, n, c, heads, hidden, num_windows, scale, eps,
                        transition, res, window, delta, nullptr, nullptr, nullptr, 1, dtype,
                        stream);
}

// B9a, the training forward (ops/swin_block_fused.py::_train_fwd_call,
// `_block_kernel_train`): the same launch with the per-image stochastic-depth
// scales m1, m2 (bw / windows_per_image, fp32) on the two branches,
//   x2  = x + m1[image] * proj(...)      written to x2 (bw, 144, c) as it is
//   out = x2 + m2[image] * mlp(...)      formed, for the backward to recompute from,
// each scale multiplying the rounded branch in fp32 before the residual add
// and its rounding. x is already in the block's layout (no transition).
extern "C" int swin_block_train_launch(
    const void* x, const void* g1, const void* b1, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* g2, const void* b2,
    const void* wfc1, const void* bfc1, const void* wfc2, const void* bfc2,
    const void* bias, const void* mask, const void* m1, const void* m2, void* x2, void* out,
    int bw, int n, int c, int heads, int hidden, int num_windows, int windows_per_image,
    float scale, float eps, int dtype, void* stream) {
  if (m1 == nullptr || m2 == nullptr || x2 == nullptr || windows_per_image <= 0 ||
      bw % windows_per_image != 0)
    return cudaErrorInvalidValue;
  return block_dispatch(x, g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2,
                        bias, mask, out, bw, n, c, heads, hidden, num_windows, scale, eps, 0,
                        0, 0, 0, m1, m2, x2, windows_per_image, dtype, stream);
}
