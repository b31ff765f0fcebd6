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
// too, but for two row blocks of a window that pass through L2 on their way
// between the CTAs of a cluster (the attention output and x1): qkv, the
// scores, LN1(x'), LN2(x1), the MLP hidden activation and the MLP's partial
// sums live only in shared memory and registers; x is read through the
// transition's map_row gather and out is written once. (B4 + B5 move 32 C
// extra bytes a row in bf16 over seven launches.)
//
// Bound on the H100: operations, 24 C^2 + 4 N C flops a row against 4 C bytes
// in bf16 (about 6 C flop/byte). Every rounding sits where `_block_body`
// rounds: LN outputs, every product + bias, q scaled in the storage type,
// exp(s - max) rounded before . v and the division after it, GELU (exact
// erf), both residual sums.
//
// bf16 (the serving form): a cluster of CTAs a window, the window's work split
// by COLUMNS, so that every weight byte crosses L2 -> SM once per window. CTA
// r of the cluster owns, as the launch plan (ops/block_plan.py) names them:
// one or two heads (their q, k, v columns, the attention and the same
// channels of proj and of the block's output) and a slice of the MLP's hidden
// width (fc1's columns, fc2's rows). Three consumer warpgroups (384 threads)
// hold the window's 144 rows padded to 192 (three 64-row wgmma tiles; the 48
// pad rows read whatever follows in shared memory and are never stored):
//   LN1       every CTA normalizes the window's 144 rows of x' (gathered through
//             the transition) once, into shared memory (the resident A operand:
//             K blocks of 64, 128-byte rows, the 128-byte swizzle);
//   qkv       its heads' q | k | v columns, passes of 96 (wgmma m64n96k16 from
//             the resident A and W slabs from the ring); q scaled in the
//             storage type; q, k, v stay in shared memory;
//   attention its heads, 16 query rows a warp (mma.sync m16n8k16, the scores
//             and the softmax in registers: + bias + mask, exp(s - max)
//             rounded to bf16 as the A operand of . v, the division after);
//             the output columns go to an L2 scratch;
//   proj      cluster barrier; every CTA gathers the window's whole attention
//             output back (cp.async) and forms x1 = x' + attn @ Wproj + b for
//             its own channels; x1 goes to the output (or x2) in L2;
//   LN2       cluster barrier; every CTA gathers x1's whole rows and normalizes
//             them in place;
//   fc1       its hidden slice, passes of 128: GELU(LN2(x1) @ W1 + b1) rounded
//             into shared memory;
//   fc2       K split over the cluster, the partial sums meeting as a
//             reduce-scatter in `cluster` rounds: in round t CTA r forms the
//             partial product of CTA (r + t)'s channels over its own hidden
//             slice and stores it into that CTA's shared memory (distributed
//             shared memory, 16-byte stores); each CTA adds what it receives
//             in round order, its own partial first, then those of CTAs
//             r - 1, r - 2, ... (no atomics: two launches agree bit for bit);
//             the round's barrier is split, the next round's product runs
//             while it completes; out = x1 + that + b2, rounded.
// The W slabs (32 K rows) of all of a CTA's products are one stream, issued
// by one thread through TMA (a 32-column block of a slab is one tensor copy,
// written in the 64-byte swizzle its wgmma B descriptor reads) into a ring of
// 2-8 stages (as many as shared memory holds), stages - 1 slabs ahead of the
// products and across the passes' epilogues and the cluster barriers; a
// stage's full barrier completes by the copies' bytes, its empty barrier by
// one arrival of each warp.
// What bounds it (final run, PERF.md): the phases run one after another in a
// CTA, one CTA an SM, so the CUDA-core work (LN1, LN2, the softmax with its
// bias and mask from L2, the GELU epilogue, the reduce-scatter's stores) is
// not hidden under the tensor cores; the products' loops themselves run at a
// third to a half of the SM's bf16 rate.
//
// fp32 (the card's parity checks, not serving): the CUDA-core design of the
// first port, a (window, 48 query rows) pair a CTA and the three CTAs of a
// window in a cluster that shares the keys and values through distributed
// shared memory; full fp32 FMAs.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its encoder's types (the encoder itself via the runtime)

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "window_layout.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kN = 144;        // tokens of a window
constexpr int kDK = 32;        // head width
constexpr int kMaxCluster = 8; // CTAs a window at most (the portable cluster size)
constexpr int kMaxShared = 232448;  // dynamic shared memory a CTA may hold

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
  // the launch plan (bf16): CTAs a window, ring stages, fc2 partial-sum
  // buffers, the union region's bytes, and what each rank owns
  int cluster, stages, nbuf, u_bytes, recv_bytes;
  int head0[kMaxCluster], nheads[kMaxCluster], hid0[kMaxCluster], nhid[kMaxCluster];
  void* attn;  // (bw, N, C) scratch: the attention output on its way between the CTAs
  // TMA maps of the four bf16 weights, boxes of kBK rows x 32 columns in the
  // 64-byte swizzle (the layout the products' B descriptors read)
  CUtensorMap tm_qkv, tm_proj, tm_fc1, tm_fc2;
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

__device__ __forceinline__ float bias_at(const float* b, int c) {
  return b == nullptr ? 0.f : b[c];
}

// b[c], b[c + 1] (c even), or zeros without a bias
__device__ __forceinline__ float2 bias2(const float* b, int c) {
  return b == nullptr ? make_float2(0.f, 0.f) : __ldg(reinterpret_cast<const float2*>(b + c));
}

// ===========================================================================
// bf16 on Hopper
// ===========================================================================

constexpr int kThreadsH = 384;                 // three consumer warpgroups
constexpr int kBK = 32;                        // K rows of a W slab
constexpr int kSlabCols = 128;                 // the widest product pass
constexpr int kStageBytes = kBK * kSlabCols * 2;
constexpr int kMaxStages = 8;
constexpr int kKBlock = kN * 128;              // a 64-wide K block of a resident A operand
constexpr int kHeadBytes = 3 * kN * 64;        // q, k, v of one head: rows of 64 bytes
constexpr int kRealThreads = 288;              // threads whose accumulator rows include real rows
constexpr int kProducerWarp = 11;              // issues every W slab (its accumulator rows are all padding)
// fc2's partial sums an owner receives in one round: 576 bytes a channel it
// owns (kRealThreads threads x 2 rows of fp32 pairs for every 8 channels)
constexpr int kRecvBytesPerChannel = 2 * kRealThreads * 8 / 8;
constexpr int kMaxPasses = 24;                 // product passes of a CTA (its W stream's table)
constexpr int kMiscBytes = 2048;               // the ring's barriers, the source rows, the pass table

// Dynamic shared memory of a plan: 1024 to align, the resident A operand
// (kN x c), the union region (the own heads' q | k | v, then the hidden
// slice), the ring and the barriers with the source rows. ops/block_plan.py
// mirrors this formula (its CPU tests read it from here).
constexpr int block_smem(int c, int u_bytes, int stages) {
  return 1024 + kN * c * 2 + u_bytes + stages * kStageBytes + kMiscBytes;
}

// The cluster barrier, whole or in its two halves (work between them
// overlaps the wait)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The W slab source of one product pass: K rows row0 .. of a (K, ld)
// row-major weight, at `natoms` 32-column blocks starting at columns c0..c3.
struct WSrc {
  const CUtensorMap* map;
  int row0, natoms;
  int c0, c1, c2, c3;
  int slabs;  // K / kBK
  __device__ __forceinline__ int col(int a) const {
    return a == 0 ? c0 : a == 1 ? c1 : a == 2 ? c2 : c3;
  }
};

// The ring: slab g (counted over the whole kernel) sits in stage g % stages.
// A CTA's products are one stream of W slabs, pass after pass as the pass
// table (built once at the start) lists them, and one thread (lane 0 of
// kProducerWarp) issues it by TMA, stages - 1 slabs ahead of the products,
// across the passes' epilogues and the cluster barriers: a 32-column block of
// a slab is one tensor copy, which lands in the 64-byte swizzle and completes
// the stage's full barrier by its bytes. empty[s] completes when each of the
// 12 warps has its products on the slab done (lane 0 arrives for the warp).
// The warps never wait for one another in the ring, only for the copies.
struct Pipe {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  const WSrc* passes;
  int npasses, stages, consumed;
  bool producer;
  int issued, pass, slab;  // the producer's cursor: next slab, its pass and index there
};

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// box (x = column, y = row) of a 2-d tensor map into shared memory, reported
// to bar by its bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// The next slab of the stream into its stage once the slab it replaces is
// consumed (the producer thread): atom a (32 columns) at a * 2048, its row kr,
// 16-byte chunk c at kr * 64 + (c ^ ((kr >> 1) & 3)) * 16, as TMA writes it.
__device__ __forceinline__ void issue_next(Pipe& q) {
  const WSrc& s = q.passes[q.pass];
  const int g = q.issued++;
  const int st = g % q.stages;
  if (g >= q.stages) mbar_wait(&q.empty[st], ((g / q.stages) - 1) & 1);
  const uint32_t base = smem_u32(q.ring + st * kStageBytes);
  mbar_expect_tx(&q.full[st], s.natoms * kBK * 64);
  for (int a = 0; a < s.natoms; ++a)
    tma_load_2d(base + a * (kBK * 64), s.map, s.col(a), s.row0 + q.slab * kBK, &q.full[st]);
  if (++q.slab == s.slabs) {
    ++q.pass;
    q.slab = 0;
  }
}

// The producer issues the stream up to slab `last` (or to its end).
__device__ __forceinline__ void issue_to(Pipe& q, int last) {
  while (q.issued <= last && q.pass < q.npasses) issue_next(q);
}

// acc (the warpgroup's 64 rows x N) = A (resident, K-major, 128-byte swizzle,
// K blocks of kKBlock bytes) @ the next pass's W columns, `slabs` slabs of K;
// the producer keeps the stream going as the slabs are consumed.
template <int N>
__device__ __forceinline__ void product(float (&acc)[N / 2], uint32_t a_s, int slabs, Pipe& q) {
  const int wg = threadIdx.x >> 7;
  const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int g0 = q.consumed;
  for (int i = 0; i < slabs; ++i) {
    const int g = g0 + i, st = g % q.stages;
    mbar_wait(&q.full[st], (g / q.stages) & 1);
    fence_proxy_async();
    const int k0 = i * kBK;
    const uint32_t a = a_s + (k0 >> 6) * kKBlock + wg * 64 * 128 + (k0 & 63) * 2;
    const uint32_t b = smem_u32(q.ring + st * kStageBytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_tile<N>(acc, smem_desc(a + kk * 32, 16, 1024, 1),
                    smem_desc(b + kk * 1024, kBK * 64, 512, 2));
    wgmma_commit();
    wgmma_wait<1>();  // the products on slab g - 1 are done
    fence_acc(acc);
    if (i > 0 && lead) mbar_arrive(&q.empty[(g - 1) % q.stages]);
    if (q.producer) issue_to(q, g + q.stages - 1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lead) mbar_arrive(&q.empty[(g0 + slabs - 1) % q.stages]);
  q.consumed = g0 + slabs;
}

// Accumulator d[4 j + 2 h + b] of lane l in warp v of warpgroup g is row
// 64 g + 16 v + l / 4 + 8 h, column 8 j + 2 (l % 4) + b of the pass.
__device__ __forceinline__ int acc_row(int h) {
  const int tid = threadIdx.x, lane = tid & 31;
  return (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2) + 8 * h;
}

// Byte offset of chunk ch (8 values) of row m of a resident A operand.
__device__ __forceinline__ int a_chunk(int m, int ch) {
  return (ch >> 3) * kKBlock + m * 128 + (((ch & 7) ^ (m & 7)) << 4);
}

// LayerNorm of the window's 144 rows into the resident A operand: eight lanes
// a row, each holding C / 64 16-byte chunks (chunk sub + 8 u), statistics in
// fp32 in two passes over the registers, (v - mean) rstd g + b rounded to bf16.
// `load(m, ch)` gives chunk ch of row m (which may be A's own: in place).
template <int C, typename Load>
__device__ __forceinline__ void layernorm_rows(Load load, const float* g, const float* b,
                                               float eps, uint8_t* A) {
  constexpr int NC = C / 64;
  const int lane = threadIdx.x & 31, sub = lane & 7;
  for (int m = (threadIdx.x >> 5) * 4 + (lane >> 3); m < kN; m += kThreadsH / 8) {
    uint4 raw[NC];
#pragma unroll
    for (int u = 0; u < NC; ++u) raw[u] = load(m, sub + 8 * u);
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const bf16* h = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += __bfloat162float(h[e]);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / C;
    float qs = 0.f;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const bf16* h = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __bfloat162float(h[e]) - mean;
        qs = fmaf(d, d, qs);
      }
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) qs += __shfl_xor_sync(0xffffffffu, qs, o);
    const float rstd = 1.0f / sqrtf(qs / C + eps);
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int ch = sub + 8 * u, k = ch * 8;
      const float4* gp = reinterpret_cast<const float4*>(g + k);
      const float4* bp = reinterpret_cast<const float4*>(b + k);
      const float4 g4[2] = {__ldg(gp), __ldg(gp + 1)}, b4[2] = {__ldg(bp), __ldg(bp + 1)};
      const float* gf = reinterpret_cast<const float*>(g4);
      const float* bf = reinterpret_cast<const float*>(b4);
      bf16* h = reinterpret_cast<bf16*>(&raw[u]);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = __float2bfloat16((__bfloat162float(h[e]) - mean) * rstd * gf[e] + bf[e]);
      *reinterpret_cast<uint4*>(A + a_chunk(m, ch)) = raw[u];
    }
  }
}

// The window's 144 rows of a (rows, C) bf16 matrix in L2 (row m of the
// window at row(m)) into the resident A operand by cp.async, then waited for.
template <int C, typename Row>
__device__ __forceinline__ void gather_rows(const bf16* src, Row row, uint8_t* A) {
  const uint32_t a_s = smem_u32(A);
  for (int e = threadIdx.x; e < kN * (C / 8); e += kThreadsH) {
    const int m = e / (C / 8), ch = e - m * (C / 8);
    cp_async16(a_s + a_chunk(m, ch), src + static_cast<long>(row(m)) * C + ch * 8, true);
  }
  cp_async_wait_all();
}

// --- the attention core on mma.sync (16 query rows a warp) ------------------

// Rows 16 rt .. 16 rt + 15 of one head: scores against the 144 keys + bias +
// mask, softmax in fp32, exp(s - max) rounded to bf16 and multiplied by v,
// then divided by the fp32 row sum (`_attention_rows`); written to `out`
// (row stride C) rounded.
__device__ __forceinline__ void attention_rows(uint32_t qkv_s, const float* bias_h,
                                               const float* mask_w, int rt, bf16* out, int C) {
  const int lane = threadIdx.x & 31;
  const uint32_t Qs = qkv_s, Ks = qkv_s + kN * 64, Vs = qkv_s + 2 * kN * 64;
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldsm_x4(qa[kk], Qs + row64(16 * rt + (lane & 15), 2 * kk + (lane >> 4)));
  float s[kN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
    uint32_t kb[4];
    ldsm_x4(kb, Ks + row64(8 * nt + (lane & 7), lane >> 3));
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma16816(s[nt], qa[0], kb[0], kb[1]);
    mma16816(s[nt], qa[1], kb[2], kb[3]);
  }
  const int r0 = 16 * rt + (lane >> 2), cq = 2 * (lane & 3);
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
    const int c = 8 * nt + cq;
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(bias_h + r0 * kN + c));
    const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias_h + (r0 + 8) * kN + c));
    s[nt][0] += b0.x; s[nt][1] += b0.y; s[nt][2] += b1.x; s[nt][3] += b1.y;
    if (mask_w != nullptr) {
      const float2 m0 = __ldg(reinterpret_cast<const float2*>(mask_w + r0 * kN + c));
      const float2 m1 = __ldg(reinterpret_cast<const float2*>(mask_w + (r0 + 8) * kN + c));
      s[nt][0] += m0.x; s[nt][1] += m0.y; s[nt][2] += m1.x; s[nt][3] += m1.y;
    }
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
  uint32_t pa[kN / 8][2];
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
    const float e0 = expf(s[nt][0] - mx0), e1 = expf(s[nt][1] - mx0);
    const float e2 = expf(s[nt][2] - mx1), e3 = expf(s[nt][3] - mx1);
    sum0 += e0 + e1;
    sum1 += e2 + e3;
    pa[nt][0] = pack_bf16(e0, e1);
    pa[nt][1] = pack_bf16(e2, e3);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  float o_acc[4][4];
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) o_acc[dt][0] = o_acc[dt][1] = o_acc[dt][2] = o_acc[dt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t vb[4];
      ldsm_x4_t(vb, Vs + row64(16 * kk + (lane & 15), 2 * dp + (lane >> 4)));
      mma16816(o_acc[2 * dp], a, vb[0], vb[1]);
      mma16816(o_acc[2 * dp + 1], a, vb[2], vb[3]);
    }
  }
  const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int c = 8 * dt + cq;
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(r0) * C + c) =
        __floats2bfloat162_rn(o_acc[dt][0] * inv0, o_acc[dt][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(r0 + 8) * C + c) =
        __floats2bfloat162_rn(o_acc[dt][2] * inv1, o_acc[dt][3] * inv1);
  }
}

// --- the kernel ---------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreadsH, 1)
    swin_block_wgmma_kernel(const __grid_constant__ BlockArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* A = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* U = A + kN * C * 2;  // q | k | v of the own heads, then the hidden slice
  Pipe q;
  q.ring = U + p.u_bytes;
  q.full = reinterpret_cast<uint64_t*>(q.ring + p.stages * kStageBytes);
  q.empty = q.full + kMaxStages;
  q.stages = p.stages;
  q.consumed = q.issued = q.pass = q.slab = 0;
  q.producer = threadIdx.x == kProducerWarp * 32;
  int* src_row = reinterpret_cast<int*>(q.empty + kMaxStages);  // the window's rows of x
  WSrc* passes = reinterpret_cast<WSrc*>(src_row + kN);         // the CTA's W stream
  q.passes = passes;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = blockIdx.x / p.cluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head0 = p.head0[rank], nh = p.nheads[rank];
  const int ch0 = head0 * kDK, cw = nh * kDK;
  const int hid0 = p.hid0[rank], nhid = p.nhid[rank];
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* out = static_cast<bf16*>(p.out);
  // x1 (the mid-block residual) goes to x2 where the caller keeps it, else
  // to out, which its final value overwrites
  bf16* x1g = static_cast<bf16*>(p.x2 != nullptr ? p.x2 : p.out) + static_cast<long>(w) * kN * C;
  bf16* attn = static_cast<bf16*>(p.attn) + static_cast<long>(w) * kN * C;
  const float s1 = p.m1 == nullptr ? 1.0f : p.m1[w / p.windows_per_image];
  const float s2 = p.m2 == nullptr ? 1.0f : p.m2[w / p.windows_per_image];
  const uint32_t a_s = smem_u32(A), u_s = smem_u32(U);

  // the CTA's passes in the order its products run them: q | k | v of its
  // heads (96 columns a pass), proj of its channels, fc1 over its hidden slice
  // (128 columns a pass), fc2 for the channels of rank + t, t = 0 .. cluster
  const int nqkv = nh, nfc1 = (nhid + kSlabCols - 1) / kSlabCols;
  const int npasses = nqkv + 1 + nfc1 + p.cluster;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&q.full[s], 1);
      mbar_init(&q.empty[s], kThreadsH / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int k = 0;
    for (int pass = 0; pass < nqkv; ++pass) {  // qkv atom i: q of the heads, then k, then v
      WSrc s{&p.tm_qkv, 0, 3, 0, 0, 0, 0, C / kBK};
      const int i0 = 3 * pass;
      s.c0 = (i0 / nh) * C + (head0 + i0 % nh) * kDK;
      s.c1 = ((i0 + 1) / nh) * C + (head0 + (i0 + 1) % nh) * kDK;
      s.c2 = ((i0 + 2) / nh) * C + (head0 + (i0 + 2) % nh) * kDK;
      passes[k++] = s;
    }
    passes[k++] = WSrc{&p.tm_proj, 0, nh, ch0, ch0 + kDK, 0, 0, C / kBK};
    for (int c0 = 0; c0 < nhid; c0 += kSlabCols) {
      const int n = nhid - c0 < kSlabCols ? nhid - c0 : kSlabCols;
      passes[k++] = WSrc{&p.tm_fc1, 0, n / kDK, hid0 + c0, hid0 + c0 + 32, hid0 + c0 + 64,
                         hid0 + c0 + 96, C / kBK};
    }
    for (int t = 0; t < p.cluster; ++t) {
      const int o = (rank + t) % p.cluster, c0 = p.head0[o] * kDK;
      passes[k++] = WSrc{&p.tm_fc2, hid0, p.nheads[o], c0, c0 + kDK, 0, 0, nhid / kBK};
    }
  }
  q.npasses = npasses;
  for (int m = tid; m < kN; m += kThreadsH)
    src_row[m] = static_cast<int>(map_row(p.map, static_cast<long>(w) * kN + m, 0, p.geo));
  __syncthreads();

  // ---- LN1(x'), with the first slabs in flight ----------------------------------
  if (q.producer) issue_to(q, q.stages - 2);
  const auto window_row = [&](int m) { return m; };
  layernorm_rows<C>(
      [&](int m, int ch) {
        return __ldg(reinterpret_cast<const uint4*>(x + static_cast<long>(src_row[m]) * C) + ch);
      },
      p.g1, p.b1, p.eps, A);
  fence_proxy_async();
  __syncthreads();

  // ---- q | k | v of the own heads, passes of 96 columns ------------------------
  const float scale_t = round_t<bf16>(p.scale);
  for (int pass = 0; pass < nh; ++pass) {
    float acc[48];
    product<96>(acc, a_s, C / kBK, q);
    // every bias value first (the stores below would order the loads after them)
    float2 bv[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int i = 3 * pass + (j >> 2);
      bv[j] = bias2(p.bqkv, (i / nh) * C + (head0 + i % nh) * kDK + 8 * (j & 3) + 2 * (lane & 3));
    }
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int i = 3 * pass + (j >> 2), which = i / nh, g = i % nh;
      const int d = 8 * (j & 3) + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row(h);
        if (r >= kN) continue;
        float v0 = round_t<bf16>(acc[4 * j + 2 * h] + bv[j].x);
        float v1 = round_t<bf16>(acc[4 * j + 2 * h + 1] + bv[j].y);
        if (which == 0) {  // q scaled in the storage type
          v0 = round_t<bf16>(v0 * scale_t);
          v1 = round_t<bf16>(v1 * scale_t);
        }
        *reinterpret_cast<__nv_bfloat162*>(U + g * kHeadBytes + which * kN * 64 + row64(r, j & 3) +
                                           (d & 7) * 2) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();

  // ---- attention of the own heads (9 row tiles a head, a warp a tile) -----------
  const float* mask_w =
      p.mask == nullptr ? nullptr : p.mask + static_cast<long>(w % p.num_windows) * kN * kN;
  for (int t = warp; t < 9 * nh; t += kThreadsH / 32) {
    const int g = t / 9;
    attention_rows(u_s + g * kHeadBytes, p.bias + static_cast<long>(head0 + g) * kN * kN, mask_w,
                   t % 9, attn + ch0 + g * kDK, C);
  }

  // ---- proj: x1 = x' + attn @ Wproj + b for the own channels --------------------
  cluster_sync_all();  // every CTA's attention columns are in L2
  gather_rows<C>(attn, window_row, A);
  fence_proxy_async();
  __syncthreads();
  // the residual rows of x' and the bias first, then x1 (its stores would
  // order the loads after them)
  auto proj_out = [&](auto& acc, auto n_tag) {
    constexpr int NN = decltype(n_tag)::value;
    float2 bv[NN / 8];
    __nv_bfloat162 res[NN / 8][2];
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) {
      const int c = ch0 + 8 * j + 2 * (lane & 3);
      bv[j] = bias2(p.bproj, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row(h);
        if (r < kN)
          res[j][h] = __ldg(reinterpret_cast<const __nv_bfloat162*>(
              x + static_cast<long>(src_row[r]) * C + c));
      }
    }
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) {
      const int c = ch0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row(h);
        if (r >= kN) continue;
        const float v0 = round_t<bf16>(acc[4 * j + 2 * h] + bv[j].x);
        const float v1 = round_t<bf16>(acc[4 * j + 2 * h + 1] + bv[j].y);
        *reinterpret_cast<__nv_bfloat162*>(x1g + static_cast<long>(r) * C + c) =
            __floats2bfloat162_rn(__bfloat162float(res[j][h].x) + s1 * v0,
                                  __bfloat162float(res[j][h].y) + s1 * v1);
      }
    }
  };
  if (nh == 2) {
    float acc[32];
    product<64>(acc, a_s, C / kBK, q);
    proj_out(acc, std::integral_constant<int, 64>());
  } else {
    float acc[16];
    product<32>(acc, a_s, C / kBK, q);
    proj_out(acc, std::integral_constant<int, 32>());
  }

  // ---- LN2(x1) -------------------------------------------------------------------------
  cluster_sync_all();  // every CTA's x1 columns are in L2
  gather_rows<C>(x1g, window_row, A);
  __syncthreads();
  layernorm_rows<C>(
      [&](int m, int ch) { return *reinterpret_cast<const uint4*>(A + a_chunk(m, ch)); }, p.g2,
      p.b2, p.eps, A);
  fence_proxy_async();
  __syncthreads();

  // ---- fc1 over the hidden slice: GELU rounded into the union region ---------------
  auto fc1_out = [&](auto& acc, int c0, auto n_tag) {
    constexpr int NN = decltype(n_tag)::value;
    float2 bv[NN / 8];  // every bias value first
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) bv[j] = bias2(p.bfc1, hid0 + c0 + 8 * j + 2 * (lane & 3));
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) {
      const int cl = c0 + 8 * j + 2 * (lane & 3);  // column of the slice
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row(h);
        if (r >= kN) continue;
        const float v0 = round_t<bf16>(acc[4 * j + 2 * h] + bv[j].x);
        const float v1 = round_t<bf16>(acc[4 * j + 2 * h + 1] + bv[j].y);
        *reinterpret_cast<__nv_bfloat162*>(U + a_chunk(r, cl >> 3) + (cl & 7) * 2) =
            __floats2bfloat162_rn(gelu_exact(v0), gelu_exact(v1));
      }
    }
  };
  for (int c0 = 0; c0 < nhid; c0 += kSlabCols) {
    const int n = nhid - c0 < kSlabCols ? nhid - c0 : kSlabCols;
    if (n == 128) {
      float acc[64];
      product<128>(acc, a_s, C / kBK, q);
      fc1_out(acc, c0, std::integral_constant<int, 128>());
    } else if (n == 96) {
      float acc[48];
      product<96>(acc, a_s, C / kBK, q);
      fc1_out(acc, c0, std::integral_constant<int, 96>());
    } else if (n == 64) {
      float acc[32];
      product<64>(acc, a_s, C / kBK, q);
      fc1_out(acc, c0, std::integral_constant<int, 64>());
    } else {
      float acc[16];
      product<32>(acc, a_s, C / kBK, q);
      fc1_out(acc, c0, std::integral_constant<int, 32>());
    }
  }
  fence_proxy_async();
  __syncthreads();  // the hidden slice is whole; A is free for the partial sums

  // ---- fc2, K split over the cluster: a reduce-scatter in cluster rounds ------------
  // In round t rank r forms, over its hidden slice, the partial product of the
  // channels of rank o = (r + t) % cluster and stores it into o's shared memory
  // (distributed shared memory, receive buffer t % nbuf). After the round's
  // barrier every rank adds what it received: its own partial first, then
  // those of ranks r - 1, r - 2, ... (mod cluster), the same order at every
  // launch. The barrier is split: the next round's product runs while it
  // completes.
  const int recv_bytes = p.recv_bytes;
  float own[8][2][2];  // the sums of the own channels (j < cw / 8)
#pragma unroll
  for (int j = 0; j < 8; ++j) own[j][0][0] = own[j][0][1] = own[j][1][0] = own[j][1][1] = 0.f;
  // round t's product for rank (rank + t) % cluster, stored into its buffer
  auto fc2_round = [&](int t) {
    const int o = (rank + t) % p.cluster;
    float4* dst = cluster.map_shared_rank(
        reinterpret_cast<float4*>(A + (t % p.nbuf) * recv_bytes), o);
    const auto store = [&](auto& acc, auto n_tag) {  // 16 bytes a store: a thread's 4 values of column block j
      constexpr int NN = decltype(n_tag)::value;
      if (tid < kRealThreads) {
#pragma unroll
        for (int j = 0; j < NN / 8; ++j)
          dst[j * kRealThreads + tid] =
              make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
    };
    if (p.nheads[o] == 2) {
      float acc[32];
      product<64>(acc, u_s, nhid / kBK, q);
      store(acc, std::integral_constant<int, 64>());
    } else {
      float acc[16];
      product<32>(acc, u_s, nhid / kBK, q);
      store(acc, std::integral_constant<int, 32>());
    }
  };
  const auto receive = [&](int t) {
    if (tid >= kRealThreads) return;
    const float4* got = reinterpret_cast<const float4*>(A + (t % p.nbuf) * recv_bytes);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= cw / 8) continue;
      const float4 v = got[j * kRealThreads + tid];
      own[j][0][0] += v.x;
      own[j][0][1] += v.y;
      own[j][1][0] += v.z;
      own[j][1][1] += v.w;
    }
  };
  fc2_round(0);
  cluster_arrive();
  for (int t = 0; t < p.cluster; ++t) {
    cluster_wait();  // round t's partial sums are in every rank's buffer
    receive(t);
    if (t + 1 < p.cluster) {
      if (p.nbuf == 1) cluster_sync_all();  // the buffer is read: round t + 1 may refill it
      fc2_round(t + 1);
      cluster_arrive();
    }
  }

  // ---- out = x1 + fc2 + b for the own channels ----------------------------------
  if (tid < kRealThreads) {
    float2 bv[8];  // the bias and x1 first, then out
    __nv_bfloat162 res[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= cw / 8) continue;
      const int c = ch0 + 8 * j + 2 * (lane & 3);
      bv[j] = bias2(p.bfc2, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row(h);
        if (r < kN)
          res[j][h] = *reinterpret_cast<const __nv_bfloat162*>(x1g + static_cast<long>(r) * C + c);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= cw / 8) continue;
      const int c = ch0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row(h);
        if (r >= kN) continue;
        const float v0 = round_t<bf16>(own[j][h][0] + bv[j].x);
        const float v1 = round_t<bf16>(own[j][h][1] + bv[j].y);
        *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<long>(w) * kN + r) * C + c) =
            __floats2bfloat162_rn(__bfloat162float(res[j][h].x) + s2 * v0,
                                  __bfloat162float(res[j][h].y) + s2 * v1);
      }
    }
  }
  // every store into this CTA's shared memory came before the last barrier:
  // it may leave
}

// ===========================================================================
// fp32 on the CUDA cores (the first port's design)
// ===========================================================================

constexpr int kR = 48;         // query rows of a CTA
constexpr int kTiles = kN / kR;
constexpr int kThreadsF = 192;
constexpr int kWarpsF = kThreadsF / 32;
constexpr int kBN = 96;        // columns of a product tile
constexpr int kKS = 96;        // K slab of LN1(x') staged at a time
constexpr int kSlabRowsF = 16; // rows of a W slab
// shared-memory strides (floats), chosen against bank conflicts
constexpr int kPadF = 4, kLDB = kBN, kLDQ = 97, kLDAS = kKS + 4, kLDS = kN + 1, kLDH = kBN + 4;
constexpr int kFixedF = 1024 + kSlabRowsF * kLDB * 4;  // row statistics, sums, source rows; a W slab

template <int NT>
constexpr int smem_f32() {
  constexpr int lda = 96 * NT + kPadF;
  constexpr int att = kR * lda * 4;
  // the staged slab of LN1(x') and the scores are never live together
  constexpr int slab = kR * kLDAS * 4, sc = kR * kLDS * 4;
  constexpr int phase1 = kN * kLDQ * 4 + (slab > sc ? slab : sc);
  constexpr int phase2 = kR * lda * 4 + kR * kLDH * 4;
  return kFixedF + att + (phase1 > phase2 ? phase1 : phase2);
}

// Column of W that column n of a 96-wide product tile reads: contiguous
// (seg = 32) or the q, k and v blocks of one head (seg = C).
struct WCols {
  int n0, seg;
  __device__ __forceinline__ int operator()(int n) const {
    return n0 + (n >> 5) * seg + (n & 31);
  }
};

// Thread (ty = tid / 16, tx = tid % 16) holds rows ty + 12 i, columns
// tx + 16 j of a 48 x 96 product tile.
struct AccF {
  float v[4][6];
};

__device__ __forceinline__ void acc_zero(AccF& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) a.v[i][j] = 0.f;
}

// acc += A (48 x K, shared memory, row stride lda) @ W[0:K, cols] where W
// rows have stride ldw in device memory; the W slabs go through Bs. Every
// thread of the CTA calls it; it starts with a barrier (so what the caller
// wrote to A is visible) and ends without one.
__device__ __forceinline__ void gemm_acc(AccF& acc, const float* A, int lda, const float* w,
                                         int ldw, WCols cols, int K, float* Bs) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += kSlabRowsF) {
    __syncthreads();
    for (int e = tid; e < kSlabRowsF * (kBN / 4); e += kThreadsF) {
      const int kk = e / (kBN / 4), n = (e % (kBN / 4)) * 4;
      *reinterpret_cast<float4*>(Bs + kk * kLDB + n) =
          *reinterpret_cast<const float4*>(w + (long)(k0 + kk) * ldw + cols(n));
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kSlabRowsF; ++kk) {
      float a[4], b[6];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(long)(ty + 12 * i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < 6; ++j) b[j] = Bs[kk * kLDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc.v[i][j] = fmaf(a[i], b[j], acc.v[i][j]);
    }
  }
}

// f(row, column, value) for every element of the tile.
template <typename F>
__device__ __forceinline__ void gemm_epilogue(AccF& acc, F f) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) f(ty + 12 * i, tx + 16 * j, acc.v[i][j]);
}

template <int NT>
__global__ void __cluster_dims__(kTiles, 1, 1) __launch_bounds__(kThreadsF, 1)
    swin_block_f32_kernel(const __grid_constant__ BlockArgs p) {
  constexpr int C = 96 * NT, LDA = C + kPadF;
  extern __shared__ __align__(128) unsigned char smem[];
  float* mean1 = reinterpret_cast<float*>(smem);       // LN1 statistics of the tile's rows
  float* rstd1 = mean1 + kR;
  float* sums = rstd1 + kR;                            // kR row sums of exp
  int* src_row = reinterpret_cast<int*>(sums + kR);    // the tile's kR source rows of x
  float* Bs = reinterpret_cast<float*>(smem + 1024);
  float* att = reinterpret_cast<float*>(smem + kFixedF);  // kR x LDA: attention, then LN2(x1)
  unsigned char* u = smem + kFixedF + kR * LDA * 4;
  // while the heads run
  float* qkv = reinterpret_cast<float*>(u);            // kN x kLDQ: q | k | v of one head
  float* As = qkv + kN * kLDQ;                         // kR x kLDAS slab of LN1(x'), or
  float* S = As;                                       // kR x kLDS scores (never both)
  // after them, over the same bytes
  float* x1 = reinterpret_cast<float*>(u);             // kR x LDA
  float* hc = x1 + kR * LDA;                           // kR x kLDH hidden chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cg::cluster_group cluster = cg::this_cluster();     // the window's kTiles CTAs
  const int tile = (int)cluster.block_rank();
  const int w = blockIdx.x / kTiles, row0 = tile * kR;
  const float* x = static_cast<const float*>(p.x);
  float* out = static_cast<float*>(p.out);
  const float* wqkv = static_cast<const float*>(p.wqkv);
  const float* wproj = static_cast<const float*>(p.wproj);
  const float* wfc1 = static_cast<const float*>(p.wfc1);
  const float* wfc2 = static_cast<const float*>(p.wfc2);
  const float s1 = p.m1 == nullptr ? 1.0f : p.m1[w / p.windows_per_image];
  const float s2 = p.m2 == nullptr ? 1.0f : p.m2[w / p.windows_per_image];
  float* x2 = static_cast<float*>(p.x2);

  for (int m = tid; m < kR; m += kThreadsF)
    src_row[m] = (int)map_row(p.map, (long)w * kN + row0 + m, 0, p.geo);
  __syncthreads();

  // LN1 statistics of the tile's rows (two passes)
  for (int m = warp; m < kR; m += kWarpsF) {
    const float* row = x + (long)src_row[m] * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
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
  const float* mask_w =
      p.mask == nullptr ? nullptr : p.mask + (long)(w % p.num_windows) * kN * kN;
  for (int h = 0; h < p.heads; ++h) {
    {
      // q, k and v of the tile's own rows
      AccF acc;
      acc_zero(acc);
      const WCols cols{h * kDK, C};
      for (int k0 = 0; k0 < C; k0 += kKS) {
        __syncthreads();  // the slab before has been multiplied
        for (int e = tid; e < kR * (kKS / 4); e += kThreadsF) {
          const int m = e / (kKS / 4), kc = (e % (kKS / 4)) * 4;
          float4 raw = *reinterpret_cast<const float4*>(x + (long)src_row[m] * C + k0 + kc);
          float* hv = reinterpret_cast<float*>(&raw);
          const float mean = mean1[m], rstd = rstd1[m];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hv[j] = (hv[j] - mean) * rstd * p.g1[k0 + kc + j] + p.b1[k0 + kc + j];
          *reinterpret_cast<float4*>(As + m * kLDAS + kc) = raw;
        }
        gemm_acc(acc, As, kLDAS, wqkv + (long)k0 * 3 * C, 3 * C, cols, kKS, Bs);
      }
      gemm_epilogue(acc, [&](int r, int n, float v) {
        v = v + bias_at(p.bqkv, cols(n));
        if (n < kDK) v = v * p.scale;
        qkv[(row0 + r) * kLDQ + n] = v;
      });
    }
    // k and v of the window's other rows, from the shared memory of the CTAs
    // that computed them
    cluster.sync();
    for (int e = tid; e < (kTiles - 1) * kR * 2 * kDK; e += kThreadsF) {
      const int peer = (tile + 1 + e / (kR * 2 * kDK)) % kTiles;
      const int r = (e / (2 * kDK)) % kR, c = kDK + e % (2 * kDK);
      const int at = (peer * kR + r) * kLDQ + c;
      qkv[at] = cluster.map_shared_rank(qkv, peer)[at];
    }
    cluster.sync();  // every CTA has its copy: the rows may be overwritten
    // raw scores of the tile's rows against the window's keys
    for (int idx = tid; idx < kR * kN; idx += kThreadsF) {
      const int r = idx / kN, j = idx % kN;
      const float* qr = qkv + (row0 + r) * kLDQ;
      const float* kr = qkv + j * kLDQ + kDK;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kDK; ++d) s = fmaf(qr[d], kr[d], s);
      S[r * kLDS + j] = s;
    }
    __syncthreads();
    // + bias + mask: the tile's 48 rows of either are one contiguous run
    {
      const float* brun = p.bias + ((long)h * kN + row0) * kN;
      const float* mrun = mask_w == nullptr ? nullptr : mask_w + (long)row0 * kN;
#pragma unroll 6
      for (int idx = tid; idx < kR * kN; idx += kThreadsF) {
        const int r = idx / kN, j = idx - r * kN;
        float sv = S[r * kLDS + j] + __ldg(brun + idx);
        if (mrun != nullptr) sv += __ldg(mrun + idx);
        S[r * kLDS + j] = sv;
      }
    }
    __syncthreads();
    // softmax pieces: a warp a row, its lanes across the keys
    for (int r = warp; r < kR; r += kWarpsF) {
      float sv[(kN + 31) / 32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < (kN + 31) / 32; ++t) {
        const int j = lane + 32 * t;
        sv[t] = j < kN ? S[r * kLDS + j] : -CUDART_INF_F;
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
          S[r * kLDS + j] = e;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) sums[r] = sum;
    }
    __syncthreads();
    // (P . v) / row sum into the tile's attention buffer
    for (int idx = tid; idx < kR * kDK; idx += kThreadsF) {
      const int r = idx / kDK, c = idx % kDK;
      const float* pr = S + r * kLDS;
      const float* v = qkv + 2 * kDK + c;
      float o = 0.f;
      for (int j = 0; j < kN; ++j) o = fmaf(pr[j], v[j * kLDQ], o);
      att[r * LDA + h * kDK + c] = o * (1.0f / sums[r]);
    }
  }

  // ---- proj + residual: x1 --------------------------------------------------
#pragma unroll 1
  for (int nt = 0; nt < NT; ++nt) {
    AccF acc;
    acc_zero(acc);
    gemm_acc(acc, att, LDA, wproj, C, WCols{nt * kBN, 32}, C, Bs);
    gemm_epilogue(acc, [&](int r, int n, float v) {
      const int c = nt * kBN + n;
      v = v + bias_at(p.bproj, c);
      const float mid = x[(long)src_row[r] * C + c] + s1 * v;
      x1[r * LDA + c] = mid;
      if (x2 != nullptr) x2[((long)w * kN + row0 + r) * C + c] = mid;
    });
  }
  __syncthreads();

  // ---- LN2(x1) over the attention buffer --------------------------------------
  for (int r = warp; r < kR; r += kWarpsF) {
    const float* row = x1 + r * LDA;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = 1.0f / sqrtf(warp_sum(q) / C + p.eps);
    for (int c = lane; c < C; c += 32) att[r * LDA + c] = (row[c] - mean) * rstd * p.g2[c] + p.b2[c];
  }

  // ---- MLP: hidden chunks of 96, fc2 accumulated in registers -----------------
  AccF acc2[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc_zero(acc2[nt]);
#pragma unroll 1
  for (int ch = 0; ch < p.hidden / kBN; ++ch) {
    {
      AccF acc1;
      acc_zero(acc1);
      gemm_acc(acc1, att, LDA, wfc1, p.hidden, WCols{ch * kBN, 32}, C, Bs);
      gemm_epilogue(acc1, [&](int r, int n, float v) {
        hc[r * kLDH + n] = gelu_exact(v + bias_at(p.bfc1, ch * kBN + n));
      });
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      gemm_acc(acc2[nt], hc, kLDH, wfc2 + (long)ch * kBN * C, C, WCols{nt * kBN, 32}, kBN, Bs);
  }

  // ---- out = x1 + fc2 + b ---------------------------------------------------------
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    gemm_epilogue(acc2[nt], [&](int r, int n, float v) {
      const int c = nt * kBN + n;
      v = v + bias_at(p.bfc2, c);
      out[((long)w * kN + row0 + r) * C + c] = x1[r * LDA + c] + s2 * v;
    });
}

// ===========================================================================
// launchers
// ===========================================================================

// The plan as ops/block_plan.py lays it out (BlockPlan.as_ints).
enum PlanField { kPlanCluster = 0, kPlanWindows, kPlanStages, kPlanBuffers, kPlanUnion, kPlanShared,
                 kPlanRanks };

template <int NT>
cudaError_t launch_f32(BlockArgs p, const int* plan, cudaStream_t s) {
  constexpr int smem = smem_f32<NT>();
  if (plan[kPlanCluster] != kTiles || plan[kPlanWindows] != 1 || plan[kPlanShared] != smem)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      swin_block_f32_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  swin_block_f32_kernel<NT><<<p.bw * kTiles, kThreadsF, smem, s>>>(p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime once (no link to the
// driver library)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
static EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a (rows, cols) row-major bf16 weight: boxes of kBK rows x 32
// columns (64 bytes, the 64-byte swizzle's width).
static bool weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {32, kBK}, elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks the plan against the shapes (the plan decides; the launcher only
// refuses what the kernel cannot do) and launches the cluster grid.
template <int C>
cudaError_t launch_bf16(BlockArgs p, const int* plan, cudaStream_t s) {
  const int cs = plan[kPlanCluster];
  if (cs < 1 || cs > kMaxCluster || plan[kPlanWindows] != 1 || plan[kPlanStages] < 2 ||
      plan[kPlanStages] > kMaxStages || plan[kPlanBuffers] < 1 || plan[kPlanBuffers] > 2)
    return cudaErrorInvalidValue;
  const int* head0 = plan + kPlanRanks;
  const int* nheads = head0 + kMaxCluster;
  const int* hid0 = nheads + kMaxCluster;
  const int* nhid = hid0 + kMaxCluster;
  int next_head = 0, next_hid = 0, u_bytes = 0, max_heads = 0;
  for (int r = 0; r < cs; ++r) {
    // heads and hidden slices partition the block in rank order; a CTA holds
    // one or two heads and a hidden slice of 32-column blocks
    if (head0[r] != next_head || nheads[r] < 1 || nheads[r] > 2 || hid0[r] != next_hid ||
        nhid[r] < kDK || nhid[r] % kDK != 0)
      return cudaErrorInvalidValue;
    next_head += nheads[r];
    next_hid += nhid[r];
    // the hidden slice is an A operand: K blocks of 64 columns
    const int hid_bytes = (nhid[r] + 63) / 64 * kKBlock;
    const int need = nheads[r] * kHeadBytes > hid_bytes ? nheads[r] * kHeadBytes : hid_bytes;
    if (nheads[r] + 1 + (nhid[r] + kSlabCols - 1) / kSlabCols + cs > kMaxPasses)
      return cudaErrorInvalidValue;
    u_bytes = need > u_bytes ? need : u_bytes;
    max_heads = nheads[r] > max_heads ? nheads[r] : max_heads;
    p.head0[r] = head0[r];
    p.nheads[r] = nheads[r];
    p.hid0[r] = hid0[r];
    p.nhid[r] = nhid[r];
  }
  // fc2's receive buffers (one round's partial sums of the widest owner) sit
  // in the A operand's bytes, which fc2 no longer reads
  const int recv_bytes = max_heads * kDK * kRecvBytesPerChannel;
  const int smem = block_smem(C, u_bytes, plan[kPlanStages]);
  if (next_head != p.heads || next_hid != p.hidden || plan[kPlanUnion] != u_bytes ||
      plan[kPlanShared] != smem || smem > kMaxShared || p.attn == nullptr ||
      plan[kPlanBuffers] * recv_bytes > kN * C * 2)
    return cudaErrorInvalidValue;
  p.recv_bytes = recv_bytes;
  if (!weight_map(&p.tm_qkv, p.wqkv, C, 3 * C) || !weight_map(&p.tm_proj, p.wproj, C, C) ||
      !weight_map(&p.tm_fc1, p.wfc1, C, p.hidden) || !weight_map(&p.tm_fc2, p.wfc2, p.hidden, C))
    return cudaErrorInvalidValue;
  p.cluster = cs;
  p.stages = plan[kPlanStages];
  p.nbuf = plan[kPlanBuffers];
  p.u_bytes = u_bytes;
  // the kernel's ceiling on dynamic shared memory, raised once to all a CTA
  // may hold (each launch asks for its own plan's bytes)
  static const cudaError_t attr = cudaFuncSetAttribute(
      swin_block_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.bw * cs));
  cfg.blockDim = dim3(kThreadsH);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, swin_block_wgmma_kernel<C>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, out (bw, 144, c); LayerNorm parameters and biases fp32; weights (in, out)
// in the storage type; bias (heads, 144, 144) fp32; mask (num_windows, 144,
// 144) fp32 or null. transition != 0 reads x through the window transition of
// a res grid with delta = (to_shift - from_shift) mod res. Built for windows
// of 144 tokens, heads of 32, c = 192 or 384 and hidden a multiple of 96.
// plan: ops/block_plan.py's BlockPlan.as_ints() (host memory); attn: (bw,
// 144, c) scratch in the storage type (bf16; unused in fp32).
static int block_dispatch(
    const void* x, const void* g1, const void* b1, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* g2, const void* b2,
    const void* wfc1, const void* bfc1, const void* wfc2, const void* bfc2,
    const void* bias, const void* mask, void* out, int bw, int n, int c, int heads,
    int hidden, int num_windows, float scale, float eps, int transition, int res,
    int window, int delta, const void* m1, const void* m2, void* x2,
    int windows_per_image, const int* plan, void* attn, int dtype, void* stream) {
  if (n != kN || c != heads * kDK || (c != 192 && c != 384) || hidden <= 0 ||
      hidden % 96 != 0 || bw <= 0 || num_windows <= 0 || plan == nullptr)
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
  p.attn = attn;
  if (transition) {
    if (window <= 0 || window * window != n || res % window != 0 ||
        bw % ((res / window) * (res / window)) != 0 || delta < 0 || delta >= res)
      return cudaErrorInvalidValue;
    p.map = kMapTransition;
    p.geo = Geometry{res, window, delta};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return c == 192 ? launch_f32<2>(p, plan, s) : launch_f32<4>(p, plan, s);
  if (dtype == kBFloat16)
    return c == 192 ? launch_bf16<192>(p, plan, s) : launch_bf16<384>(p, plan, s);
  return cudaErrorInvalidValue;
}

extern "C" int swin_block_launch(
    const void* x, const void* g1, const void* b1, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* g2, const void* b2,
    const void* wfc1, const void* bfc1, const void* wfc2, const void* bfc2,
    const void* bias, const void* mask, void* out, int bw, int n, int c, int heads,
    int hidden, int num_windows, float scale, float eps, int transition, int res,
    int window, int delta, const int* plan, void* attn, int dtype, void* stream) {
  return block_dispatch(x, g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2,
                        bias, mask, out, bw, n, c, heads, hidden, num_windows, scale, eps,
                        transition, res, window, delta, nullptr, nullptr, nullptr, 1, plan, attn,
                        dtype, stream);
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
    float scale, float eps, const int* plan, void* attn, int dtype, void* stream) {
  if (m1 == nullptr || m2 == nullptr || x2 == nullptr || windows_per_image <= 0 ||
      bw % windows_per_image != 0)
    return cudaErrorInvalidValue;
  return block_dispatch(x, g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2,
                        bias, mask, out, bw, n, c, heads, hidden, num_windows, scale, eps, 0,
                        0, 0, 0, m1, m2, x2, windows_per_image, plan, attn, dtype, stream);
}

// Clusters of `cluster` bf16 B6 CTAs (width c, `smem` bytes each) the card
// runs at once, as cudaOccupancyMaxActiveClusters reports it: what
// ops/block_plan.py's CLUSTER_SLOTS holds for a 132-SM H100.
extern "C" int swin_block_max_clusters(int c, int cluster, int smem, int* out) {
  if ((c != 192 && c != 384) || cluster < 1 || cluster > kMaxCluster || smem < 0 ||
      smem > kMaxShared || out == nullptr)
    return cudaErrorInvalidValue;
  const auto kernel = c == 192 ? swin_block_wgmma_kernel<192> : swin_block_wgmma_kernel<384>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(kThreadsH);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}
