// K1: Swin window-attention core on the flat qkv layout.
//
// Replaces on_device_image_captioning_tpu/ops/window_attention.py::
// window_attention_pallas and, on the same math, ops/swin_block_fused.py::
// attention_core_fused (B3); with the fused kernels' rounding it is the core
// of the attention half (B4, csrc/swin_attn_half.cu) and of its training form
// (B10a). For one window w and head h:
//   out[w, i, h*dk:(h+1)*dk] = softmax_j(q_i . k_j * scale + bias[h, i, j]
//                                        + mask[w % nW, i, j]) . v
// qkv is (BW, N, 3C) with columns [q | k | v] and per-head dk blocks inside
// each; bias is (H, N, N) fp32; mask is (nW, N, N) fp32 or null.
//
// Bound on the H100: bytes. A (window, head) moves 4 N dk itemsize bytes of
// q, k, v in and out against 4 N^2 dk flops, about 70 flop/byte in bf16:
// under the tensor cores' balance point (about 295), so mma.sync does not set
// the pace. The fp32 bias and mask are the larger stream: 82,944 bytes each
// a (window, head) at N = 144, against 36,864 of bf16 q, k, v and out. The
// function itself needs each once (34.1 MB in and out at stage 0, B = 2);
// reading them once a (window, head), as a CTA a (window, head) does, moves
// 127 MB through L2 at stage 0 B = 2 and at b8 stage 2 alike.
//
// The plan (ops/window_attention.py::attention_plan): the windows that share
// a mask row (w % nW; every window where there is no mask) form a group, and
// a CTA takes one group, a run of `heads_per_cta` heads and a share of the
// group's images (`splits` shares), heads outer. A CTA reads each of its
// heads' bias once and its mask row once and walks its (window, head)
// units; on the tensor cores the next unit's q, k and v are on their way
// (cp.async into a double buffer) while this one computes. One CTA an SM on
// both routes.
//
// bf16 windows of 144 tokens run on the tensor cores
// (window_attention_mma_kernel): nine warps, a warp a strip of 16 query rows.
// A warp forms its 16 x 144 scores with mma.sync m16n8k16 (K by ldmatrix
// from the 64-byte swizzled rows of shared memory) into fp32 accumulators:
// 18 column tiles, 72 registers a lane, which never leave the registers. Row
// max and sum are quad shuffles: the whole row of 144 is in the quad, so
// there is no online rescaling; exp is 2^x on the special-function unit with
// log2(e) folded into one FFMA. The probabilities are packed to bf16 A
// fragments in the accumulator layout and multiplied with V
// (ldmatrix.trans). The strip's 16 x 32 output goes back through the strip's
// own q rows in shared memory and out as 16-byte stores of whole rows.
// Shared memory holds the two q | k | v stages, the current head's bias +
// mask and the mask row (fp32, 152-float rows: the C fragments' float2 reads
// meet no bank twice), 225 KB; nothing of the scores. A warp reads only its
// own strip of bias and mask: it adds its mask rows into its bias strip once
// a head, and fetches the next head's bias strip itself as soon as it has
// added this one's, behind the rest of the unit. One barrier a unit: after
// it every warp is done with the unit before, whose stage then takes the
// next unit's copies. Registers: 168 a thread is the most nine warps take
// (three share a quarter of the SM's register file), so the bias, which
// would need 72 more, stays out of them. mma.sync, not wgmma: 144 rows are
// two warpgroup tiles of 64 and a third of which 48 rows would be padding,
// and wgmma's asynchrony pays only with a second unit's scores in flight,
// which the register cap leaves no room for.
//
// fp32, and bf16 windows of other sizes, run on the CUDA cores
// (window_attention_core_kernel, N <= 192): a quad of lanes takes two query
// rows, each lane every fourth key (keys 4t + lane % 4: the four lanes' K and
// V rows, 36 floats apart, fall in distinct banks and each float4 is a
// broadcast to the eight row pairs of a warp). One pass: a lane forms the
// scores of its keys for both rows once, q in registers and each float4 of K
// used for two rows, keeps them in registers through the softmax (max and sum
// over the quad), then sums p . V over its keys, each float4 of V used for
// two rows, and the quad's partial rows meet in a reduce-scatter of fixed
// order, each lane storing 8 of the 32 channels of both rows. bias[h] +
// mask[p] is summed once a head into shared memory (rows of N + 2 mod 16
// floats, conflict-free); q, k and v are converted to fp32 as they load.
// Products stay fp32 (no TF32). At 168 registers a thread (nine warps at
// N <= 144, twelve above) the instances spill a little: ptxas gives them
// stack frames of 24-48 bytes (N <= 144) and 96-128 (N <= 192), which
// ops/window_attention.py LOCAL_BYTES records. Taking q and the
// accumulators half the channels at a time cut K1's N <= 144 instances to
// 16 bytes but ran 4-25% longer and spilled 224-416 bytes above 144 tokens.
//
// Two roundings, chosen by the template flag FUSED: false is
// window_attention_pallas's (q scaled in fp32, probabilities normalized, then
// rounded to the qkv dtype before P.V), which K1 and B3 get; true is
// `_attention_rows`' (ops/swin_block_fused.py:383), which the attention half
// needs: the scale rounded to the qkv dtype and q scaled in that dtype,
// exp(s - max) rounded to the qkv dtype before the product with V, and the
// division by the fp32 sum after it, as a product with 1 / sum as in
// `_attention_rows`. On both roundings and routes exp(x) is 2^(x log2 e) on
// the special-function unit, its result flushed to 0 below 2^-126 (a masked
// score's e^-100, which rounds to 0 in bf16 anyway), where the JAX kernels
// and the backward (csrc/swin_attn_bwd.cu, B9b) take expf; and without
// FUSED p is normalized by a product with 1 / sum where jax.nn.softmax
// divides. Each is a few fp32 ulps off before p's rounding: expf on the
// fused rounding cost the attention half (B4) 2-4% on the H100, and B9b's
// recomputed scores already differ from the forward's in the order of
// their fp32 sums. Both routes add bias + mask, summed once a head, to the
// score, where the JAX kernels add the bias, then the mask: the same
// wherever the mask is 0, and where it is -100 the score's e is 0 in both.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

// Swin-L has dk = 32 at every stage; the only head width built and tested.
constexpr int kHeadDim = 32;
constexpr int kWindowTokens = 144;  // the window the tensor-core kernel is built for

// ---- the plan ---------------------------------------------------------------
struct AttnArgs {
  const void* qkv;
  const float* bias;
  const float* mask;  // null: no mask, every window in one group
  void* out;
  int bw, n, c, heads;
  int groups;         // nW with a mask, else 1
  int heads_per_cta;  // heads a CTA takes, consecutive
  int splits;         // shares of a group's images
  float scale;
};

// The units CTA `cta` takes: group p, heads [h0, h1), images [b0, b1) of the
// group (window p + groups * b), heads outer. The CTA order is group fastest,
// then head run, then share (ops/window_attention.py::AttentionPlan.units_of).
struct AttnUnits {
  int p, h0, h1, b0, nb;
  __device__ int count() const { return (h1 - h0) * nb; }
  __device__ int head(int u) const { return h0 + u / nb; }
};

__device__ __forceinline__ AttnUnits attn_units(const AttnArgs& a, int cta) {
  AttnUnits r;
  r.p = cta % a.groups;
  const int rest = cta / a.groups;
  const int runs = (a.heads + a.heads_per_cta - 1) / a.heads_per_cta;
  const int run = rest % runs, share = rest / runs;
  r.h0 = run * a.heads_per_cta;
  r.h1 = min(a.heads, r.h0 + a.heads_per_cta);
  const int images = a.bw / a.groups;
  r.b0 = static_cast<int>(static_cast<long>(share) * images / a.splits);
  r.nb = static_cast<int>(static_cast<long>(share + 1) * images / a.splits) - r.b0;
  return r;
}

__device__ __forceinline__ void attn_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void attn_cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- bf16, N = 144, on the tensor cores ------------------------------------
constexpr int kMmaThreads = 32 * (kWindowTokens / 16);  // a warp a strip of 16 query rows
constexpr int kAttnRowBytes = kHeadDim * 2;             // a row of q, k or v (64-byte swizzle)
constexpr int kAttnMatBytes = kWindowTokens * kAttnRowBytes;
constexpr int kAttnStageBytes = 3 * kAttnMatBytes;  // q | k | v of one unit
constexpr int kMaskLd = kWindowTokens + 8;          // fp32 row stride of bias and mask
constexpr int kAttnMaskBytes = kWindowTokens * kMaskLd * 4;
// two stages, the bias of the current head, + alignment slack; + the mask row
constexpr int kMmaSmemPlain = 2 * kAttnStageBytes + kAttnMaskBytes + 128;
constexpr int kMmaSmemMasked = kMmaSmemPlain + kAttnMaskBytes;
static_assert(kMmaSmemMasked <= 232448, "a CTA's shared memory");

constexpr float kLog2e = 1.4426950408889634f;
// 2^x on the special-function unit (flushing a subnormal result to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the pair of bf16 in v, each scaled by s in fp32 and rounded back
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * s, f.y * s);
}

template <bool FUSED>
__global__ void __launch_bounds__(kMmaThreads, 1) window_attention_mma_kernel(AttnArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int N = kWindowTokens, DK = kHeadDim, NT = N / 8, KT = N / 16;
  static_assert(DK == 32, "two 16-deep steps of q . k, four 8-wide column tiles of a head");
  // the window of shared memory starts aligned (no static shared memory)
  extern __shared__ __align__(128) uint8_t attn_raw[];
  uint8_t* base = attn_raw;
  float* bias_s = reinterpret_cast<float*>(base + 2 * kAttnStageBytes);
  const float* mask_s = bias_s + kWindowTokens * kMaskLd;
  const uint32_t stages = smem_u32(base);

  const AttnUnits units = attn_units(a, blockIdx.x);
  const int count = units.count();
  if (count <= 0) return;
  const int tid = threadIdx.x, lane = tid & 31, i0 = 16 * (tid >> 5);
  const int r0 = lane >> 2, cq = 2 * (lane & 3);
  const int c3 = 3 * a.c;
  const T* qkv = static_cast<const T*>(a.qkv);
  T* out = static_cast<T*>(a.out);
  const float scale_t = round_t<T>(a.scale);
  auto window = [&](int u) { return units.p + a.groups * (units.b0 + u % units.nb); };

  // unit u's q, k and v into stage st: 3 x 144 rows of four 16-byte chunks
  auto fetch = [&](int u, int st) {
    const T* src = qkv + static_cast<long>(window(u)) * N * c3 + units.head(u) * DK;
    const uint32_t dst = stages + st * kAttnStageBytes;
#pragma unroll
    for (int k = 0; k < 3 * N * 4 / kMmaThreads; ++k) {
      const int idx = tid + k * kMmaThreads;
      const int part = idx / (N * 4), j = (idx / 4) % N, ch = idx & 3;
      cp_async16(dst + part * kAttnMatBytes + row64(j, ch), src + j * c3 + part * a.c + ch * 8,
                 true);
    }
  };
  // the warp's 16 rows of head h's bias, by its own lanes (no other warp
  // reads them): lane l copies 16-byte chunks l and 32 + l of each row
  auto fetch_bias = [&](int h) {
    const float* src = a.bias + (static_cast<long>(h) * N + i0) * N + 4 * lane;
    const uint32_t dst = stages + 2 * kAttnStageBytes + (i0 * kMaskLd + 4 * lane) * 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      cp_async16(dst + j * kMaskLd * 4, src + j * N, true);
      if (lane < N / 4 - 32) cp_async16(dst + (j * kMaskLd + 128) * 4, src + j * N + 128, true);
    }
  };
  if (a.mask != nullptr) {  // the group's mask row, with the first unit
    const float* src = a.mask + static_cast<long>(units.p) * N * N;
    const uint32_t dst = stages + 2 * kAttnStageBytes + kAttnMaskBytes;
    for (int idx = tid; idx < N * (N / 4); idx += kMmaThreads) {
      const int j = idx / (N / 4), ch = idx % (N / 4);
      cp_async16(dst + (j * kMaskLd + 4 * ch) * 4, src + j * N + 4 * ch, true);
    }
  }
  fetch_bias(units.head(0));
  fetch(0, 0);
  attn_cp_commit();

  int bm_head = -1;
  for (int u = 0; u < count; ++u) {
    const int st = u & 1, h = units.head(u);
    attn_cp_wait_all();  // unit u's copies, its head's bias (and the mask row) have landed
    // every copy seen by every warp, and every warp done with unit u - 1: its
    // stage takes unit u + 1
    __syncthreads();
    if (u + 1 < count) {
      fetch(u + 1, st ^ 1);
      attn_cp_commit();
    }
    if (a.mask != nullptr && h != bm_head) {  // the warp's bias strip += its mask rows, once a head
      float* b = bias_s + i0 * kMaskLd;
      const float* m = mask_s + i0 * kMaskLd;
#pragma unroll 4
      for (int idx = lane; idx < 16 * (N / 4); idx += 32) {
        const int at = (idx / (N / 4)) * kMaskLd + 4 * (idx % (N / 4));
        float4 v = *reinterpret_cast<const float4*>(b + at);
        const float4 w = *reinterpret_cast<const float4*>(m + at);
        v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
        *reinterpret_cast<float4*>(b + at) = v;
      }
      __syncwarp();
      bm_head = h;
    }
    // this unit's stage; a lane's ldmatrix rows of a tile of K (8 rows) and of
    // V (16 rows) keep their swizzle from tile to tile, so a tile is a
    // constant offset from the lane's first
    const uint32_t Qs = stages + st * kAttnStageBytes, Ks = Qs + kAttnMatBytes,
                   Vs = Ks + kAttnMatBytes;
    const uint32_t k_lane = Ks + row64(lane & 7, lane >> 3);

    // the strip's scores, 16 x 144 in registers
    float s[NT][4];
    {
      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ldsm_x4(qa[kk], Qs + row64(i0 + (lane & 15), 2 * kk + (lane >> 4)));
        if (FUSED) {  // q scaled in the storage type, by the scale rounded to it
#pragma unroll
          for (int r = 0; r < 4; ++r) qa[kk][r] = scale_bf16x2(qa[kk][r], scale_t);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t kb[4];
        ldsm_x4(kb, k_lane + 8 * kAttnRowBytes * nt);
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        mma16816(s[nt], qa[0], kb[0], kb[1]);
        mma16816(s[nt], qa[1], kb[2], kb[3]);
      }
    }
    // + (bias + mask), the row max over the quad
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b0 = *reinterpret_cast<const float2*>(bias_s + (i0 + r0) * kMaskLd + 8 * nt + cq);
      const float2 b1 =
          *reinterpret_cast<const float2*>(bias_s + (i0 + r0 + 8) * kMaskLd + 8 * nt + cq);
      const float b[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = FUSED ? s[nt][e] + b[e] : fmaf(s[nt][e], a.scale, b[e]);
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the next unit's head's bias over this one's, as soon as the warp has read it
    if (u + 1 < count && units.head(u + 1) != h) {
      __syncwarp();
      fetch_bias(units.head(u + 1));
      attn_cp_commit();
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // e = exp(s - max) = 2^(s log2 e - max log2 e)
    const float m0 = mx0 * kLog2e, m1 = mx1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = ex2(fmaf(s[nt][0], kLog2e, -m0)); s[nt][1] = ex2(fmaf(s[nt][1], kLog2e, -m0));
      s[nt][2] = ex2(fmaf(s[nt][2], kLog2e, -m1)); s[nt][3] = ex2(fmaf(s[nt][3], kLog2e, -m1));
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    const float inv0 = __frcp_rn(sum0), inv1 = __frcp_rn(sum1);
    // P . V: p normalized before its rounding (FUSED false) or e rounded as it is
    float o[4][4] = {};
    const uint32_t v_lane[2] = {Vs + row64(lane & 15, lane >> 4), Vs + row64(lane & 15, 2 + (lane >> 4))};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float(&e)[4] = s[2 * kk + half];
        pa[2 * half] = FUSED ? pack_bf16(e[0], e[1]) : pack_bf16(e[0] * inv0, e[1] * inv0);
        pa[2 * half + 1] = FUSED ? pack_bf16(e[2], e[3]) : pack_bf16(e[2] * inv1, e[3] * inv1);
      }
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, v_lane[dp] + 16 * kAttnRowBytes * kk);
        mma16816(o[2 * dp], pa, vb[0], vb[1]);
        mma16816(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    // the strip's output through its own q rows, then out in whole 64-byte rows
    const float f0 = FUSED ? inv0 : 1.f, f1 = FUSED ? inv1 : 1.f;  // division after the product
    uint8_t* strip = base + st * kAttnStageBytes;
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      *reinterpret_cast<uint32_t*>(strip + row64(i0 + r0, dt) + 2 * cq) =
          pack_bf16(o[dt][0] * f0, o[dt][1] * f0);
      *reinterpret_cast<uint32_t*>(strip + row64(i0 + r0 + 8, dt) + 2 * cq) =
          pack_bf16(o[dt][2] * f1, o[dt][3] * f1);
    }
    __syncwarp();
    {
      T* dst = out + (static_cast<long>(window(u)) * N + i0) * a.c + static_cast<long>(h) * DK;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 8 * half + (lane >> 2), ch = lane & 3;
        *reinterpret_cast<uint4*>(dst + static_cast<long>(r) * a.c + 8 * ch) =
            *reinterpret_cast<const uint4*>(strip + row64(i0 + r, ch));
      }
    }
  }
}

// ---- fp32, and bf16 of other window sizes, on the CUDA cores --------------
constexpr int kCoreLd = kHeadDim + 4;  // fp32 row stride of K and V in shared memory
constexpr int kCoreMaxTokens = 192;

// fp32 row stride of bias + mask in shared memory: 2 mod 16, so that the
// eight row pairs and four keys of a warp's read meet 32 distinct banks
__host__ __device__ constexpr int core_bm_ld(int n) { return n + ((18 - n % 16) % 16); }
__host__ __device__ constexpr int core_threads(int n) { return ((4 * ((n + 1) / 2)) + 31) / 32 * 32; }
__host__ __device__ constexpr int core_smem(int n) {
  return (2 * n * kCoreLd + n * core_bm_ld(n)) * 4;
}
static_assert(core_smem(kCoreMaxTokens) <= 232448, "a CTA's shared memory");

// 8 values of T at p as fp32
__device__ __forceinline__ void load8f(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8f(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8f(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8f(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  raw.x = pack_bf16(v[0], v[1]); raw.y = pack_bf16(v[2], v[3]);
  raw.z = pack_bf16(v[4], v[5]); raw.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// KT: the most keys a lane takes (N <= 4 KT)
template <typename T, bool FUSED, int KT>
__global__ void __launch_bounds__(8 * KT, 1) window_attention_core_kernel(AttnArgs a) {
  constexpr int DK = kHeadDim;
  extern __shared__ float core_smem_f[];
  const int n = a.n, ldb = core_bm_ld(n);
  float* Ks = core_smem_f;       // n x kCoreLd
  float* Vs = Ks + n * kCoreLd;  // n x kCoreLd
  float* Bm = Vs + n * kCoreLd;  // n x ldb: bias[h] + mask[p]

  const AttnUnits units = attn_units(a, blockIdx.x);
  const int count = units.count();
  if (count <= 0) return;
  const int tid = threadIdx.x, kq = tid & 3, rp = tid >> 2;
  const int ia = min(2 * rp, n - 1), ib = min(2 * rp + 1, n - 1);  // reads of a row past n: row n - 1
  const long c3 = 3L * a.c;
  const T* qkv = static_cast<const T*>(a.qkv);
  const float qs = FUSED ? round_t<T>(a.scale) : a.scale;

  int bm_head = -1;
  for (int u = 0; u < count; ++u) {
    const int h = units.head(u);
    const long row0 = static_cast<long>(units.p + a.groups * (units.b0 + u % units.nb)) * n;
    const T* base = qkv + row0 * c3 + static_cast<long>(h) * DK;
    // q of the lane's two rows, scaled: in fp32 (FUSED false), or by the
    // rounded scale and rounded to T (FUSED true)
    float q[2][DK];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int ch = 0; ch < DK / 8; ++ch) {
        float v[8];
        load8f(base + (r ? ib : ia) * c3 + 8 * ch, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) q[r][8 * ch + e] = FUSED ? round_t<T>(v[e] * qs) : v[e] * qs;
      }
    __syncthreads();  // the last unit is done with K, V and bias + mask
    if (h != bm_head) {
      const float* bh = a.bias + static_cast<long>(h) * n * n;
      const float* mp = a.mask == nullptr ? nullptr : a.mask + static_cast<long>(units.p) * n * n;
      for (int idx = tid; idx < n * n; idx += blockDim.x)
        Bm[(idx / n) * ldb + idx % n] = mp == nullptr ? __ldg(bh + idx) : __ldg(bh + idx) + __ldg(mp + idx);
      bm_head = h;
    }
    for (int idx = tid; idx < n * (DK / 8); idx += blockDim.x) {
      const int j = idx / (DK / 8), ch = idx % (DK / 8);
      float v[8];
      load8f(base + j * c3 + a.c + 8 * ch, v);
      store8f(Ks + j * kCoreLd + 8 * ch, v);
      load8f(base + j * c3 + 2L * a.c + 8 * ch, v);
      store8f(Vs + j * kCoreLd + 8 * ch, v);
    }
    __syncthreads();

    // the scores of the lane's keys 4t + kq for both rows, formed once
    float s[2][KT];
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int j = 4 * t + kq;
      if (j < n) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int d = 0; d < DK; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(Ks + j * kCoreLd + d);
          s0 = fmaf(q[0][d], k4.x, s0); s0 = fmaf(q[0][d + 1], k4.y, s0);
          s0 = fmaf(q[0][d + 2], k4.z, s0); s0 = fmaf(q[0][d + 3], k4.w, s0);
          s1 = fmaf(q[1][d], k4.x, s1); s1 = fmaf(q[1][d + 1], k4.y, s1);
          s1 = fmaf(q[1][d + 2], k4.z, s1); s1 = fmaf(q[1][d + 3], k4.w, s1);
        }
        s[0][t] = s0 + Bm[ia * ldb + j];
        s[1][t] = s1 + Bm[ib * ldb + j];
        mx0 = fmaxf(mx0, s[0][t]);
        mx1 = fmaxf(mx1, s[1][t]);
      } else {
        s[0][t] = s[1][t] = -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float m0 = mx0 * kLog2e, m1 = mx1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      s[0][t] = ex2(fmaf(s[0][t], kLog2e, -m0));  // 0 for a key past n
      s[1][t] = ex2(fmaf(s[1][t], kLog2e, -m1));
      sum0 += s[0][t];
      sum1 += s[1][t];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;

    // p . V over the lane's keys: p normalized, then rounded (FUSED false),
    // or e rounded as it is (FUSED true)
    float acc[2][DK];
#pragma unroll
    for (int d = 0; d < DK; ++d) acc[0][d] = acc[1][d] = 0.f;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int j = 4 * t + kq;
      if (j < n) {
        const float p0 = round_t<T>(FUSED ? s[0][t] : s[0][t] * inv0);
        const float p1 = round_t<T>(FUSED ? s[1][t] : s[1][t] * inv1);
#pragma unroll
        for (int d = 0; d < DK; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(Vs + j * kCoreLd + d);
          acc[0][d] = fmaf(p0, v4.x, acc[0][d]); acc[0][d + 1] = fmaf(p0, v4.y, acc[0][d + 1]);
          acc[0][d + 2] = fmaf(p0, v4.z, acc[0][d + 2]); acc[0][d + 3] = fmaf(p0, v4.w, acc[0][d + 3]);
          acc[1][d] = fmaf(p1, v4.x, acc[1][d]); acc[1][d + 1] = fmaf(p1, v4.y, acc[1][d + 1]);
          acc[1][d + 2] = fmaf(p1, v4.z, acc[1][d + 2]); acc[1][d + 3] = fmaf(p1, v4.w, acc[1][d + 3]);
        }
      }
    }
    // the quad's partial rows summed in a fixed order, scattered: lane kq
    // ends with channels [8 kq, 8 kq + 8) of both rows, ((kq, kq ^ 2), (kq ^ 1, kq ^ 3))
    float half[2][DK / 2];
    const bool upper = kq & 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int d = 0; d < DK / 2; ++d) {
        const float keep = upper ? acc[r][DK / 2 + d] : acc[r][d];
        const float give = upper ? acc[r][d] : acc[r][DK / 2 + d];
        half[r][d] = keep + __shfl_xor_sync(0xffffffffu, give, 2);
      }
    float mine[2][8];
    const bool odd = kq & 1;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const float keep = odd ? half[r][8 + d] : half[r][d];
        const float give = odd ? half[r][d] : half[r][8 + d];
        mine[r][d] = keep + __shfl_xor_sync(0xffffffffu, give, 1);
      }
    T* o = static_cast<T*>(a.out) + row0 * a.c + static_cast<long>(h) * DK + 8 * kq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * rp + r;
      if (row < n) {
        const float f = FUSED ? (r ? inv1 : inv0) : 1.f;  // division after the product
#pragma unroll
        for (int d = 0; d < 8; ++d) mine[r][d] *= f;
        store8f(o + static_cast<long>(row) * a.c, mine[r]);
      }
    }
  }
}

template <typename T, bool FUSED, int KT>
static cudaError_t launch_attention_core(const AttnArgs& a, int ctas, cudaStream_t s) {
  const int smem = core_smem(a.n);
  cudaError_t err = cudaFuncSetAttribute(window_attention_core_kernel<T, FUSED, KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  window_attention_core_kernel<T, FUSED, KT><<<ctas, core_threads(a.n), smem, s>>>(a);
  return cudaGetLastError();
}

template <bool FUSED>
static cudaError_t launch_attention_mma(const AttnArgs& a, int ctas, cudaStream_t s) {
  const int smem = a.mask == nullptr ? kMmaSmemPlain : kMmaSmemMasked;
  cudaError_t err = cudaFuncSetAttribute(window_attention_mma_kernel<FUSED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  window_attention_mma_kernel<FUSED><<<ctas, kMmaThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Registers and local memory (spilled registers) a thread of instance
// `which` of the rounding FUSED, as the loaded module has them: 0 the
// tensor-core kernel, 1 and 2 the CUDA-core kernel's fp32 instances for
// N <= 144 and N <= 192, 3 and 4 its bf16 ones (ops/window_attention.py::
// INSTANCES).
template <bool FUSED>
static int attention_attributes(int which, int* registers, int* local_bytes) {
  const void* fns[] = {
      reinterpret_cast<const void*>(window_attention_mma_kernel<FUSED>),
      reinterpret_cast<const void*>(window_attention_core_kernel<float, FUSED, kWindowTokens / 4>),
      reinterpret_cast<const void*>(window_attention_core_kernel<float, FUSED, kCoreMaxTokens / 4>),
      reinterpret_cast<const void*>(
          window_attention_core_kernel<__nv_bfloat16, FUSED, kWindowTokens / 4>),
      reinterpret_cast<const void*>(
          window_attention_core_kernel<__nv_bfloat16, FUSED, kCoreMaxTokens / 4>),
  };
  if (which < 0 || which >= static_cast<int>(sizeof(fns) / sizeof(fns[0])))
    return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// qkv (BW, N, 3C) -> out (BW, N, C) on `stream`; dtype is a DType code;
// heads_per_cta and splits are the plan's (attention_plan). bf16 windows of
// 144 tokens go to the tensor cores, everything else to the CUDA cores.
template <bool FUSED>
static cudaError_t launch_window_attention(const void* qkv, const void* bias,
                                           const void* mask, void* out, int bw,
                                           int n, int c, int heads,
                                           int num_windows, float scale,
                                           int heads_per_cta, int splits,
                                           int dtype, cudaStream_t s) {
  AttnArgs a;
  a.qkv = qkv; a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask); a.out = out;
  a.bw = bw; a.n = n; a.c = c; a.heads = heads; a.scale = scale;
  a.groups = mask == nullptr ? 1 : num_windows;
  a.heads_per_cta = heads_per_cta; a.splits = splits;
  if (heads * kHeadDim != c || n < 1 || n > kCoreMaxTokens || a.groups < 1 ||
      bw % a.groups != 0 || heads_per_cta < 1 || splits < 1)
    return cudaErrorInvalidValue;
  if (bw == 0) return cudaSuccess;
  if (splits > bw / a.groups) return cudaErrorInvalidValue;
  const int ctas = a.groups * ((heads + heads_per_cta - 1) / heads_per_cta) * splits;
  if (dtype == kBFloat16 && n == kWindowTokens) return launch_attention_mma<FUSED>(a, ctas, s);
  if (dtype == kFloat32)
    return n <= kWindowTokens ? launch_attention_core<float, FUSED, kWindowTokens / 4>(a, ctas, s)
                              : launch_attention_core<float, FUSED, kCoreMaxTokens / 4>(a, ctas, s);
  if (dtype == kBFloat16)
    return n <= kWindowTokens
               ? launch_attention_core<__nv_bfloat16, FUSED, kWindowTokens / 4>(a, ctas, s)
               : launch_attention_core<__nv_bfloat16, FUSED, kCoreMaxTokens / 4>(a, ctas, s);
  return cudaErrorInvalidValue;
}
