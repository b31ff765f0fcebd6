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
// the port's own (fused_linear.cuh: the forward product for qkv, the backward
// product on wgmma in the tile forms and splits of the launch plan,
// ops/linear_plan.py::grad_plan; and the core below, which follows the
// forward's core in window_attention.cuh rounding for rounding), and every
// sum over the rows or windows (dbias, the weight, bias and LayerNorm
// gradients) a fixed-order sum of partials: two launches agree bit for bit.
//
// Bound on the H100: operations, 22 C^2 flops a row of products with the
// weights (qkv recomputed 6, dao 2, dWproj 2, dWqkv 6, dxn1 6) plus 12 N C of
// attention (the scores, formed once, 2; the forward rows e . v 2; dp, dq,
// dk, dv 8) against 6 C bytes of x, dx2 and dx in bf16.
//
// Nine launches:
//   1. xn1   = round(LN1(x)); dproj = round(dx2 * m1[image]),
//      dbproj partials                                         rows_prep
//   2. qkv   = round(xn1 @ Wqkv + b)                           forward product
//   3. dao   = round(dproj @ Wproj^T)                          dY @ W^T
//   4. core, a CTA per (chunk of windows, head), the chunk's windows in
//      order: the scores and exp(s - max) formed once; from them the
//      forward attention rows attn = (e . v) * inv and p = e * inv; dp =
//      dao . v^T, ds = p * (dp - sum(dp * p)), the chunk's dbias partial +=
//      ds; dq = (ds . k) * scale, dk = ds^T . q, dv = p^T . dao, stored
//      rounded (dqkv), their fp32 column sums into the chunk's dbqkv partial
//   5. dWproj = attn^T @ dproj   fp32 partials by chunk of rows X^T @ dY
//   6. dWqkv = xn1^T @ dqkv      fp32 partials by chunk of rows X^T @ dY
//   7. dxn1 = dqkv @ Wqkv^T (fp32)                             dY @ W^T
//   8. dx = round(dx2 + LN1 backward(dxn1)), dg1, dbe1 partials ln_bwd
//   9. the weight, bias, LayerNorm and dbias gradients = the partials
//      summed in order                                         sum_partials
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

// The core of the backward for a chunk of windows and one head on the CUDA
// cores, in both types (products of the stored values in fp32), the chunk's
// windows in order: the two N x N matrices (p, then round(p); dp, then
// round(ds)) and k, v sit in shared memory as fp32, 205 KB at N = 144; q and
// dao rows are read from device memory (L1). The warp that takes a row's
// softmax also forms that row of the forward attention output, a lane per
// column of the head. Element (i, j) of ds is always the same thread's, so
// it adds it into the chunk's dbias partial in window order; thread (r, d)
// of dq, dk, dv keeps d = its lane, so its column sums meet over the warps in
// order.
template <typename T>
__global__ void __launch_bounds__(kCoreThreads) attn_bwd_core_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao, const float* __restrict__ bias,
    const float* __restrict__ mask, T* __restrict__ attn, T* __restrict__ dqkv,
    float* __restrict__ dbias_part, float* __restrict__ dbqkv_part, int bw, int n, int c,
    int num_windows, int chunk, float scale) {
  static_assert(kDK == 32, "a lane per column of the head");
  extern __shared__ float smem[];
  __shared__ float red[kCoreThreads / 32][3 * kDK];
  const int lds = n + 1;
  float* S = smem;                // n x lds: scores, p, round(p)
  float* D = S + n * lds;         // n x lds: dp, round(ds)
  float* ks = D + n * lds;        // n x (kDK + 1)
  float* vs = ks + n * (kDK + 1);
  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long c3 = 3L * c;
  const float scale_t = round_t<T>(scale);
  const int wbeg = blockIdx.x * chunk, wend = min(bw, wbeg + chunk);
  float* dpart = dbias_part + (static_cast<long>(blockIdx.x) * gridDim.y + h) * n * n;
  const float* bias_h = bias + (long)h * n * n;
  float col_acc = 0.f;  // thread t < 3 kDK: column t of [dq | dk | dv], the chunk's sum

  for (int w = wbeg; w < wend; ++w) {
    const bool first = w == wbeg;
    const long row0 = (long)w * n;
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
      const float inv = 1.0f / sum;
      attn[(row0 + i) * c + (long)h * kDK + lane] = from_f<T>(av * inv);
      __syncwarp();  // every lane has read the row's e
      float dot = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = srow[j] * inv;
        srow[j] = p;
        dot = fmaf(drow[j], p, dot);
      }
      dot = row_warp_sum(dot);
      for (int j = lane; j < n; j += 32) {
        const float p = srow[j];
        const float ds = p * (drow[j] - dot);
        float* part = dpart + (long)i * n + j;
        *part = first ? ds : *part + ds;
        srow[j] = round_t<T>(p);
        drow[j] = round_t<T>(ds);
      }
    }
    __syncthreads();

    // dq, dk, dv: thread (row, d) of each, lanes across d (d = lane: 288 is
    // a multiple of 32), stored rounded and summed over the thread's rows
    float sq = 0.f, sk = 0.f, sv = 0.f;
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
      dqkv[at] = from_f<T>(dq);
      dqkv[at + c] = from_f<T>(dk);
      dqkv[at + 2L * c] = from_f<T>(dv);
      sq += dq;
      sk += dk;
      sv += dv;
    }
    red[warp][lane] = sq;
    red[warp][kDK + lane] = sk;
    red[warp][2 * kDK + lane] = sv;
    __syncthreads();
    if (tid < 3 * kDK) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kCoreThreads / 32; ++k) s += red[k][tid];
      col_acc = first ? s : col_acc + s;
    }
    __syncthreads();  // before the next window takes shared memory
  }
  if (tid < 3 * kDK)
    dbqkv_part[static_cast<long>(blockIdx.x) * c3 + (tid / kDK) * c + h * kDK + tid % kDK] =
        col_acc;
}

// The same core for bf16 windows of 144 tokens on the tensor cores (mma.sync
// m16n8k16, fp32 accumulators in registers): one CTA per (chunk of windows,
// head), the chunk's windows in order. A warp owns 16 query
// rows and, later, 16 key rows. Shared memory holds round(q * scale) and dao
// for the whole window, and one region that holds k and v while the warps
// form their rows, then round(p) and round(ds) (bf16, 144 x 152) for the
// products over all query rows (107 KB), and the chunk's dbias, which each
// lane adds its own elements of ds into, window after window (88 KB), then
// written out once (a chunk of one window writes its ds out directly). One
// CTA an SM: at two, 107 KB each without the dbias accumulator, the
// registers (96 a thread) spill and the core ran slower on the H100. Per
// window:
//   1. q, k, v, dao in (64-byte rows, 64-byte swizzle).
//   2. A warp's 16 query rows, in registers: the scores s = q k^T + bias +
//      mask; max; e = exp(s - max), the forward output (round(e) . v) *
//      (1 / sum) to attn; p = e * (1 / sum) (a division's IEEE slow path
//      takes the masked scores' subnormal e, the core's largest cost on the
//      H100); dot = sum(dp * p) with dp = dao v^T formed a
//      column tile at a time; ds = p * (dp - dot) (dp formed again), added
//      into the chunk's dbias in shared memory (each element always this
//      lane's, so the windows add in order); dq = round(ds) . k.
//   3. round(p), round(ds) to the region k and v held; dq stored rounded,
//      its columns summed over the warp's rows in a fixed shuffle order.
//   4. A warp's 16 key rows: dk = round(ds)^T . round(q * scale), dv =
//      round(p)^T . dao (the transposes are ldmatrix.trans), stored rounded
//      and summed the same way; the nine warps' column sums meet in shared
//      memory in warp order, added over the chunk's windows in order.
constexpr int kCoreLdp = kWindowTokens + 8;  // bf16 row stride of round(p) and round(ds)
constexpr int kCoreRowBytes = kHeadDim * 2;  // a row of q, k, v or dao
constexpr size_t kCoreRegion = 2 * (size_t)kWindowTokens * kCoreLdp * 2;  // p and ds
constexpr int kCoreLdb = kWindowTokens + 8;  // fp32 row stride of the dbias accumulator
constexpr size_t kCoreMmaSmem = 2 * (size_t)kWindowTokens * kCoreRowBytes + kCoreRegion +
                                (kCoreThreads / 32) * 3 * kHeadDim * sizeof(float) +
                                (size_t)kWindowTokens * kCoreLdb * sizeof(float) + 128;
static_assert(kCoreMmaSmem <= 232448, "a CTA's shared memory");
static_assert(2 * (size_t)kWindowTokens * kCoreRowBytes <= kCoreRegion, "k and v fit the region");

__global__ void __launch_bounds__(kCoreThreads, 1) attn_bwd_core_mma_kernel(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dao,
    const float* __restrict__ bias, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ attn, __nv_bfloat16* __restrict__ dqkv,
    float* __restrict__ dbias_part, float* __restrict__ dbqkv_part, int bw, int c,
    int num_windows, int chunk, float scale) {
  typedef __nv_bfloat16 T;
  constexpr int N = kWindowTokens, NT = N / 8, KT = N / 16, LDP = kCoreLdp * 2;  // LDP: bytes
  static_assert(kCoreThreads == 32 * KT, "one warp per strip of 16 rows");
  static_assert(kDK == 32, "two 16-wide k steps, four 8-wide column tiles of a head");
  extern __shared__ uint8_t core_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(core_raw) + 127) & ~static_cast<uintptr_t>(127));
  uint8_t* Qb = base;                          // round(q * scale)
  uint8_t* Gb = Qb + N * kCoreRowBytes;        // dao
  uint8_t* Rb = Gb + N * kCoreRowBytes;        // k | v, then round(p) | round(ds)
  float(*red)[3 * kDK] = reinterpret_cast<float(*)[3 * kDK]>(Rb + kCoreRegion);
  float* dacc = &red[kCoreThreads / 32][0];  // the chunk's dbias, N x kCoreLdb
  const uint32_t Qs = smem_u32(Qb), Gs = smem_u32(Gb), Ks = smem_u32(Rb);
  const uint32_t Vs = Ks + N * kCoreRowBytes, Ps = Ks, Ds = Ks + N * LDP;

  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, wt = tid >> 5;
  const long c3 = 3L * c;
  const float scale_t = round_t<T>(scale);
  const int wbeg = blockIdx.x * chunk, wend = min(bw, wbeg + chunk);
  const bool single = wend - wbeg == 1;
  float* dpart = dbias_part + (static_cast<long>(blockIdx.x) * gridDim.y + h) * N * N;
  const float* bias_h = bias + static_cast<long>(h) * N * N;
  const int i0 = 16 * wt, r0 = lane >> 2, cq = 2 * (lane & 3);
  float col_acc = 0.f;  // thread t < 3 kDK: column t of [dq | dk | dv], the chunk's sum

  // the column sums of a 16 x 32 result tile (acc[dt] in the C layout) over
  // the warp's 16 rows, into red[warp][at + column]: the two rows a lane
  // holds, then the eight lanes of a column in butterfly order
  auto col_sums = [&](const float (&acc)[4][4], int at) {
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      float a = acc[dt][0] + acc[dt][2], b = acc[dt][1] + acc[dt][3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane < 4) {
        red[wt][at + 8 * dt + cq] = a;
        red[wt][at + 8 * dt + cq + 1] = b;
      }
    }
  };
  // a 16 x 32 result tile rounded into dqkv: rows row0 + 16 strip on, part's columns of the head
  auto store_tile = [&](const float (&acc)[4][4], long row, int part) {
    T* dst = dqkv + row * c3 + part * c + static_cast<long>(h) * kDK;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * c3 + 8 * dt + cq) =
          __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + 8) * c3 + 8 * dt + cq) =
          __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
    }
  };

  for (int w = wbeg; w < wend; ++w) {
    const bool first = w == wbeg;
    const long row0 = static_cast<long>(w) * N;
    // 1. q (scaled and rounded), k, v, dao of the window
    for (int idx = tid; idx < N * (kDK / 8); idx += kCoreThreads) {
      const int j = idx / (kDK / 8), ch = idx % (kDK / 8);
      const T* src = qkv + (row0 + j) * c3 + static_cast<long>(h) * kDK + ch * 8;
      uint4 qraw = *reinterpret_cast<const uint4*>(src);
      T* q8 = reinterpret_cast<T*>(&qraw);
#pragma unroll
      for (int e = 0; e < 8; ++e) q8[e] = __float2bfloat16(__bfloat162float(q8[e]) * scale_t);
      const int at = row64(j, ch);
      *reinterpret_cast<uint4*>(Qb + at) = qraw;
      *reinterpret_cast<uint4*>(Rb + at) = *reinterpret_cast<const uint4*>(src + c);
      *reinterpret_cast<uint4*>(Rb + N * kCoreRowBytes + at) =
          *reinterpret_cast<const uint4*>(src + 2L * c);
      *reinterpret_cast<uint4*>(Gb + at) = *reinterpret_cast<const uint4*>(
          dao + (row0 + j) * c + static_cast<long>(h) * kDK + ch * 8);
    }
    __syncthreads();

    // 2. the warp's query rows: scores, softmax, the forward output
    const float* mask_w = mask == nullptr ? nullptr : mask + (long)(w % num_windows) * N * N;
    uint32_t ga[2][4];  // dao rows (A of dp)
    float s[NT][4];
    {
      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ldsm_x4(qa[kk], Qs + row64(i0 + (lane & 15), 2 * kk + (lane >> 4)));
        ldsm_x4(ga[kk], Gs + row64(i0 + (lane & 15), 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + row64(8 * nt + (lane & 7), lane >> 3));
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        mma16816(s[nt], qa[0], kb[0], kb[1]);
        mma16816(s[nt], qa[1], kb[2], kb[3]);
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + cq;
      const float2 b0 = __ldg(reinterpret_cast<const float2*>(bias_h + (i0 + r0) * N + col));
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias_h + (i0 + r0 + 8) * N + col));
      s[nt][0] += b0.x; s[nt][1] += b0.y; s[nt][2] += b1.x; s[nt][3] += b1.y;
      if (mask_w != nullptr) {
        const float2 m0 = __ldg(reinterpret_cast<const float2*>(mask_w + (i0 + r0) * N + col));
        const float2 m1 = __ldg(reinterpret_cast<const float2*>(mask_w + (i0 + r0 + 8) * N + col));
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
    float sum0 = 0.f, sum1 = 0.f, inv0, inv1;
    {
      float o_acc[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float(&e)[4] = s[2 * kk + half];
          e[0] = expf(e[0] - mx0); e[1] = expf(e[1] - mx0);
          e[2] = expf(e[2] - mx1); e[3] = expf(e[3] - mx1);
          sum0 += e[0] + e[1];
          sum1 += e[2] + e[3];
          a[2 * half] = pack_bf16(e[0], e[1]);
          a[2 * half + 1] = pack_bf16(e[2], e[3]);
        }
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, Vs + row64(16 * kk + (lane & 15), 2 * dp + (lane >> 4)));
          mma16816(o_acc[2 * dp], a, vb[0], vb[1]);
          mma16816(o_acc[2 * dp + 1], a, vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      inv0 = 1.0f / sum0;
      inv1 = 1.0f / sum1;
      T* orow = attn + (row0 + i0 + r0) * c + static_cast<long>(h) * kDK;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * dt + cq) =
            __floats2bfloat162_rn(o_acc[dt][0] * inv0, o_acc[dt][1] * inv0);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8L * c + 8 * dt + cq) =
            __floats2bfloat162_rn(o_acc[dt][2] * inv1, o_acc[dt][3] * inv1);
      }
    }
    // p = e * (1 / sum), and dot = sum(dp * p) over the row, dp a column tile at a time
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] *= inv0; s[nt][1] *= inv0; s[nt][2] *= inv1; s[nt][3] *= inv1;
      uint32_t vb[4];
      ldsm_x4(vb, Vs + row64(8 * nt + (lane & 7), lane >> 3));
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(dp, ga[0], vb[0], vb[1]);
      mma16816(dp, ga[1], vb[2], vb[3]);
      dot0 = fmaf(dp[0], s[nt][0], dot0); dot0 = fmaf(dp[1], s[nt][1], dot0);
      dot1 = fmaf(dp[2], s[nt][2], dot1); dot1 = fmaf(dp[3], s[nt][3], dot1);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, o);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, o);
    }
    // ds = p (dp - dot) into the chunk's dbias; round(p), round(ds) packed
    uint32_t pp[NT][2], dsp[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t vb[4];
      ldsm_x4(vb, Vs + row64(8 * nt + (lane & 7), lane >> 3));
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(dp, ga[0], vb[0], vb[1]);
      mma16816(dp, ga[1], vb[2], vb[3]);
      const float ds0 = s[nt][0] * (dp[0] - dot0), ds1 = s[nt][1] * (dp[1] - dot0);
      const float ds2 = s[nt][2] * (dp[2] - dot1), ds3 = s[nt][3] * (dp[3] - dot1);
      if (single) {  // a chunk of one window: its ds is the partial
        *reinterpret_cast<float2*>(dpart + (i0 + r0) * N + 8 * nt + cq) = make_float2(ds0, ds1);
        *reinterpret_cast<float2*>(dpart + (i0 + r0 + 8) * N + 8 * nt + cq) =
            make_float2(ds2, ds3);
      } else if (first) {
        float2* d0 = reinterpret_cast<float2*>(dacc + (i0 + r0) * kCoreLdb + 8 * nt + cq);
        float2* d1 = reinterpret_cast<float2*>(dacc + (i0 + r0 + 8) * kCoreLdb + 8 * nt + cq);
        *d0 = make_float2(ds0, ds1);
        *d1 = make_float2(ds2, ds3);
      } else {
        float2* d0 = reinterpret_cast<float2*>(dacc + (i0 + r0) * kCoreLdb + 8 * nt + cq);
        float2* d1 = reinterpret_cast<float2*>(dacc + (i0 + r0 + 8) * kCoreLdb + 8 * nt + cq);
        const float2 a0 = *d0, a1 = *d1;
        *d0 = make_float2(a0.x + ds0, a0.y + ds1);
        *d1 = make_float2(a1.x + ds2, a1.y + ds3);
      }
      pp[nt][0] = pack_bf16(s[nt][0], s[nt][1]);
      pp[nt][1] = pack_bf16(s[nt][2], s[nt][3]);
      dsp[nt][0] = pack_bf16(ds0, ds1);
      dsp[nt][1] = pack_bf16(ds2, ds3);
    }
    // dq = round(ds) . k, scaled after the product
    float dq[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const uint32_t a[4] = {dsp[2 * kk][0], dsp[2 * kk][1], dsp[2 * kk + 1][0],
                             dsp[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t kb[4];
        ldsm_x4_t(kb, Ks + row64(16 * kk + (lane & 15), 2 * dp + (lane >> 4)));
        mma16816(dq[2 * dp], a, kb[0], kb[1]);
        mma16816(dq[2 * dp + 1], a, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < 4; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[dt][e] *= scale;
    __syncthreads();  // every warp is done with k and v: round(p), round(ds) take their place

    // 3. round(p), round(ds) of the warp's rows; dq out
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int at = (i0 + r0) * LDP + (8 * nt + cq) * 2;
      *reinterpret_cast<uint32_t*>(Rb + at) = pp[nt][0];
      *reinterpret_cast<uint32_t*>(Rb + at + 8 * LDP) = pp[nt][1];
      *reinterpret_cast<uint32_t*>(Rb + N * LDP + at) = dsp[nt][0];
      *reinterpret_cast<uint32_t*>(Rb + N * LDP + at + 8 * LDP) = dsp[nt][1];
    }
    store_tile(dq, row0 + i0, 0);
    col_sums(dq, 0);
    __syncthreads();

    // 4. the warp's key rows j0 = i0 on: dk = round(ds)^T . q, dv = round(p)^T . dao
    {
      float dk[4][4] = {}, dv[4][4] = {};
      // the A fragment of rows j0 .. j0 + 15 of X^T (X = round(p) or round(ds),
      // row-major [query][key]) over queries 16 kk .. 16 kk + 15
      const int q8 = lane >> 3;
      const int arow = (q8 >> 1) * 8 + (lane & 7), acol = (i0 + 8 * (q8 & 1)) * 2;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t pa[4], da[4];
        const uint32_t at = (16 * kk + arow) * LDP + acol;
        ldsm_x4_t(pa, Ps + at);
        ldsm_x4_t(da, Ds + at);
        // ldmatrix.trans hands out the transposed 8 x 8 blocks in the order
        // (q0-7, k0-7), (q0-7, k8-15), (q8-15, k0-7), (q8-15, k8-15) of X;
        // as A of X^T: (k0-7, q0-7), (k8-15, q0-7), (k0-7, q8-15), (k8-15, q8-15)
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t gb[4], qb[4];
          ldsm_x4_t(gb, Gs + row64(16 * kk + (lane & 15), 2 * dp + (lane >> 4)));
          ldsm_x4_t(qb, Qs + row64(16 * kk + (lane & 15), 2 * dp + (lane >> 4)));
          mma16816(dv[2 * dp], pa, gb[0], gb[1]);
          mma16816(dv[2 * dp + 1], pa, gb[2], gb[3]);
          mma16816(dk[2 * dp], da, qb[0], qb[1]);
          mma16816(dk[2 * dp + 1], da, qb[2], qb[3]);
        }
      }
      store_tile(dk, row0 + i0, 1);
      store_tile(dv, row0 + i0, 2);
      col_sums(dk, kDK);
      col_sums(dv, 2 * kDK);
    }
    __syncthreads();  // the window's shared memory is free for the next one
    if (tid < 3 * kDK) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kCoreThreads / 32; ++k) sum += red[k][tid];
      col_acc = first ? sum : col_acc + sum;
    }
  }
  if (tid < 3 * kDK)
    dbqkv_part[static_cast<long>(blockIdx.x) * c3 + (tid / kDK) * c + h * kDK + tid % kDK] =
        col_acc;
  // the chunk's dbias (every element written above by its one lane) out
  if (single) return;
  for (int idx = tid; idx < N * (N / 4); idx += kCoreThreads) {
    const int i = idx / (N / 4), j4 = idx % (N / 4);
    reinterpret_cast<float4*>(dpart + i * N)[j4] =
        *reinterpret_cast<const float4*>(dacc + i * kCoreLdb + 4 * j4);
  }
}

// bf16 windows of 144 tokens go to the tensor-core kernel, everything else to
// the CUDA-core one; a CTA per (chunk of `chunk` windows, head).
template <typename T>
cudaError_t launch_core(const void* qkv, const void* dao, const float* bias,
                        const float* mask, void* attn, void* dqkv, float* dbias_part,
                        float* dbqkv_part, int bw, int n, int c, int heads, int num_windows,
                        int chunk, float scale, cudaStream_t s) {
  if (chunk < 1) return cudaErrorInvalidValue;
  dim3 grid((bw + chunk - 1) / chunk, heads);
  if (sizeof(T) == 2 && n == kWindowTokens) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_core_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kCoreMmaSmem);
    if (err != cudaSuccess) return err;
    attn_bwd_core_mma_kernel<<<grid, kCoreThreads, kCoreMmaSmem, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dao), bias,
        mask, static_cast<__nv_bfloat16*>(attn), static_cast<__nv_bfloat16*>(dqkv), dbias_part,
        dbqkv_part, bw, c, num_windows, chunk, scale);
    return cudaGetLastError();
  }
  const size_t smem = (2 * (size_t)n * (n + 1) + 2 * (size_t)n * (kDK + 1)) * sizeof(float);
  if (smem + sizeof(float) * (kCoreThreads / 32) * 3 * kDK > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_core_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_core_kernel<T><<<grid, kCoreThreads, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dao), bias, mask, static_cast<T*>(attn),
      static_cast<T*>(dqkv), dbias_part, dbqkv_part, bw, n, c, num_windows, chunk, scale);
  return cudaGetLastError();
}

// The launch plan's ints, in this order (ops/swin_block_fused.py::swin_attn_bwd)
enum AttnPlan {
  kQkvForm, kDaoForm, kDxn1Form, kProjWForm, kProjWChunk, kQkvWForm, kQkvWChunk, kCoreChunk,
  kAttnPlanLen
};

struct AttnBwdArgs {
  const void *x, *dx2, *wqkv, *wproj;
  const float *g1, *b1, *bqkv, *bias, *mask, *m1;
  void *xn1, *qkv, *attn, *dproj, *dao, *dqkv, *dx;
  float *dxn1;
  float *dwqkv_part, *dwproj_part, *dbqkv_part, *dbproj_part, *dg1_part, *dbe1_part, *dbias_part;
  float *dwqkv, *dbqkv, *dwproj, *dbproj, *dg1, *dbe1, *dbias;
  int bw, n, c, heads, num_windows, windows_per_image;
  const int* plan;
  float scale, eps;
};

template <typename T>
cudaError_t attn_bwd_typed(const AttnBwdArgs& p, cudaStream_t s) {
  const int rows = p.bw * p.n, c = p.c;
  const int* plan = p.plan;
  cudaError_t err = launch_rows_prep<T>(p.x, p.g1, p.b1, p.xn1, p.dx2, p.m1, p.dproj,
                                        p.dbproj_part, rows, c, p.windows_per_image * p.n,
                                        p.eps, s);
  if (err != cudaSuccess) return err;

  LinearArgs lin = {};
  lin.a = p.xn1; lin.w = p.wqkv; lin.bias = p.bqkv; lin.out = p.qkv;
  lin.M = rows; lin.N = 3 * c; lin.K = c;
  lin.a_map = kMapIdentity; lin.segs = 1; lin.eps = p.eps;
  if ((err = launch_linear_wide<T>(lin, plan[kQkvForm], s)) != cudaSuccess) return err;

  GemmArgs dao = input_grad_args(p.dproj, p.wproj, rows, c, c);
  dao.out_t = p.dao;
  if ((err = launch_grad<T>(dao, kDYWT, plan[kDaoForm], s)) != cudaSuccess) return err;

  if ((err = launch_core<T>(p.qkv, p.dao, p.bias, p.mask, p.attn, p.dqkv, p.dbias_part,
                            p.dbqkv_part, p.bw, p.n, c, p.heads, p.num_windows,
                            plan[kCoreChunk], p.scale, s)) != cudaSuccess)
    return err;
  GemmArgs dwp = weight_grad_args(p.attn, p.dproj, p.dwproj_part, rows, c, c, plan[kProjWChunk]);
  if ((err = launch_grad<T>(dwp, kATB, plan[kProjWForm], s)) != cudaSuccess) return err;
  GemmArgs dwq = weight_grad_args(p.xn1, p.dqkv, p.dwqkv_part, rows, c, 3 * c, plan[kQkvWChunk]);
  if ((err = launch_grad<T>(dwq, kATB, plan[kQkvWForm], s)) != cudaSuccess) return err;
  GemmArgs dxn = input_grad_args(p.dqkv, p.wqkv, rows, c, 3 * c);
  dxn.out_f = p.dxn1;
  if ((err = launch_grad<T>(dxn, kDYWT, plan[kDxn1Form], s)) != cudaSuccess) return err;
  if ((err = launch_ln_bwd<T>(p.x, p.dxn1, p.g1, p.dx2, p.dx, p.dg1_part, p.dbe1_part, rows, c,
                              p.eps, s)) != cudaSuccess)
    return err;

  const int parts = row_parts(rows), chunks = (p.bw + plan[kCoreChunk] - 1) / plan[kCoreChunk];
  PartialSums sums = {};
  sums.job[0] = {p.dwqkv_part, p.dwqkv, (rows + plan[kQkvWChunk] - 1) / plan[kQkvWChunk],
                 c * 3 * c};
  sums.job[1] = {p.dwproj_part, p.dwproj, (rows + plan[kProjWChunk] - 1) / plan[kProjWChunk],
                 c * c};
  sums.job[2] = {p.dbqkv_part, p.dbqkv, chunks, 3 * c};
  sums.job[3] = {p.dbproj_part, p.dbproj, parts, c};
  sums.job[4] = {p.dg1_part, p.dg1, parts, c};
  sums.job[5] = {p.dbe1_part, p.dbe1, parts, c};
  sums.job[6] = {p.dbias_part, p.dbias, chunks, p.heads * p.n * p.n};
  sums.n = 7;
  return launch_sum_partials(sums, s);
}

}  // namespace

// x, dx2, dx (bw, n, c); wqkv (c, 3c), wproj (c, c) in the storage type; g1,
// b1, bqkv (may be null) fp32; bias (heads, n, n) fp32; mask (num_windows, n,
// n) fp32 or null; m1 (bw / windows_per_image) fp32. Scratch in the storage
// type: xn1, attn, dproj, dao (bw, n, c), qkv and dqkv (bw, n, 3c); fp32: dxn1
// (bw, n, c) and the partials dwqkv_part (chunks of dWqkv, c, 3c),
// dwproj_part (chunks of dWproj, c, c), dbqkv_part (core chunks, 3c),
// dbproj_part, dg1_part, dbe1_part (row_parts(bw n), c), dbias_part (core
// chunks, heads, n, n). Outputs dwqkv (c, 3c), dbqkv (3c), dwproj (c, c),
// dbproj (c), dg1, dbe1 (c), dbias (heads, n, n) fp32. Heads of 32. plan:
// kAttnPlanLen ints, the tile forms (bf16), chunks of rows of the weight
// gradients and windows a core CTA takes (the launch plan's,
// ops/swin_block_fused.py::swin_attn_bwd).
extern "C" int swin_attn_bwd_launch(
    const void* x, const void* dx2, const void* g1, const void* b1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bias, const void* mask, const void* m1,
    void* xn1, void* qkv, void* attn, void* dproj, void* dao, void* dqkv, void* dxn1, void* dx,
    void* dwqkv_part, void* dwproj_part, void* dbqkv_part, void* dbproj_part, void* dg1_part,
    void* dbe1_part, void* dbias_part, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
    void* dg1, void* dbe1, void* dbias, int bw, int n, int c, int heads, int num_windows,
    int windows_per_image, float scale, float eps, const int* plan, int dtype, void* stream) {
  if (bw <= 0 || n <= 0 || c != heads * kDK || num_windows <= 0 || windows_per_image <= 0 ||
      bw % windows_per_image != 0 || plan == nullptr || plan[kProjWChunk] <= 0 ||
      plan[kQkvWChunk] <= 0 || plan[kCoreChunk] <= 0)
    return cudaErrorInvalidValue;
  AttnBwdArgs p = {};
  p.x = x; p.dx2 = dx2; p.wqkv = wqkv; p.wproj = wproj;
  p.g1 = static_cast<const float*>(g1); p.b1 = static_cast<const float*>(b1);
  p.bqkv = static_cast<const float*>(bqkv); p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask); p.m1 = static_cast<const float*>(m1);
  p.xn1 = xn1; p.qkv = qkv; p.attn = attn; p.dproj = dproj; p.dao = dao; p.dqkv = dqkv;
  p.dx = dx; p.dxn1 = static_cast<float*>(dxn1);
  p.dwqkv_part = static_cast<float*>(dwqkv_part); p.dwproj_part = static_cast<float*>(dwproj_part);
  p.dbqkv_part = static_cast<float*>(dbqkv_part); p.dbproj_part = static_cast<float*>(dbproj_part);
  p.dg1_part = static_cast<float*>(dg1_part); p.dbe1_part = static_cast<float*>(dbe1_part);
  p.dbias_part = static_cast<float*>(dbias_part);
  p.dwqkv = static_cast<float*>(dwqkv); p.dbqkv = static_cast<float*>(dbqkv);
  p.dwproj = static_cast<float*>(dwproj); p.dbproj = static_cast<float*>(dbproj);
  p.dg1 = static_cast<float*>(dg1); p.dbe1 = static_cast<float*>(dbe1);
  p.dbias = static_cast<float*>(dbias);
  p.bw = bw; p.n = n; p.c = c; p.heads = heads; p.num_windows = num_windows;
  p.windows_per_image = windows_per_image; p.plan = plan; p.scale = scale; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return attn_bwd_typed<float>(p, s);
  if (dtype == kBFloat16) return attn_bwd_typed<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}
