// B13: the MLP half of a Swin block with int8 activations and weights (w8a8),
// out = x + fc2(GELU(fc1(LN2(x)))) over flat rows (R, C), each product int8 x
// int8 with int32 accumulation and a per-row dynamic activation scale.
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// _mlp_half_kernel_a8 (reached through swin_mlp_half_fused on w8a8 nodes),
// which keeps a row tile's int8 rows and (rows, 4C) hidden activation in VMEM.
// Its arithmetic, step for step: LN2 with fp32 statistics, rounded to x's
// dtype; per row s = max(max|h|, 1e-8) / 127 and q = clip(rint(h / s)) in
// fp32; y = acc * (s_h * s1) + b1; GELU of the unrounded fp32 y (the exact
// erf here; the TPU kernel's polynomial erf is a Mosaic workaround); y
// quantized per row the same way; z = acc * (s_y * s2) + b2; out = x + T(z)
// in x's dtype T.
//
// Bound on the H100: operations, 16 C^2 int8 operations a row (two products
// of 2 C 4C) against 4 C bytes of x in and out in bf16, 4 C operations a
// byte, far above the card's balance point. What holds it back on the card:
// the products' operands come from L2, whose rate an SM draws (about 45
// GB/s) sets the pace of a long product, and fc1's epilogue (the exact-erf
// GELU and the quantization of every one of the 4C hidden values a row)
// costs as much ALU time as its products do tensor-core time. The hidden
// is quantized once, per row, by its absmax, which must be known before the
// row's first value is quantized. Design, in four launches:
//   1. row pass: one warp a row, the row in registers (16-byte loads); LN2,
//      the row's absmax, the int8 row and its scale; it zeroes the row's
//      hidden absmax for launch 2;
//   2. fc1: the int8 product (below) with an epilogue that stores GELU(y) in
//      fp32 (4C values a row, written once) and adds each row's absmax to
//      hmax by atomicMax on the float's bits (all >= 0, so their order is the
//      ints': order-free, the one atomic);
//   3. the quantizing pass: each fp32 hidden row read once, quantized by its
//      absmax into the int8 hidden (rows, 4C);
//   4. fc2 on the int8 hidden with the residual epilogue, out = T(x + T(z)).
// fc2 reads the hidden as int8, one scale a row; no fp32 hidden is read per
// column tile. Running fc1 twice instead (a first pass for the row absmaxes
// only, a second that forms the same y bit for bit and stores it quantized)
// keeps the fp32 hidden out of device memory, and measured slower at every
// main-path shape (PERF.md): a second pass of fc1 costs more than the 9
// bytes a hidden value of traffic it saves. ops/linear_plan.py::mlp_a8_plan
// picks each product's tile, which the launcher only checks.
//
// The int8 product (a8_product_kernel): Hopper's warpgroup MMA, wgmma
// m64nNk32 s8 x s8 -> s32 with both operands K-major as they lie in memory
// (A (M, K) int8 rows, W (N, K) int8 rows). A and W K slabs of 128 values (a
// 128-byte row) go through a ring of 3 or 4 stages of shared memory in the
// 128-byte swizzle by 16-byte cp.async, S - 1 slabs ahead of the products,
// every thread moving its share; a zero-filled tail where K is not a multiple
// of 128 (K = 192 at stage 0). mbarriers say when a stage is full (the copies
// report to it themselves) and when both warpgroups are done with it. A CTA
// is one or two warpgroups over a 64- or 128-row tile (the forms of
// kInt8Forms); K is never split, so every output is one CTA's sum in a
// fixed order and two launches agree bit for bit. The epilogue keeps JAX's
// order without contraction: __fmul_rn(float(acc), __fmul_rn(s_a, s_w)),
// then __fadd_rn(bias); the finished tile is staged in the ring and stored
// in whole 16-byte chunks. int32 cannot overflow: |acc| <= K 127^2 < 2^31
// for K < 133000.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "int8_linear.cuh"

// Tile forms of a8_product_kernel: BM rows (a consumer warpgroup for every
// 64), BN columns, K slabs of 128, a ring of STAGES slabs, and the CTAs one
// SM holds at that shared memory and those registers (the launch bounds):
// two to four, so that one CTA's epilogue overlaps another's products; the
// smaller tiles with more CTAs an SM win where fc1's short K leaves a tile
// mostly epilogue, and at b1's few rows (forms of one CTA an SM, 128 x 192
// and 128 x 256, and others measured slower at every main-path shape:
// PERF.md). The launch plan (ops/linear_plan.py, which reads this table in
// its tests) picks one per product.
struct Int8Form {
  int bm, bn, stages, ctas;
};
constexpr Int8Form kInt8Forms[] = {
    {128, 128, 3, 2},  // 0
    {128, 64, 3, 3},   // 1
    {64, 64, 3, 4},    // 2
};
constexpr int kInt8Slab = 128;  // K values (bytes) of a slab: one swizzled row

// Dynamic shared memory of a form: the ring, 1024 bytes to align it (the
// swizzle repeats every 1024), a full and an empty barrier per stage, the
// scale of each of the tile's rows and the scale and bias of each column.
constexpr int int8_smem(const Int8Form& f) {
  return f.stages * (f.bm + f.bn) * 128 + 1024 + 2 * f.stages * 8 + (f.bm + 2 * f.bn) * 4;
}

enum A8Epilogue {
  kEpiGelu = 0,   // GELU(y) stored in fp32, its row absmax into hmax (fc1)
  kEpiResid = 1,  // out = T(resid + T(z)) (fc2)
};

struct A8Args {
  const int8_t* a;       // (M, K) int8 rows
  const float* a_scale;  // (M): fc1 the LN2 rows' scales; fc2 the hidden rows' absmaxes
  const int8_t* w;       // (N, K) int8
  const float* w_scale;  // (N)
  const float* bias;     // (N) or null
  float* hmax;           // (M) the hidden rows' absmax of GELU(y) (kEpiGelu)
  void* out;             // (M, N): fp32 (kEpiGelu), T (kEpiResid)
  const void* resid;     // (M, N) in T (kEpiResid)
  int M, N, K;
};

// the per-row scale of a row absmax, as JAX forms it: max(amax, 1e-8) / 127
__device__ __forceinline__ float a8_scale_of(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

__device__ __forceinline__ float a8_gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float a8_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float a8_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// an int8 value as byte `at` of a little-endian word
__device__ __forceinline__ uint32_t pack_i8(int8_t v, int at) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * at);
}

// One warp a row: h = T(LN(x)), s = max(max|h|, 1e-8) / 127, q = clip(rint(h / s)).
// A lane keeps up to kRowChunks 16-byte chunks of the row in registers (C up
// to 2048 in bf16, 1024 in fp32) and reads any further ones again.
constexpr int kRowChunks = 8;
template <typename T>
__global__ void __launch_bounds__(256) ln_quant_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
    int8_t* __restrict__ xq, float* __restrict__ xs, float* __restrict__ hmax, int rows, int c,
    float eps) {
  constexpr int V = 16 / sizeof(T);  // values a chunk
  const int lane = threadIdx.x & 31;
  const long r = static_cast<long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const uint4* row = reinterpret_cast<const uint4*>(x + r * c);
  const int chunks = c / V;
  uint4 keep[kRowChunks];
#pragma unroll
  for (int i = 0; i < kRowChunks; ++i)
    if (lane + 32 * i < chunks) keep[i] = row[lane + 32 * i];
  // f(values of chunk ch, first column of ch) over the lane's chunks
  auto each = [&](auto&& f) {
#pragma unroll
    for (int i = 0; i < kRowChunks; ++i)
      if (lane + 32 * i < chunks) f(reinterpret_cast<const T*>(&keep[i]), (lane + 32 * i) * V);
    for (int ch = lane + 32 * kRowChunks; ch < chunks; ch += 32) {
      const uint4 raw = row[ch];
      f(reinterpret_cast<const T*>(&raw), ch * V);
    }
  };
  float s = 0.f;
  each([&](const T* h, int) {
#pragma unroll
    for (int e = 0; e < V; ++e) s += to_f<T>(h[e]);
  });
  const float mean = a8_warp_sum(s) / c;
  float q = 0.f;
  each([&](const T* h, int) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = to_f<T>(h[e]) - mean;
      q = fmaf(d, d, q);
    }
  });
  const float rstd = 1.0f / sqrtf(a8_warp_sum(q) / c + eps);
  // the chunk's LN2 values, T(((v - mean) rstd) g + b), the LayerNorm
  // parameters of its columns read as 16-byte vectors
  auto ln = [&](const T* h, int k0, float (&out)[V]) {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 g4 = *reinterpret_cast<const float4*>(g + k0 + e);
      const float4 b4 = *reinterpret_cast<const float4*>(b + k0 + e);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        out[e + u] = round_t<T>(
            __fadd_rn(__fmul_rn(__fmul_rn(to_f<T>(h[e + u]) - mean, rstd), gv[u]), bv[u]));
    }
  };
  float amax = 0.f;
  each([&](const T* h, int k0) {
    float v[V];
    ln(h, k0, v);
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
  });
  const float scale = a8_scale_of(a8_warp_max(amax)), inv = __frcp_rn(scale);
  each([&](const T* h, int k0) {
    float v[V];
    ln(h, k0, v);
    uint32_t words[V / 4] = {};  // the chunk's int8 values, four a word
#pragma unroll
    for (int e = 0; e < V; ++e) words[e / 4] |= pack_i8(i8_quantize_by(v[e], scale, inv), e % 4);
    int8_t* dst = xq + r * c + k0;
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = words[0];
  });
  if (lane == 0) {
    xs[r] = scale;
    hmax[r] = 0.f;
  }
}

// The quantizing pass: a CTA takes rows in turn and quantizes the fp32
// hidden row by its absmax into int8, four values (16 bytes in) a thread and
// step.
__global__ void __launch_bounds__(256) hidden_quant_kernel(const float* __restrict__ h,
                                                           const float* __restrict__ hmax,
                                                           int8_t* __restrict__ q, int rows,
                                                           int n) {
  for (long r = blockIdx.x; r < rows; r += gridDim.x) {
    const float s = a8_scale_of(hmax[r]), inv = __frcp_rn(s);
    const float4* src = reinterpret_cast<const float4*>(h + r * n);
    uint32_t* dst = reinterpret_cast<uint32_t*>(q + r * n);
    for (int i = threadIdx.x; i < n / 4; i += 256) {
      const float4 v = src[i];
      dst[i] = pack_i8(i8_quantize_by(v.x, s, inv), 0) | pack_i8(i8_quantize_by(v.y, s, inv), 1) |
               pack_i8(i8_quantize_by(v.z, s, inv), 2) | pack_i8(i8_quantize_by(v.w, s, inv), 3);
    }
  }
}

// One CTA computes the BM x BN output tile blockIdx.x of the (row tiles x
// column tiles) grid, column tiles fastest; warpgroup g holds rows 64 g ..
// 64 g + 63 as int32 accumulators in its registers. Every thread moves its
// share of each K slab into the ring by 16-byte cp.async, S - 1 slabs ahead:
//   slab j sits in stage j % S; full[s] completes when every thread's copies
//   of it have landed; empty[s] when both warpgroups' products on it are
//   done, and only then is the stage refilled with slab j + S.
// A stage holds A as BM rows of 128 bytes and W as BN rows of 128 bytes, 16-
// byte chunk c of row m at c ^ (m & 7) (the 128-byte swizzle the descriptors
// name: 8-row groups of 1024 bytes; a k32 step is 32 bytes further on). The
// first slabs are in flight before the tile's scales are read.
template <int BM, int BN, int S, int CTAS, int EPI, typename T>
__global__ void __launch_bounds__(2 * BM, CTAS) a8_product_kernel(A8Args p) {
  constexpr int THREADS = 2 * BM;
  constexpr int A_BYTES = BM * 128, STAGE = (BM + BN) * 128;
  constexpr int A_PER = BM * 8 / THREADS, W_PER = BN * 8 / THREADS;  // 16-byte chunks a thread
  static_assert((BM == 64 || BM == 128) && BN % 64 == 0 && (BN * 8) % THREADS == 0,
                "one or two warpgroups, whole chunks");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  float* row_s = reinterpret_cast<float*>(empty + S);  // BM: the A rows' scales
  float* col_s = row_s + BM;                            // BN: the W rows' scales
  float* col_b = col_s + BN;                            // BN: the biases

  const int tid = threadIdx.x, wg = tid >> 7;
  const int col_tiles = (p.N + BN - 1) / BN;
  const long m0 = static_cast<long>(blockIdx.x / col_tiles) * BM;
  const int n0 = (blockIdx.x % col_tiles) * BN;
  const int slabs = (p.K + kInt8Slab - 1) / kInt8Slab;
  const uint32_t ring_s = smem_u32(ring);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], THREADS);
      mbar_init(&empty[s], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int j) {  // slab j into stage j % S, reported to full[j % S]
    const int k0 = j * kInt8Slab;
    const uint32_t sa = ring_s + (j % S) * STAGE, sw = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * THREADS, m = e >> 3, ch = e & 7;
      const bool ok = m0 + m < p.M && k0 + ch * 16 < p.K;
      cp_async16(sa + m * 128 + ((ch ^ (m & 7)) << 4),
                 ok ? p.a + (m0 + m) * p.K + k0 + ch * 16 : p.a, ok);
    }
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int e = tid + i * THREADS, n = e >> 3, ch = e & 7;
      const bool ok = n0 + n < p.N && k0 + ch * 16 < p.K;
      cp_async16(sw + n * 128 + ((ch ^ (n & 7)) << 4),
                 ok ? p.w + static_cast<long>(n0 + n) * p.K + k0 + ch * 16 : p.w, ok);
    }
    mbar_arrive_on_copies(&full[j % S]);
  };

#pragma unroll
  for (int j = 0; j < S - 1; ++j)
    if (j < slabs) load(j);
  // the tile's scales (read after the products, past the __syncthreads below)
  for (int i = tid; i < BM; i += THREADS) {
    const long r = m0 + i;
    const bool in = r < p.M;
    row_s[i] = !in ? 0.f : EPI == kEpiResid ? a8_scale_of(p.a_scale[r]) : p.a_scale[r];
  }
  for (int i = tid; i < BN; i += THREADS) {
    const int c = n0 + i;
    col_s[i] = c < p.N ? p.w_scale[c] : 0.f;
    col_b[i] = c < p.N && p.bias != nullptr ? p.bias[c] : 0.f;
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int j = 0; j < slabs; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    fence_proxy_async();
    const uint32_t sa = ring_s + s * STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kInt8Slab / 32; ++kk)
      wgmma_s8<BN>(acc, smem_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024, 1),
                   smem_desc(sa + A_BYTES + kk * 32, 16, 1024, 1));
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
  __syncthreads();  // both warpgroups are done with the ring: it takes the tile now

  // accumulator d[4 j + 2 h + b] of lane l in warp v of the warpgroup is row
  // 16 v + l / 4 + 8 h, column 8 j + 2 (l % 4) + b of the warpgroup's piece
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  auto value = [&](int i, int row, int c) {  // y or z before the activation
    return __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), __fmul_rn(row_s[row], col_s[c])),
                     col_b[c]);
  };
  // the finished tile, staged in the ring as rows of BN values and 16 bytes
  using O = typename std::conditional<EPI == kEpiGelu, float, T>::type;
  constexpr int ST = BN * (int)sizeof(O) + 16;
  static_assert(BM * ST <= S * STAGE, "the finished tile fits the ring");
  float amax[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int row = r0 + 8 * h, c = j * 8 + (lane & 3) * 2 + b;
        const float v = value(4 * j + 2 * h + b, row, c);
        O o;
        if constexpr (EPI == kEpiGelu) {
          o = a8_gelu(v);
          amax[h] = fmaxf(amax[h], fabsf(o));
        } else {
          o = from_f<T>(v);
        }
        *reinterpret_cast<O*>(ring + row * ST + c * sizeof(O)) = o;
      }
  if constexpr (EPI == kEpiGelu) {
    // the quad of lanes that shares a row, then one atomicMax a row and warp,
    // on the float's bits
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const long r = m0 + r0 + 8 * h;
      if ((lane & 3) == 0 && r < p.M)
        atomicMax(reinterpret_cast<int*>(p.hmax + r), __float_as_int(v));
    }
  }
  __syncthreads();
  // whole 16-byte chunks of the tile's rows: the residual's loads first
  constexpr int CH = BN * (int)sizeof(O) / 16, PER = BM * CH / THREADS;
  static_assert(PER * THREADS == BM * CH, "whole chunks a thread");
  O* out = static_cast<O*>(p.out);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS, row = e / CH, ch = e % CH;
    const long r = m0 + row;
    const int c = n0 + ch * (16 / (int)sizeof(O));
    if (r >= p.M || c >= p.N) continue;
    uint4 raw = *reinterpret_cast<const uint4*>(ring + row * ST + ch * 16);
    if constexpr (EPI == kEpiResid) {
      const uint4 res =
          *reinterpret_cast<const uint4*>(static_cast<const T*>(p.resid) + r * p.N + c);
      const T* xr = reinterpret_cast<const T*>(&res);
      T* zr = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e2 = 0; e2 < 16 / (int)sizeof(T); ++e2)
        zr[e2] = from_f<T>(__fadd_rn(to_f<T>(xr[e2]), to_f<T>(zr[e2])));
    }
    *reinterpret_cast<uint4*>(out + r * p.N + c) = raw;
  }
}

// One launch of form F: the attribute once per kernel (a process-wide static).
template <int F, int EPI, typename T>
static cudaError_t launch_a8(const A8Args& p, cudaStream_t s) {
  constexpr Int8Form f = kInt8Forms[F];
  constexpr int smem = int8_smem(f);
  static_assert(smem <= 232448 && f.ctas * (smem + 1024) <= 233472,
                "a CTA's and an SM's shared memory");
  const auto kernel = a8_product_kernel<f.bm, f.bn, f.stages, f.ctas, EPI, T>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const long tiles = static_cast<long>((p.M + f.bm - 1) / f.bm) * ((p.N + f.bn - 1) / f.bn);
  if (tiles > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles), 2 * f.bm, smem, s>>>(p);
  return cudaGetLastError();
}

template <int EPI, typename T>
static cudaError_t launch_a8_form(const A8Args& p, int form, cudaStream_t s) {
  switch (form) {
    case 0: return launch_a8<0, EPI, T>(p, s);
    case 1: return launch_a8<1, EPI, T>(p, s);
    case 2: return launch_a8<2, EPI, T>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

static bool a8_shapes_ok(int m, int n, int k) {
  // 16-byte chunks of every int8 row (a product's K is the next one's N)
  return m > 0 && n > 0 && k > 0 && n % 16 == 0 && k % 16 == 0;
}

template <typename T>
static cudaError_t launch_typed(const void* x, const float* ln_g, const float* ln_b,
                                const int8_t* w1q, const float* s1, const float* b1,
                                const int8_t* w2q, const float* s2, const float* b2,
                                int8_t* xq, float* xs, float* gelu, int8_t* hidden, float* hmax,
                                void* out, int rows, int c, int hid, float eps, int form1,
                                int form2, cudaStream_t s) {
  ln_quant_rows_kernel<T><<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const T*>(x), ln_g, ln_b,
                                                         xq, xs, hmax, rows, c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  A8Args p = {};
  p.a = xq; p.a_scale = xs; p.w = w1q; p.w_scale = s1; p.bias = b1; p.hmax = hmax;
  p.out = gelu;
  p.M = rows; p.N = hid; p.K = c;
  err = launch_a8_form<kEpiGelu, float>(p, form1, s);
  if (err != cudaSuccess) return err;
  hidden_quant_kernel<<<rows < 4224 ? rows : 4224, 256, 0, s>>>(gelu, hmax, hidden, rows, hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  A8Args q = {};
  q.a = hidden; q.a_scale = hmax; q.w = w2q; q.w_scale = s2; q.bias = b2;
  q.out = out; q.resid = x;
  q.M = rows; q.N = c; q.K = hid;
  return launch_a8_form<kEpiResid, T>(q, form2, s);
}

// x, out (rows, c) fp32 or bf16; LayerNorm parameters fp32 (c); w1q (hid, c)
// and w2q (c, hid) int8 with fp32 scales (hid), (c) and biases (or null);
// scratch: xq (rows, c) int8, xs (rows) fp32, gelu (rows, hid) fp32 (fc1's
// output), hidden (rows, hid) int8 (what fc2 reads), hmax (rows) fp32. form1,
// form2: indices of kInt8Forms for fc1 and fc2 (ops/linear_plan.py::
// mlp_a8_plan).
extern "C" int swin_mlp_half_a8_launch(const void* x, const void* ln_g, const void* ln_b,
                                       const void* w1q, const void* s1, const void* b1,
                                       const void* w2q, const void* s2, const void* b2,
                                       void* xq, void* xs, void* gelu, void* hidden, void* hmax,
                                       void* out, int rows, int c, int hid, float eps, int form1,
                                       int form2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a8_shapes_ok(rows, hid, c) || !a8_shapes_ok(rows, c, hid)) return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ln_g);
  const auto* b = static_cast<const float*>(ln_b);
  const auto* w1 = static_cast<const int8_t*>(w1q);
  const auto* w2 = static_cast<const int8_t*>(w2q);
  const auto* fs1 = static_cast<const float*>(s1);
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* fs2 = static_cast<const float*>(s2);
  const auto* fb2 = static_cast<const float*>(b2);
  auto* q = static_cast<int8_t*>(xq);
  auto* fxs = static_cast<float*>(xs);
  auto* fg = static_cast<float*>(gelu);
  auto* hq = static_cast<int8_t*>(hidden);
  auto* fm = static_cast<float*>(hmax);
  if (dtype == kFloat32)
    return launch_typed<float>(x, g, b, w1, fs1, fb1, w2, fs2, fb2, q, fxs, fg, hq, fm, out, rows,
                               c, hid, eps, form1, form2, s);
  if (dtype == kBFloat16)
    return launch_typed<__nv_bfloat16>(x, g, b, w1, fs1, fb1, w2, fs2, fb2, q, fxs, fg, hq, fm,
                                       out, rows, c, hid, eps, form1, form2, s);
  return cudaErrorInvalidValue;
}

// One of B13's products alone, for timing and card tests: fc1 (out (m, n)
// fp32 GELU(y), the row absmaxes added to hmax, which holds 0 or less) or fc2
// (the residual epilogue; a_scale holds the hidden rows' absmaxes, out and
// resid (m, n) in dtype).
extern "C" int a8_product_launch(const void* a, const void* a_scale, const void* w,
                                 const void* w_scale, const void* bias, void* hmax, void* out,
                                 const void* resid, int m, int n, int k, int fc2, int form,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a8_shapes_ok(m, n, k)) return cudaErrorInvalidValue;
  A8Args p = {};
  p.a = static_cast<const int8_t*>(a);
  p.a_scale = static_cast<const float*>(a_scale);
  p.w = static_cast<const int8_t*>(w);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.hmax = static_cast<float*>(hmax);
  p.out = out;
  p.resid = resid;
  p.M = m; p.N = n; p.K = k;
  if (!fc2) {
    if (hmax == nullptr) return cudaErrorInvalidValue;
    return launch_a8_form<kEpiGelu, float>(p, form, s);
  }
  if (resid == nullptr) return cudaErrorInvalidValue;
  if (dtype == kFloat32) return launch_a8_form<kEpiResid, float>(p, form, s);
  if (dtype == kBFloat16) return launch_a8_form<kEpiResid, __nv_bfloat16>(p, form, s);
  return cudaErrorInvalidValue;
}
