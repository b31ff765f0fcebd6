// B12: the int8 product of a w8a8 linear, y = (q(x) @ Wq^T) * (s_x * s_w) + b,
// fp32 out, q(x) = clip(rint(x / s_x), -127, 127) with one scale s_x for the
// whole tensor.
//
// Replaces on_device_image_captioning_tpu/ops/quant_matmul.py::
// quantized_matmul_pallas, which quantizes its activation tile in VMEM, runs
// the int8 MXU product with int32 accumulation and rescales in one pass. The
// numbers follow deploy/quantization.py::quantized_matmul, the function the
// JAX model runs: s_x = max(max|x|, 1e-8) / 127 in x's dtype (IEEE division,
// rounded to bf16 for bf16 x) or a calibrated scale; the quotient x / s_x in
// the dtype the two promote to (rounded to bf16 when both are bf16).
//
// Two kernels, in two or three launches a call (ops/quant_matmul.py picks
// the form and the tiles from the shapes alone):
//
// 1. The activation's scale and its int8 form, written once (M K bytes) for
//    every column tile of the product to read: a calibrated scale needs one
//    quantizing pass; the dynamic scale of a small x (<= 64 K values: every
//    decode step) is one CTA that forms max|x|, the scale and the int8 x; of
//    a large x, a pass of per-CTA maxima whose last CTA forms the scale (and
//    resets the arrival counter it used), then the quantizing pass. Bound:
//    bytes (x read, its int8 form written).
// 2. The product on the int8 tensor cores (mma.sync m16n8k32 s8, int32
//    accumulators), A and W moved in 16-byte cp.async loads through a
//    4-stage shared-memory ring of 64-byte k slabs, rows padded to 80 bytes
//    so that the fragment loads are free of bank conflicts. Two tile shapes:
//    - small M (<= 64 rows, every decode call): 16, 32 or 64 rows (no
//      128-row padding), 32 columns a CTA, K split so that about two CTAs an
//      SM are in flight; bound by streaming W once;
//    - large M: 64 x 128 tiles, 4 warps of 64 x 32 (up to three CTAs an SM,
//      so that a few hundred tiles spread evenly over the 132 SMs), K whole;
//      bound by int8 operations at the encoder's shapes.
//    Split K keeps the result bit for bit (int32 addition is associative):
//    each split adds its sums into an int32 buffer that is zero between
//    launches, and the last CTA of a tile to arrive (atomic counter, reset by
//    it) reads the totals, zeroes them again and applies the epilogue in
//    JAX's order, __fmul_rn(float(acc), __fmul_rn(s_x, s_w)) then
//    __fadd_rn(bias).
// The large-M route uses mma.sync, not wgmma: PERF.md says why.
// int32 cannot overflow: |acc| <= K * 127^2, under 2^31 for K < 133000.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "int8_linear.cuh"  // i8_quantize: the quantize rule B13 shares

namespace {

// ---------------------------------------------------------------------------
// 1. scale and int8 x

constexpr int kQThreads = 256;
constexpr int kQOneThreads = 1024;
constexpr int kQMaxBlocks = 1056;  // grid cap of the quantizing pass (8 CTAs an SM)

enum QuantForm { kCalibrated = 0, kDynamicOneCta = 1, kDynamicTwoPass = 2 };

// max over the CTA; every thread gets the result (red: 32 floats)
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (int)(threadIdx.x & 31) < (int)(blockDim.x >> 5) ? red[threadIdx.x & 31] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max(amax, 1e-8) / 127 computed in T as torch does on T: fp32 arithmetic,
// each result rounded to T
template <typename T>
__device__ __forceinline__ float dynamic_scale(float amax) {
  return round_t<T>(__fdiv_rn(round_t<T>(fmaxf(amax, 1e-8f)), 127.0f));
}

template <typename T>
__device__ __forceinline__ float vec_amax(const T* x, long v) {
  const uint4 u = reinterpret_cast<const uint4*>(x)[v];
  const T* h = reinterpret_cast<const T*>(&u);
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) m = fmaxf(m, fabsf(to_f<T>(h[j])));
  return m;
}

// the 16 bytes of x at vector v -> 16 / sizeof(T) int8 values
template <typename T>
__device__ __forceinline__ void quantize_vec(const T* x, int8_t* xq, long v, float s,
                                             int round_bf16) {
  constexpr int n = 16 / (int)sizeof(T);
  const uint4 u = reinterpret_cast<const uint4*>(x)[v];
  const T* h = reinterpret_cast<const T*>(&u);
  union {
    int8_t b[n];
    uint32_t w[n / 4];
  } q;
#pragma unroll
  for (int j = 0; j < n; ++j) q.b[j] = i8_quantize(to_f<T>(h[j]), s, round_bf16);
  uint32_t* dst = reinterpret_cast<uint32_t*>(xq + v * n);
#pragma unroll
  for (int i = 0; i < n / 4; ++i) dst[i] = q.w[i];
}

// dynamic scale and int8 x of a small x, in one CTA
template <typename T>
__global__ void __launch_bounds__(kQOneThreads)
    quant_one_cta_kernel(const T* __restrict__ x, long vecs, int8_t* __restrict__ xq,
                         float* __restrict__ s_out, int round_bf16) {
  __shared__ float red[32];
  float m = 0.f;
#pragma unroll 4
  for (long v = threadIdx.x; v < vecs; v += blockDim.x) m = fmaxf(m, vec_amax(x, v));
  const float s = dynamic_scale<T>(block_max(m, red));
#pragma unroll 4
  for (long v = threadIdx.x; v < vecs; v += blockDim.x) quantize_vec(x, xq, v, s, round_bf16);
  if (threadIdx.x == 0) *s_out = s;
}

// pass 1 of the large form: one maximum per CTA; the last CTA forms the scale
template <typename T>
__global__ void __launch_bounds__(kQThreads)
    quant_amax_kernel(const T* __restrict__ x, long vecs, float* __restrict__ partial,
                      int* __restrict__ counter, float* __restrict__ s_out) {
  __shared__ float red[32];
  __shared__ int is_last;
  float m = 0.f;
  for (long v = (long)blockIdx.x * blockDim.x + threadIdx.x; v < vecs;
       v += (long)gridDim.x * blockDim.x)
    m = fmaxf(m, vec_amax(x, v));
  m = block_max(m, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = m;
    __threadfence();
    is_last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float a = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) a = fmaxf(a, __ldcg(partial + i));
  a = block_max(a, red);
  if (threadIdx.x == 0) {
    *s_out = dynamic_scale<T>(a);
    *counter = 0;
  }
}

// the quantizing pass, by the fp32 or bf16 scale at `scale`; s_out (or null)
// receives it as fp32 for the product
template <typename T>
__global__ void __launch_bounds__(kQThreads)
    quant_apply_kernel(const T* __restrict__ x, long vecs, const void* scale, int scale_bf16,
                       int8_t* __restrict__ xq, float* __restrict__ s_out, int round_bf16) {
  const float s = scale_bf16 ? __bfloat162float(*static_cast<const __nv_bfloat16*>(scale))
                             : *static_cast<const float*>(scale);
  for (long v = (long)blockIdx.x * blockDim.x + threadIdx.x; v < vecs;
       v += (long)gridDim.x * blockDim.x)
    quantize_vec(x, xq, v, s, round_bf16);
  if (s_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
}

template <typename T>
cudaError_t launch_quantize(const void* xv, long numel, const void* x_scale, int scale_bf16,
                            int round_bf16, int form, int8_t* xq, float* s_out, float* partial,
                            int* counter, int partials, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const long vecs = numel * (long)sizeof(T) / 16;
  const long apply_blocks =
      std::min<long>((vecs + kQThreads - 1) / kQThreads, (long)kQMaxBlocks);
  if (form == kCalibrated) {
    quant_apply_kernel<T><<<(unsigned)apply_blocks, kQThreads, 0, s>>>(
        x, vecs, x_scale, scale_bf16, xq, s_out, round_bf16);
  } else if (form == kDynamicOneCta) {
    quant_one_cta_kernel<T><<<1, kQOneThreads, 0, s>>>(x, vecs, xq, s_out, round_bf16);
  } else {
    const long blocks = std::min<long>((vecs + kQThreads - 1) / kQThreads, (long)partials);
    quant_amax_kernel<T><<<(unsigned)blocks, kQThreads, 0, s>>>(x, vecs, partial, counter,
                                                               s_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    quant_apply_kernel<T><<<(unsigned)apply_blocks, kQThreads, 0, s>>>(
        x, vecs, s_out, 0, xq, nullptr, round_bf16);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2. the int8 product

constexpr int kBK = 64;          // k bytes of one stage
constexpr int kRow = kBK + 16;   // a row's stride in shared memory
constexpr int kStages = 4;

struct ProductArgs {
  const int8_t* a;        // (M, K) int8
  const float* s_x;       // one fp32 value
  const int8_t* w;        // (N, K) int8
  const float* w_scale;   // (N)
  const float* bias;      // (N) or null
  float* out;             // (M, N)
  int* sums;              // (M, N) int32, 0 between launches (split K only)
  int* counters;          // one per output tile, 0 between launches (split K only)
  int M, N, K, k_per_split;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// a CTA: WM x WN warps, each MT x NT fragments of 16 x 8; one K split
template <int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN) i8_product_kernel(ProductArgs p) {
  constexpr int kThreads = 32 * WM * WN, BM = 16 * MT * WM, BN = 8 * NT * WN;
  constexpr int kChunks = kBK / 16;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;
  int8_t* Bs = smem + kStages * BM * kRow;
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int steps = (k_end - k_begin + kBK - 1) / kBK;

  auto load = [&](int stage, int step) {
    const int k0 = k_begin + step * kBK;
    int8_t* as = As + stage * BM * kRow;
    int8_t* bs = Bs + stage * BN * kRow;
#pragma unroll
    for (int e = tid; e < BM * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 16;
      const bool ok = m0 + r < p.M && k0 + c < k_end;
      cp_async16(as + r * kRow + c, ok ? p.a + (long)(m0 + r) * p.K + k0 + c : p.a, ok);
    }
#pragma unroll
    for (int e = tid; e < BN * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 16;
      const bool ok = n0 + r < p.N && k0 + c < k_end;
      cp_async16(bs + r * kRow + c, ok ? p.w + (long)(n0 + r) * p.K + k0 + c : p.w, ok);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab `step` has landed; slab step - 1 is read by all
    const int next = step + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();
    const int8_t* as = As + (step % kStages) * BM * kRow + (wm * 16 * MT + g) * kRow + 4 * t4;
    const int8_t* bs = Bs + (step % kStages) * BN * kRow + (wn * 8 * NT + g) * kRow + 4 * t4;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* pa = as + 16 * i * kRow + kk;
        a[i][0] = lds32(pa);
        a[i][1] = lds32(pa + 8 * kRow);
        a[i][2] = lds32(pa + 16);
        a[i][3] = lds32(pa + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* pb = bs + 8 * j * kRow + kk;
        b[j][0] = lds32(pb);
        b[j][1] = lds32(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // fragment (i, j), value e: row rw + 16 i + g + 8 (e / 2), column cw + 8 j + 2 t4 + e % 2
  const int rw = m0 + wm * 16 * MT + g, cw = n0 + wn * 8 * NT + 2 * t4;
  if (gridDim.z > 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rw + 16 * i + 8 * (e >> 1), c = cw + 8 * j + (e & 1);
          if (r < p.M && c < p.N) atomicAdd(p.sums + (long)r * p.N + c, acc[i][j][e]);
        }
    __threadfence();
    __syncthreads();
    int* counter = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) is_last = atomicAdd(counter, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rw + 16 * i + 8 * (e >> 1), c = cw + 8 * j + (e & 1);
          if (r < p.M && c < p.N) {
            int* at = p.sums + (long)r * p.N + c;
            acc[i][j][e] = __ldcg(at);
            *at = 0;
          }
        }
    if (tid == 0) *counter = 0;
  }
  const float sx = *p.s_x;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + 16 * i + 8 * (e >> 1), c = cw + 8 * j + (e & 1);
        if (r >= p.M || c >= p.N) continue;
        float v = __fmul_rn(__int2float_rn(acc[i][j][e]), __fmul_rn(sx, p.w_scale[c]));
        if (p.bias != nullptr) v = __fadd_rn(v, p.bias[c]);
        p.out[(long)r * p.N + c] = v;
      }
}

template <int MT, int NT, int WM, int WN>
cudaError_t launch_product(const ProductArgs& p, int splits, cudaStream_t s) {
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  const int smem = kStages * (BM + BN) * kRow;
  auto kernel = i8_product_kernel<MT, NT, WM, WN>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((p.N + BN - 1) / BN), (unsigned)((p.M + BM - 1) / BM),
                  (unsigned)splits);
  kernel<<<grid, 32 * WM * WN, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The activation's scale and int8 form. x (numel) fp32 or bf16 (dtype),
// 16-byte aligned, numel * element size a multiple of 16; form: 0 calibrated
// (x_scale one fp32 or bf16 value, scale_bf16), 1 dynamic in one CTA, 2
// dynamic in two passes (partial: `partials` floats; counter: one int, 0
// between launches). xq (numel) int8; s_out one fp32 value.
extern "C" int quant_act_launch(const void* x, int dtype, long numel, const void* x_scale,
                                int scale_bf16, int round_bf16, int form, void* xq, void* s_out,
                                void* partial, void* counter, int partials, void* stream) {
  const int esize = dtype == kBFloat16 ? 2 : 4;
  if ((dtype != kFloat32 && dtype != kBFloat16) || numel <= 0 || (numel * esize) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(xq) & 3) ||
      s_out == nullptr || form < kCalibrated || form > kDynamicTwoPass ||
      (form == kCalibrated && x_scale == nullptr) ||
      (form == kDynamicTwoPass && (partial == nullptr || counter == nullptr || partials <= 0)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* so = static_cast<float*>(s_out);
  float* pa = static_cast<float*>(partial);
  int* ct = static_cast<int*>(counter);
  if (dtype == kFloat32)
    return launch_quantize<float>(x, numel, x_scale, scale_bf16, round_bf16, form, q, so, pa, ct,
                                  partials, s);
  return launch_quantize<__nv_bfloat16>(x, numel, x_scale, scale_bf16, round_bf16, form, q, so,
                                        pa, ct, partials, s);
}

// The product on int8 x. xq (M, K) and w_q (N, K) int8, 16-byte aligned, K a
// multiple of 16; s_x one fp32 value; w_scale (N) fp32; bias (N) fp32 or
// null; out (M, N) fp32. route 0 (small M: mt fragments of 16 rows, M <= 16
// mt, mt in 1, 2, 4) or 1 (large M); K in `splits` slices of k_per_split (a
// multiple of 64); with splits > 1, sums (M, N) int32 and counters (one per
// output tile) zero, as the kernel leaves them.
extern "C" int i8_product_launch(const void* xq, const void* s_x, const void* w_q,
                                 const void* w_scale, const void* bias, void* out, void* sums,
                                 void* counters, int M, int N, int K, int route, int mt,
                                 int splits, int k_per_split, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || splits <= 0 || k_per_split <= 0 ||
      k_per_split % kBK != 0 || (long)splits * k_per_split < K ||
      (long)(splits - 1) * k_per_split >= K || s_x == nullptr || w_scale == nullptr ||
      (reinterpret_cast<uintptr_t>(xq) & 15) || (reinterpret_cast<uintptr_t>(w_q) & 15) ||
      (splits > 1 && (sums == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  ProductArgs p;
  p.a = static_cast<const int8_t*>(xq);
  p.s_x = static_cast<const float*>(s_x);
  p.w = static_cast<const int8_t*>(w_q);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.sums = static_cast<int*>(sums);
  p.counters = static_cast<int*>(counters);
  p.M = M; p.N = N; p.K = K; p.k_per_split = k_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) return launch_product<4, 4, 1, 4>(p, splits, s);
  if (route != 0 || M > 16 * mt) return cudaErrorInvalidValue;
  if (mt == 1) return launch_product<1, 1, 1, 4>(p, splits, s);
  if (mt == 2) return launch_product<2, 1, 1, 4>(p, splits, s);
  if (mt == 4) return launch_product<4, 1, 1, 4>(p, splits, s);
  return cudaErrorInvalidValue;
}
