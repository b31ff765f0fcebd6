// K4: LayerNorm over the last axis of (rows, C): statistics in fp32 (mean,
// then the biased variance from the same values), (x - mean) / sqrt(var +
// eps) * w + b, the output in x's dtype (fp32 or bf16); w and b are fp32.
//
// Replaces on_device_image_captioning_tpu/ops/layernorm.py::layernorm_pallas
// (its `_ln_kernel`). As there, the gradient is plain tensor code
// (ops/layernorm.py::_LayerNorm.backward), not a kernel.
//
// Bound on the H100: bytes where there are many rows (each row read once and
// written once, a handful of flops a value: the backbone's (73728, 192) bf16
// call moves 56.6 MB, 16.9 us at 3.35 TB/s); the launch where there are few
// (the decode's (24, 512) fp32 calls move 98 KB).
//
// Design:
//   - A row belongs to a group of `group` lanes of one warp (32 / group rows
//     a warp at once), each lane holding N 16-byte chunks of it in registers
//     (lane g of the group takes chunks g, g + group, ...: neighbouring lanes
//     on neighbouring addresses). Both sums are xor-shuffle butterflies over
//     the group: no shared memory, no __syncthreads. The mean comes from the
//     row in registers, then the sum of squared deviations from the same
//     registers: one pass over memory.
//   - ops/layernorm.py::layernorm_plan picks (group, N) so that group x N is
//     the row's chunk count where the table has such an N (C = 192 bf16: 8
//     lanes of 3 chunks, four rows a warp; fp32: 16 lanes of 3; C = 512 fp32,
//     the decode's: 32 lanes of 4), else 32 lanes over the fewest chunks that
//     hold the row (the last masked); widths of no whole 16-byte chunks, or
//     operands not 16-byte aligned, take layernorm_any_kernel (a warp a row,
//     one value a lane at a time, the row read three times from L1).
//   - Weight and bias are read once a lane, into registers, where they are at
//     most kHoldValues a lane, and held across every row the warp walks
//     (wider rows read them from L1 in the output pass).
//   - The grid comes from the plan: a CTA for each group of rows a warp
//     takes, at most kCtasPerSm an SM (the launch bounds keep them resident).
//     Warps are numbered CTA first, so the decode's 24 rows run on 24 SMs,
//     one warp each, and each warp walks its rows with a grid-wide stride;
//     where the chunks are few (N <= kPrefetchChunks) the next rows' chunks
//     load while this row is reduced.
//   - A lane sums its values in chunk order, then the butterfly: the order is
//     fixed by the lane layout, so two launches give the same bits.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;        // launch bounds: at most 128 registers a thread
constexpr int kHoldValues = 32;      // w and b stay in registers up to this many values a lane
constexpr int kPrefetchChunks = 4;   // the next rows' chunks load early up to this many a lane

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kValues = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kValues = 8;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);  // the lower address holds the lower half
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// the sum of v over the `group` lanes of a power-of-two lane group; every
// lane of the group gets the same bits (each level adds the same two values)
__device__ __forceinline__ float group_sum(float v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int P>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float* f) {
#pragma unroll
  for (int e = 0; e < P; e += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + e));
    f[e] = q.x;
    f[e + 1] = q.y;
    f[e + 2] = q.z;
    f[e + 3] = q.w;
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_row(const uint4* __restrict__ src, bool live, int g,
                                         int group, int chunks, uint4* raw) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int ch = j * group + g;
    raw[j] = live && ch < chunks ? __ldg(src + ch) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ out, int rows, int c,
                     int group, float eps) {
  using Pk = Pack<T>;
  constexpr int P = Pk::kValues;
  constexpr bool kHold = N * P <= kHoldValues;
  constexpr bool kPrefetch = N <= kPrefetchChunks;
  const int lane = threadIdx.x & 31;
  const int g = lane & (group - 1), slot = lane / group, per_warp = 32 / group;
  const int chunks = c / P;
  const float fc = static_cast<float>(c);

  float wr[kHold ? N * P : 1], br[kHold ? N * P : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int ch = j * group + g;
      if (ch < chunks) {
        load_f32<P>(w + ch * P, wr + j * P);
        load_f32<P>(b + ch * P, br + j * P);
      }
    }
  }

  // warps numbered CTA first: a call of few rows spreads over the SMs
  const long stride = static_cast<long>(gridDim.x) * kWarps * per_warp;
  long r0 = (static_cast<long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x) * per_warp;
  uint4 raw[N], next[kPrefetch ? N : 1];
  if constexpr (kPrefetch) {
    const long row = r0 + slot;
    load_row<T, N>(reinterpret_cast<const uint4*>(x + row * c), row < rows, g, group, chunks,
                   next);
  }
  for (; r0 < rows; r0 += stride) {
    const long row = r0 + slot;
    const bool live = row < rows;
    if constexpr (kPrefetch) {
#pragma unroll
      for (int j = 0; j < N; ++j) raw[j] = next[j];
      const long ahead = row + stride;
      load_row<T, N>(reinterpret_cast<const uint4*>(x + ahead * c), ahead < rows, g, group,
                     chunks, next);
    } else {
      load_row<T, N>(reinterpret_cast<const uint4*>(x + row * c), live, g, group, chunks, raw);
    }

    float s = 0.f;  // masked chunks hold zeros: they add nothing
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float f[P];
      Pk::unpack(raw[j], f);
#pragma unroll
      for (int e = 0; e < P; ++e) s += f[e];
    }
    const float mean = group_sum(s, group) / fc;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j * group + g < chunks) {
        float f[P];
        Pk::unpack(raw[j], f);
#pragma unroll
        for (int e = 0; e < P; ++e) {
          const float d = f[e] - mean;
          q += d * d;
        }
      }
    }
    const float rstd = 1.0f / sqrtf(group_sum(q, group) / fc + eps);
    if (!live) continue;
    uint4* dst = reinterpret_cast<uint4*>(out + row * c);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int ch = j * group + g;
      if (ch >= chunks) continue;
      float f[P], o[P];
      Pk::unpack(raw[j], f);
      if constexpr (kHold) {
#pragma unroll
        for (int e = 0; e < P; ++e) o[e] = (f[e] - mean) * rstd * wr[j * P + e] + br[j * P + e];
      } else {
        float wv[P], bv[P];
        load_f32<P>(w + ch * P, wv);
        load_f32<P>(b + ch * P, bv);
#pragma unroll
        for (int e = 0; e < P; ++e) o[e] = (f[e] - mean) * rstd * wv[e] + bv[e];
      }
      dst[ch] = Pk::pack(o);
    }
  }
}

// any C and any alignment: a warp a row, a value a lane at a time, the row
// read three times (from L1 after the first)
template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    layernorm_any_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ out, int rows, int c,
                         float eps) {
  const int lane = threadIdx.x & 31;
  const float fc = static_cast<float>(c);
  const long stride = static_cast<long>(gridDim.x) * kWarps;
  for (long row = static_cast<long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x; row < rows;
       row += stride) {
    const T* xr = x + row * c;
    float s = 0.f;
    for (int i = lane; i < c; i += 32) s += to_f<T>(xr[i]);
    const float mean = group_sum(s, 32) / fc;
    float q = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float d = to_f<T>(xr[i]) - mean;
      q += d * d;
    }
    const float rstd = 1.0f / sqrtf(group_sum(q, 32) / fc + eps);
    for (int i = lane; i < c; i += 32)
      out[row * c + i] = from_f<T>((to_f<T>(xr[i]) - mean) * rstd * w[i] + b[i]);
  }
}

template <typename T, int N>
cudaError_t launch_chunks(const void* x, const float* w, const float* b, void* out, int rows,
                          int c, int group, int ctas, float eps, cudaStream_t s) {
  layernorm_kernel<T, N><<<ctas, kThreads, 0, s>>>(static_cast<const T*>(x), w, b,
                                                   static_cast<T*>(out), rows, c, group, eps);
  return cudaGetLastError();
}

// one instance for each count of chunks a lane holds (the `case` labels are
// ops/layernorm.py::LANE_CHUNKS)
template <typename T>
cudaError_t launch_typed(const void* x, const float* w, const float* b, void* out, int rows,
                         int c, int group, int lane_chunks, int ctas, float eps,
                         cudaStream_t s) {
  switch (lane_chunks) {
    case 0:
      layernorm_any_kernel<T><<<ctas, kThreads, 0, s>>>(
          static_cast<const T*>(x), w, b, static_cast<T*>(out), rows, c, eps);
      return cudaGetLastError();
    case 1: return launch_chunks<T, 1>(x, w, b, out, rows, c, group, ctas, eps, s);
    case 2: return launch_chunks<T, 2>(x, w, b, out, rows, c, group, ctas, eps, s);
    case 3: return launch_chunks<T, 3>(x, w, b, out, rows, c, group, ctas, eps, s);
    case 4: return launch_chunks<T, 4>(x, w, b, out, rows, c, group, ctas, eps, s);
    case 6: return launch_chunks<T, 6>(x, w, b, out, rows, c, group, ctas, eps, s);
    case 8: return launch_chunks<T, 8>(x, w, b, out, rows, c, group, ctas, eps, s);
    case 12: return launch_chunks<T, 12>(x, w, b, out, rows, c, group, ctas, eps, s);
    case 16: return launch_chunks<T, 16>(x, w, b, out, rows, c, group, ctas, eps, s);
    case 24: return launch_chunks<T, 24>(x, w, b, out, rows, c, group, ctas, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch comes from ops/layernorm.py::layernorm_plan: `lane_chunks` N of
// the table (0: layernorm_any_kernel), lane groups of `group`, `ctas` CTAs.
// x and out (rows, c) of `dtype`, w and b (c) fp32; with N > 0 every pointer
// is 16-byte aligned and c a whole number of 16-byte chunks.
extern "C" int layernorm_launch(const void* x, const void* w, const void* b, void* out,
                                int rows, int c, int group, int lane_chunks, int ctas,
                                float eps, int dtype, void* stream) {
  if (rows <= 0 || c <= 0 || ctas <= 0 || group <= 0 || group > 32 || (group & (group - 1)))
    return cudaErrorInvalidValue;
  const int vec = dtype == kFloat32 ? 4 : 8;
  if (lane_chunks > 0 &&
      (c % vec || group * lane_chunks < c / vec ||
       ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
         reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out)) & 15)))
    return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_typed<float>(x, wf, bf, out, rows, c, group, lane_chunks, ctas, eps, s);
  if (dtype == kBFloat16)
    return launch_typed<__nv_bfloat16>(x, wf, bf, out, rows, c, group, lane_chunks, ctas, eps,
                                       s);
  return cudaErrorInvalidValue;
}
