// K3: top-k (k <= 8) over wide rows of log-probs, the beam-search candidate
// stage.
//
// Replaces on_device_image_captioning_tpu/ops/topk.py::topk_pallas.
// Contract (kept exactly): output sorted by value descending, ties to the
// lowest index; picks are distinct, so rows with fewer than k finite values
// return distinct ascending indices for the -inf tail; with L the last NaN
// index of a row, the first min(k, L + 1) picks are indices 0, 1, ... with
// value NaN (the Pallas kernel's max propagates NaN and its fallback takes the
// lowest unchosen index), and any further picks are the top of the indices > L
// in the (value desc, index asc) order.
//
// Bound on the H100: latency. A (24, 10000) fp32 input is 960 KB, 0.29 us of
// HBM time; what costs is the launch, one dependent load and the merges.
//
// Design: one read of the row and one launch, exact by construction.
//   - A row is one cluster of `cluster` CTAs (ops/topk.py::topk_plan: as many
//     as bring rows x cluster to a wave of the card, at most one 16-byte vector
//     a thread short of none). CTA r of the cluster scans the r-th contiguous
//     share of the row's 16-byte vectors, its threads strided over the share;
//     the unaligned head and tail (fewer than 8 values each) go to rank 0's
//     threads 0, 1, ... one value each.
//   - Each thread keeps, in registers, a sorted list of its top KP (k rounded
//     up to a power of two) non-NaN (value, index) pairs and the largest NaN
//     index it saw. That is enough: the row's top picks among the indices > L
//     are always inside the row's top k non-NaN pairs, because at most L + 1
//     of those lie at indices <= L.
//   - Merges in a fixed tree: the warp's lists by xor shuffles (every lane ends
//     with the merged list: the top KP of two sorted lists is the elementwise
//     best of one against the other reversed, a bitonic sequence that KP / 2,
//     KP / 4, ... half-cleaners sort), the CTA's warps through shared memory,
//     then the cluster's CTAs through distributed shared memory on rank 0's
//     first warp, whose lane 0 shares the result with the warp's lanes; lane
//     j applies the NaN rule and writes pick j.
//   - (value desc, index asc) is a strict total order on a row's pairs, so
//     the result is the same whatever the merge order, and two launches agree
//     bit for bit. No atomics, no second pass.
#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // CTAs a row; above 8 a non-portable cluster size
constexpr int kNone = INT_MAX;   // the index of an empty slot: after every real pair
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// a sorted (best first) list of KP (value, index) pairs in registers: every
// index into v and i is a compile-time constant once unrolled
template <int KP>
struct List {
  float v[KP];
  int i[KP];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      v[j] = -CUDART_INF_F;
      i[j] = kNone;
    }
  }

  __device__ __forceinline__ void swap_if_better(int a, int b) {  // keeps a before b
    if (better(v[b], i[b], v[a], i[a])) {
      const float tv = v[a];
      const int ti = i[a];
      v[a] = v[b];
      i[a] = i[b];
      v[b] = tv;
      i[b] = ti;
    }
  }

  __device__ __forceinline__ void insert(float x, int ix) {
    if (!better(x, ix, v[KP - 1], i[KP - 1])) return;
    v[KP - 1] = x;
    i[KP - 1] = ix;
#pragma unroll
    for (int j = KP - 1; j > 0; --j) swap_if_better(j - 1, j);
  }

  // the top KP of this list and another sorted one (ov, oi)
  __device__ __forceinline__ void merge(const float* ov, const int* oi) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (better(ov[KP - 1 - j], oi[KP - 1 - j], v[j], i[j])) {
        v[j] = ov[KP - 1 - j];
        i[j] = oi[KP - 1 - j];
      }
    }
#pragma unroll
    for (int s = KP / 2; s > 0; s /= 2) {
#pragma unroll
      for (int j = 0; j < KP; ++j)
        if ((j & s) == 0) swap_if_better(j, j + s);
    }
  }

  // merged with the list of the lane `off` away: both lanes end with the same list
  __device__ __forceinline__ void merge_lane(int off) {
    float ov[KP];
    int oi[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      ov[j] = __shfl_xor_sync(kFull, v[j], off);
      oi[j] = __shfl_xor_sync(kFull, i[j], off);
    }
    merge(ov, oi);
  }

  __device__ __forceinline__ void broadcast() {  // lane 0's list to every lane
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      v[j] = __shfl_sync(kFull, v[j], 0);
      i[j] = __shfl_sync(kFull, i[j], 0);
    }
  }

  __device__ __forceinline__ void load(const float* sv, const int* si) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      v[j] = sv[j];
      i[j] = si[j];
    }
  }

  __device__ __forceinline__ void store(float* sv, int* si) const {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      sv[j] = v[j];
      si[j] = i[j];
    }
  }
};

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kValues = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kValues = 8;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[2 * q] = __uint_as_float(w[q] << 16);  // the lower address holds the lower half
      f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
};

template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const T* __restrict__ x, T* __restrict__ vals, int* __restrict__ idx, int V,
                int k) {
  constexpr int P = Vec<T>::kValues;
  constexpr int kLoads = 4;  // vectors a thread loads before it scans them
  __shared__ float warp_v[kWarps][KP];
  __shared__ int warp_i[kWarps][KP];
  __shared__ int warp_nan[kWarps];
  __shared__ float cta_v[KP];  // the CTA's list, read by rank 0
  __shared__ int cta_i[KP];
  __shared__ int cta_nan;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long row = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + row * V;
  // the row's split, as ops/topk.py::topk_owners states it
  const int head = static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u) / sizeof(T));
  const int nvec = (V - head) / P, tail0 = head + nvec * P;
  const int per = (nvec + cs - 1) / cs;
  const int v0 = min(rank * per, nvec), v1 = min(v0 + per, nvec);

  List<KP> list;
  list.clear();
  int nan_last = -1;
  if (rank == 0 && tid < head) {
    const float f = to_f<T>(xr[tid]);
    if (isnan(f)) nan_last = tid;
    else list.insert(f, tid);
  }
  const uint4* body = reinterpret_cast<const uint4*>(xr + head);
  for (int base = v0 + tid; base < v1; base += kLoads * kThreads) {
    uint4 u[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = base + q * kThreads;
      if (j < v1) u[q] = __ldg(body + j);
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = base + q * kThreads;
      if (j >= v1) break;
      float f[P];
      Vec<T>::unpack(u[q], f);
#pragma unroll
      for (int e = 0; e < P; ++e) {
        const int ix = head + j * P + e;
        if (isnan(f[e])) nan_last = ix;  // ix ascends within a thread
        else list.insert(f[e], ix);
      }
    }
  }
  if (rank == 0 && tid < V - tail0) {
    const int ix = tail0 + tid;
    const float f = to_f<T>(xr[ix]);
    if (isnan(f)) nan_last = ix;
    else list.insert(f, ix);
  }

  // the warp's lists, then the CTA's warps
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    list.merge_lane(off);
    nan_last = max(nan_last, __shfl_xor_sync(kFull, nan_last, off));
  }
  if (lane == 0) {
    list.store(warp_v[warp], warp_i[warp]);
    warp_nan[warp] = nan_last;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < kWarps) {
      list.load(warp_v[lane], warp_i[lane]);
      nan_last = warp_nan[lane];
    } else {
      list.clear();
      nan_last = -1;
    }
#pragma unroll
    for (int off = 1; off < kWarps; off *= 2) {
      list.merge_lane(off);
      nan_last = max(nan_last, __shfl_xor_sync(kFull, nan_last, off));
    }
    if (lane == 0) {
      list.store(cta_v, cta_i);
      cta_nan = nan_last;
    }
  }
  cluster.sync();  // every CTA's list is written

  // the cluster's CTAs on rank 0's first warp; the NaN rule; the k picks
  if (rank == 0 && warp == 0) {
    if (lane < cs) {
      list.load(cluster.map_shared_rank(cta_v, lane), cluster.map_shared_rank(cta_i, lane));
      nan_last = *cluster.map_shared_rank(&cta_nan, lane);
    } else {
      list.clear();
      nan_last = -1;
    }
    for (int off = 1; off < cs; off *= 2) {
      list.merge_lane(off);
      nan_last = max(nan_last, __shfl_xor_sync(kFull, nan_last, off));
    }
    list.broadcast();  // lanes at and past cs hold no CTA's list: lane 0's to all
    nan_last = __shfl_sync(kFull, nan_last, 0);
    if (lane < k) {
      const int n_nan = min(k, nan_last + 1);
      float v = CUDART_NAN_F;
      int ix = lane;
      if (lane >= n_nan) {  // the (lane - n_nan)-th pair past the last NaN
        int seen = 0;
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          if (list.i[j] > nan_last) {
            if (seen == lane - n_nan) {
              v = list.v[j];
              ix = list.i[j];
            }
            ++seen;
          }
        }
      }
      idx[row * k + lane] = ix;
      vals[row * k + lane] = from_f<T>(v);
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its list
}

template <typename T, int KP>
cudaError_t launch_typed(const void* x, void* vals, void* idx, int rows, int V, int k,
                         int cluster, cudaStream_t stream) {
  // allowed once: a cluster of more than 8 CTAs is a non-portable size
  static const cudaError_t allowed = cudaFuncSetAttribute(
      topk_kernel<T, KP>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows) * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, topk_kernel<T, KP>, static_cast<const T*>(x), static_cast<T*>(vals),
      static_cast<int*>(idx), V, k);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, void* vals, void* idx, int rows, int V, int k, int cluster,
                     cudaStream_t s) {
  if (k <= 1) return launch_typed<T, 1>(x, vals, idx, rows, V, k, cluster, s);
  if (k <= 2) return launch_typed<T, 2>(x, vals, idx, rows, V, k, cluster, s);
  if (k <= 4) return launch_typed<T, 4>(x, vals, idx, rows, V, k, cluster, s);
  return launch_typed<T, 8>(x, vals, idx, rows, V, k, cluster, s);
}

}  // namespace

// `cluster` CTAs a row, from ops/topk.py::topk_plan (a power of two up to
// kMaxCluster, each CTA with at least one vector of the row to scan).
extern "C" int topk_launch(const void* x, void* vals, void* idx, int rows, int V, int k,
                           int cluster, int dtype, void* stream) {
  if (k < 1 || k > kMaxK || V < k || rows < 1 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_k<float>(x, vals, idx, rows, V, k, cluster, s);
  if (dtype == kBFloat16)
    return launch_k<__nv_bfloat16>(x, vals, idx, rows, V, k, cluster, s);
  return cudaErrorInvalidValue;
}
