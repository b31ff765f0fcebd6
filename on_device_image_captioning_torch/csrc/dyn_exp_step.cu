// K2: one decode position of Dynamic Expansion for one decoder layer, with
// the beam reorder fused into the cache reads.
//
// Replaces on_device_image_captioning_tpu/ops/dyn_exp_step.py::
// dyn_exp_step_pallas (`_dyn_core`). For output row i, continuing source
// cache row r = reorder[i]:
//   1. dst caches of row i = src caches of row r, with the rows at `pos`
//      replaced by k_i / ca_i / cb_i / cond_i (every position is written);
//   2. forward: z[e, l] = q_i[e] . keys[l] / sqrt(d) over l <= pos; ReLU(+-z)
//      L1-normalized over l (eps); vals_a[pos, e] = round(sum_l a[e,l] ca[l]
//      + bias_i[e]), vals_b likewise with cb;
//   3. backward: z[l, e] = (k_i . cond[l] + k_i . embed[e]) / sqrt(d) over
//      l <= pos and all e; ReLU(+-z) L1-normalized over all (l, e);
//      out_a = sum a[l,e] vals_a[l,e], out_b likewise;
//   4. out[i] = sel * out_a + (1 - sel) * out_b   (fp32).
// Normalizers, scores and accumulations are fp32; the normalized weights and
// the new vals rows are rounded through the cache dtype where `_dyn_core`
// rounds them. src and dst must not overlap: a row of one launch may still be
// read by another row (beam duplication), so the caller ping-pongs two sets.
//
// B16: the same step with the decoder layer's cross-attention behind it, in
// the same launch. Replaces ops/dyn_exp_step.py::dyn_exp_cross_step_pallas
// (`_cross_tail`): y1 = y + out; x2 = LN2(y1); q = x2 Wq + bq; per head the
// scores of q against the image's cached K (S, d) / sqrt(dk), pad positions
// set to attn_fill, softmax over S, . V; y_out = y1 + (o Wo + bo). Row i reads
// image row i / group of K, V and the pad mask. Roundings follow
// `_cross_tail`: x2, q, the attention weights, o and the out_linear product
// are rounded through the storage type (the kernel is built for compute type
// == cache type); statistics, softmax and sums fp32.
//
// Bound on the H100: bytes. Each row streams its two (L, E, d) vals caches
// and its four (L, d) caches in and out: 2 x 2 x 74 x 16 x 512 x 2 B + 4 x 2
// x 74 x 512 x 2 B = 5.5 MB a row at L = 74 in bf16 (27.5 MB at b1 / beam 5:
// 8.2 us at 3.35 TB/s). B16 adds Wq and Wo (d x d each, 0.5 MB apiece in
// bf16, L2-resident across rows) and the image's K and V (S x d each). The
// scores are E P + P + E dot products of length d (1274 at pos 73): small.
//
// Design. The grid is (kCluster x clusters, rows): clusters of kCluster CTAs,
// as many a row as one wave of CTAs holds (`step_plan` in ops/dyn_exp_step.py
// makes the plan and the shared-memory layout; the launcher takes both). With
// one a row (24 rows and more) it does all of the row. With more, the row's
// first two clusters, the scorers, each take half of the E rows of q_i and
// form their forward scores and new vals rows; the others take the L
// positions in chunks (240 CTAs at 5 rows / L74: 2 scorers, 4 chunks of 19).
// What each of the four causes of the first kernel's time became:
//   - Too few CTAs (d / 64 a row): each chunk's cluster copies and contracts
//     its positions of all six caches; the row's clusters' partial sums meet
//     in device memory, and the row's last cluster to arrive (an int counter,
//     left at zero) adds them in cluster order.
//   - Scores recomputed by every CTA of a row: a cluster splits its dot
//     products over its 8 x 8 warps in 16-byte loads (the key or k_i in
//     registers, two rows in flight a warp, four sums reduced together) and
//     each CTA gathers the others' through distributed shared memory. The E P
//     forward scores, which only the new vals rows need, are formed once a
//     row, by the scorers; the P + E backward scores once a cluster, because
//     every chunk's weights need the row's normalizer before its contraction
//     and clusters cannot wait on one another inside a launch. Each CTA sums
//     the normalizers in the same fixed order, so all CTAs hold the same bits.
//   - A latency-bound cache stream: a thread moves 16 bytes (8 bf16 or 4
//     fp32) per load and store and issues kBatch rows' loads of both
//     vals caches before their stores; src / dst are __restrict__ and read
//     through the non-coherent path; the ca / cb columns the new rows need
//     are staged in shared memory by cp.async while the scores are formed.
//   - B16's tail on one CTA after a counter: it runs on the row's last
//     cluster, CTA k on its d / kCluster columns (heads / kCluster heads):
//     q_h, the scores over S, softmax . V_h, then o gathered through
//     distributed shared memory and CTA k's columns of o Wo + bo + y1. Wq and
//     Wo are read once a row, in 64-column slices. LN2's statistics are
//     per-CTA means and sums of squares combined in rank order.
// Every partial sum meets the others in a fixed order (thread rows, the CTA's
// row groups, the cluster's CTAs in rank order, the row's clusters in order):
// no floating-point atomics, so two launches on the same inputs give the same
// bits.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs of a cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;    // 16-byte chunks (or vals rows) a thread loads before it stores
constexpr int kPerSm = 2;    // CTAs an SM holds (registers: at most 128 a thread)
constexpr int kMaxD = 512;   // widest d: a lane holds its 16 values of a row in registers
constexpr int kMaxShared = 232448;  // dynamic shared bytes a CTA may hold on the H100

struct Args {
  const int* reorder;
  const void *q_i, *bias_i, *k_i, *ca_i, *cb_i, *cond_i;
  const float* sel;
  const void* embed;
  const void *src_keys, *src_ca, *src_cb, *src_cond, *src_va, *src_vb;
  void *dst_keys, *dst_ca, *dst_cb, *dst_cond, *dst_va, *dst_vb;
  float* out;  // (rows, d) fp32 (K2); null for B16
  float* part;  // (rows, chunks, 2, d) fp32: the chunks' partial sums
  int* counter;  // (rows): clusters arrived, 0 at launch and again at exit
  int L, E, d, pos, per, scorers;  // per: positions of a chunk; scorers: clusters that score
  int r1, r2;                      // floats of the two shared regions phases take in turn
  float sqrt_d, eps;
  // the cross-attention tail (B16); y == nullptr: none
  const float *y, *ln_g, *ln_b;
  const void *wq, *wo;        // (d, d) as (in, out), storage type
  const float *bq, *bo;
  const void *k_cross, *v_cross;  // (B_img, S, d), storage type
  const float* enc_mask;      // (B_img, S), > 0 where the token is real, or null
  float* y_out;               // (B, d)
  int S, heads, group;
  float ln_eps, attn_fill;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum of v over the block; every thread gets the result
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 lds16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st16(void* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int j) {
  return to_f<T>(reinterpret_cast<const T*>(&v)[j]);
}

// Asynchronous copies into shared memory (no registers held while they fly)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `kPending` of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// rows x (cols / V) 16-byte chunks of a row-major (ld) matrix into dense smem
template <typename T>
__device__ __forceinline__ void cp_async_block(T* dst, const T* src, int rows, int cols, long ld) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cols / V;
  for (int it = threadIdx.x; it < rows * per_row; it += kThreads)
    cp_async16(dst + (it / per_row) * cols + (it % per_row) * V,
               src + (it / per_row) * ld + (it % per_row) * V);
}

// The cluster barrier in two halves: work between them overlaps the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// res[c] = sum_{k < K} coef(k, c) w[k * ld + c] for the ncols columns of w:
// thread (part, group) sums its share of k for the V columns of its 16-byte
// chunk, whose coefficient coef(k, first column of the chunk) they share, with
// 16 loads in flight; the first kPre rows of its share may already be in
// `pre` (slice_preload, issued before the coefficients were known). The parts
// of a column meet in `part`, then kThreads / ncols neighbouring lanes add
// them in a fixed order.
template <typename T>
__device__ __forceinline__ void slice_share(int K, int ncols, int& k0, int& k_end, int& c0) {
  constexpr int V = 16 / sizeof(T);
  const int groups = ncols / V, parts = kThreads / groups;
  const int pt = threadIdx.x / groups;
  c0 = (threadIdx.x % groups) * V;
  k0 = pt * cdiv(K, parts);
  k_end = min(K, k0 + cdiv(K, parts));
}

template <typename T, int kPre>
__device__ __forceinline__ void slice_preload(const T* __restrict__ w, int K, int ld, int ncols,
                                              uint4 (&pre)[kPre > 0 ? kPre : 1]) {
  int k0, k_end, c0;
  slice_share<T>(K, ncols, k0, k_end, c0);
#pragma unroll
  for (int u = 0; u < kPre; ++u)
    if (k0 + u < k_end) pre[u] = ld16(w + (long)(k0 + u) * ld + c0);
}

template <typename T, int kPre, typename Coef>
__device__ __forceinline__ void slice_product(Coef coef, const T* __restrict__ w, int K, int ld,
                                              int ncols, const uint4 (&pre)[kPre > 0 ? kPre : 1],
                                              float* part, float* res) {
  constexpr int V = 16 / sizeof(T);
  const int parts = kThreads / (ncols / V);
  int k0, k_end, c0;
  slice_share<T>(K, ncols, k0, k_end, c0);
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
  for (int u = 0; u < kPre; ++u)
    if (k0 + u < k_end) {
      const float xk = coef(k0 + u, c0);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(xk, elem<T>(pre[u], j), acc[j]);
    }
#pragma unroll 16
  for (int k = k0 + kPre; k < k_end; ++k) {
    const uint4 raw = ld16(w + (long)k * ld + c0);
    const float xk = coef(k, c0);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = fmaf(xk, elem<T>(raw, j), acc[j]);
  }
  const int pt = threadIdx.x / (ncols / V);
#pragma unroll
  for (int j = 0; j < V; ++j) part[pt * ncols + c0 + j] = acc[j];
  __syncthreads();
  const int per_col = kThreads / ncols, c = threadIdx.x / per_col, r = threadIdx.x % per_col;
  float sum = 0.f;
  for (int q = r; q < parts; q += per_col) sum += part[q * ncols + c];
  for (int m = 1; m < per_col; m *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (r == 0) res[c] = sum;
  __syncthreads();
}

// Copies positions [l0, l1) of the four (L, d) cache rows (the rows at pos
// from `now`), this thread's share of the cluster's kCluster x kThreads
// threads, kBatch chunks' loads before their stores.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* const (&src)[4], const T* const (&now)[4],
                                          T* const (&dst)[4], int l0, int l1, int pos, int d,
                                          int ct) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = d / V, per_cache = (l1 - l0) * vpr, n = 4 * per_cache;
  constexpr int kStride = kCluster * kThreads;
  for (int base = ct; base < n; base += kBatch * kStride) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = base + u * kStride;
      if (it < n) {
        const int w = it / per_cache, l = l0 + (it % per_cache) / vpr, c = (it % vpr) * V;
        v[u] = ld16(l == pos ? now[w] + c : src[w] + (long)l * d + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = base + u * kStride;
      if (it < n) {
        const int w = it / per_cache, l = l0 + (it % per_cache) / vpr;
        st16(dst[w] + (long)l * d + (it % vpr) * V, v[u]);
      }
    }
  }
}

// The vals stream of one CTA: (l, e) rows [q0, q1) of both vals caches, the
// rows at pos skipped (the row's first cluster writes them), copied to dst;
// the rows l < pos also summed with their backward weights into acc_a /
// acc_b (the thread's V columns). Thread (row group rg, chunk vv) takes rows
// q0 + rg, q0 + rg + nrg, ..., kBatch rows' loads before their stores.
template <typename T>
__device__ __forceinline__ void stream_vals(
    const T* __restrict__ sa, const T* __restrict__ sb, T* __restrict__ da, T* __restrict__ db,
    int q0, int q1, int pos, int E, int d, const float* zc, const float* ze, float sqrt_d,
    float suma, float sumb, float* acc_a, float* acc_b) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = d / V, nrg = kThreads / vpr;
  const int rg = threadIdx.x / vpr, col = (threadIdx.x % vpr) * V;
  for (int base = q0 + rg; base < q1; base += kBatch * nrg) {
    uint4 va[kBatch], vb[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = base + u * nrg;
      if (p < q1 && p / E != pos) {
        va[u] = ld16(sa + (long)p * d + col);
        vb[u] = ld16(sb + (long)p * d + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = base + u * nrg, l = p / E;
      if (p >= q1 || l == pos) continue;
      st16(da + (long)p * d + col, va[u]);
      st16(db + (long)p * d + col, vb[u]);
      if (l < pos) {
        const float z = (zc[l] + ze[p % E]) / sqrt_d;
        const float wa = round_t<T>(fmaxf(z, 0.f) / suma);
        const float wb = round_t<T>(fmaxf(-z, 0.f) / sumb);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc_a[j] = fmaf(wa, elem<T>(va[u], j), acc_a[j]);
          acc_b[j] = fmaf(wb, elem<T>(vb[u], j), acc_b[j]);
        }
      }
    }
  }
}

// Four lane sums v[0..4) of a warp reduced over its 32 lanes with 6
// shuffles: two exchange-halves steps, then three adds; every lane ends with
// the sum of v[2 ((lane >> 4) & 1) + ((lane >> 3) & 1)].
__device__ __forceinline__ float warp_sum4(float (&v)[4], int lane) {
  const bool up16 = (lane & 16) != 0, up8 = (lane & 8) != 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = up16 ? v[j] : v[j + 2], keep = up16 ? v[j + 2] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  float z = (up8 ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, up8 ? v[0] : v[1], 8);
  z += __shfl_xor_sync(0xffffffffu, z, 4);
  z += __shfl_xor_sync(0xffffffffu, z, 2);
  return z + __shfl_xor_sync(0xffffffffu, z, 1);
}

// Lane's 16-byte chunks of two rows of d dotted: za = x . a, zb = x . b
// (partial sums of the lane; x in registers)
template <typename T, int LC>
__device__ __forceinline__ void lane_dots(const uint4 (&x)[LC], const uint4 (&ra)[LC],
                                          const uint4 (&rb)[LC], int lane, int vpr, float& za,
                                          float& zb) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < LC; ++u)
    if (lane + 32 * u < vpr) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        za = fmaf(elem<T>(x[u], j), elem<T>(ra[u], j), za);
        zb = fmaf(elem<T>(x[u], j), elem<T>(rb[u], j), zb);
      }
    }
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kPerSm)
    dyn_exp_step_kernel(const Args a) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LC = kMaxD / (32 * V);  // 16-byte chunks of a row of d a lane holds
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int L = a.L, E = a.E, d = a.d, pos = a.pos, P = a.pos + 1, S = a.S;
  const int i = blockIdx.y, chunk = blockIdx.x / kCluster, chunks = gridDim.x / kCluster;
  const int k = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cs = d / kCluster, c0 = k * cs;  // this CTA's columns (new rows, sums, tail)
  const int vpr = d / V, nrg = kThreads / vpr;
  const bool tail_on = a.y != nullptr;
  const bool whole = chunks == 1;  // one cluster does all of the row
  const int scorers = whole ? 1 : a.scorers;
  const bool scorer = chunk < scorers;  // forms forward scores and new vals rows
  const long r = a.reorder[i];
  int l0 = 0, l1 = L;  // this cluster's positions (none for a scorer of several)
  if (!whole) {
    l0 = scorer ? 0 : (chunk - scorers) * a.per;
    l1 = scorer ? 0 : min(L, (chunk - scorers + 1) * a.per);
  }
  // a scorer's rows of q_i: [e_lo, e_hi)
  const int e_per = cdiv(E, scorers);
  const int e_lo = scorer ? min(E, chunk * e_per) : 0, e_hi = scorer ? min(E, e_lo + e_per) : 0;
  const int EL = e_hi - e_lo;

  // shared memory as ops/dyn_exp_step.py::step_plan lays it out
  float* r1 = smem;
  float* r2 = smem + a.r1;
  T* q_s = reinterpret_cast<T*>(r1);  // EL x d: a scorer's rows of q_i
  float* part = r1;                   // 2 x nrg x d
  float* ov = r1;                     // 2 x cs: this CTA's columns of out_a, out_b
  T* cab = reinterpret_cast<T*>(r2);  // 2 x L x cs: ca, cb of this CTA's columns
  T* bias_s = cab + 2 * L * cs;       // EL x cs: its rows of bias_i
  float* zc = r2 + a.r2;              // L: k_i . cond[l]
  float* ze = zc + L;                 // E: k_i . embed[e]
  float* zf = ze + E;                 // E x L forward scores
  float* afw = zf + E * L;            // E x L forward weights (+ side)
  float* bfw = afw + E * L;           // E x L forward weights (- side)
  float* newa = bfw + E * L;          // E x cs new vals_a rows of this CTA's columns
  float* newb = newa + E * cs;
  float* sums = newb + E * cs;        // 2 x d: the CTA's sums (a, then b)
  float* red = sums + 2 * d;          // 2 x kWarps block-reduction scratch
  int* last_flag = reinterpret_cast<int*>(red + 2 * kWarps);
  float* stat = red + 2 * kWarps + 4;  // 2: this CTA's LN2 mean and sum of squares
  float* wpos = red + 2 * kWarps + 8;  // 2 x E: backward weights of the row at pos

  const T* __restrict__ q_i = static_cast<const T*>(a.q_i) + (long)i * E * d;
  const T* __restrict__ bias_i = static_cast<const T*>(a.bias_i) + (long)i * E * d;
  const T* __restrict__ k_i = static_cast<const T*>(a.k_i) + (long)i * d;
  const T* __restrict__ ca_i = static_cast<const T*>(a.ca_i) + (long)i * d;
  const T* __restrict__ cb_i = static_cast<const T*>(a.cb_i) + (long)i * d;
  const T* __restrict__ cond_i = static_cast<const T*>(a.cond_i) + (long)i * d;
  const T* __restrict__ embed = static_cast<const T*>(a.embed);
  const T* __restrict__ s_keys = static_cast<const T*>(a.src_keys) + r * L * d;
  const T* __restrict__ s_ca = static_cast<const T*>(a.src_ca) + r * L * d;
  const T* __restrict__ s_cb = static_cast<const T*>(a.src_cb) + r * L * d;
  const T* __restrict__ s_cond = static_cast<const T*>(a.src_cond) + r * L * d;
  const T* __restrict__ s_va = static_cast<const T*>(a.src_va) + r * L * E * d;
  const T* __restrict__ s_vb = static_cast<const T*>(a.src_vb) + r * L * E * d;
  T* __restrict__ d_va = static_cast<T*>(a.dst_va) + (long)i * L * E * d;
  T* __restrict__ d_vb = static_cast<T*>(a.dst_vb) + (long)i * L * E * d;

  // ---- the scorer: q_i and its columns of ca, cb, bias_i on their way in ---
  if (scorer) {
    cp_async_block(q_s, q_i + (long)e_lo * d, EL, d, d);
    cp_async_commit();
    const int cvs = cs / V;
    for (int it = tid; it < 2 * P * cvs; it += kThreads) {
      const int side = it / (P * cvs), l = (it / cvs) % P, c = c0 + (it % cvs) * V;
      cp_async16(cab + ((long)side * L + l) * cs + (c - c0),
                 l == pos ? (side == 0 ? ca_i : cb_i) + c
                          : (side == 0 ? s_ca : s_cb) + (long)l * d + c);
    }
    cp_async_block(bias_s, bias_i + (long)e_lo * d + c0, EL, cs, d);
    cp_async_commit();
  }

  // ---- backward scores, in every cluster (each chunk's weights need the
  // row's normalizer): k_i . cond[l] and k_i . embed[e] split over the
  // cluster's 64 warps (item j on warp j % 64), k_i in registers and two
  // items' rows in flight a warp --------------------------------------------
  const int gw = k * kWarps + warp, n_warps = kCluster * kWarps;
  {
    uint4 kq[LC];
#pragma unroll
    for (int u = 0; u < LC; ++u)
      if (lane + 32 * u < vpr) kq[u] = ld16(k_i + (lane + 32 * u) * V);
    auto row_of = [&](int j) -> const T* {
      return j < P ? (j == pos ? cond_i : s_cond + (long)j * d) : embed + (long)(j - P) * d;
    };
    for (int j = gw; j < P + E; j += 2 * n_warps) {
      const int j2 = j + n_warps;
      const bool two = j2 < P + E;
      const T* ra = row_of(j);
      const T* rb = two ? row_of(j2) : ra;
      uint4 va[LC], vb[LC];
#pragma unroll
      for (int u = 0; u < LC; ++u)
        if (lane + 32 * u < vpr) {
          va[u] = ld16(ra + (lane + 32 * u) * V);
          vb[u] = ld16(rb + (lane + 32 * u) * V);
        }
      float za = 0.f, zb = 0.f;
      lane_dots<T, LC>(kq, va, vb, lane, vpr, za, zb);
      za = warp_sum(za);
      zb = warp_sum(zb);
      if (lane == 0) {
        if (j < P) zc[j] = za; else ze[j - P] = za;
        if (two) {
          if (j2 < P) zc[j2] = zb; else ze[j2 - P] = zb;
        }
      }
    }
  }

  // ---- forward scores, once a row, by the scorer: warp w takes the four
  // rows of q_i in group w % EG against the positions l = w / EG (mod n_pl),
  // two positions' keys in flight, the four sums reduced together -----------
  const int EG = cdiv(EL, 4), n_pl = max(1, n_warps / max(1, EG));
  if (scorer) {
    cp_async_wait<1>();  // q_i (the columns may still be on their way)
    __syncthreads();
    const int eg = gw % EG, pl = gw / EG;
    for (int l = pl; gw < EG * n_pl && l < P; l += 2 * n_pl) {
      const int l2 = l + n_pl;
      uint4 ka[LC], kb[LC];
      const T* key_a = l == pos ? k_i : s_keys + (long)l * d;
      const T* key_b = l2 >= P ? key_a : l2 == pos ? k_i : s_keys + (long)l2 * d;
#pragma unroll
      for (int u = 0; u < LC; ++u)
        if (lane + 32 * u < vpr) {
          ka[u] = ld16(key_a + (lane + 32 * u) * V);
          kb[u] = ld16(key_b + (lane + 32 * u) * V);
        }
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (side == 1 && l2 >= P) break;
        float v[4];
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) {
          float z = 0.f;
          if (4 * eg + ee < EL) {
#pragma unroll
            for (int u = 0; u < LC; ++u)
              if (lane + 32 * u < vpr) {
                const uint4 qv = lds16(q_s + (4 * eg + ee) * d + (lane + 32 * u) * V);
                const uint4 kv = side == 0 ? ka[u] : kb[u];
#pragma unroll
                for (int j = 0; j < V; ++j) z = fmaf(elem<T>(qv, j), elem<T>(kv, j), z);
              }
          }
          v[ee] = z;
        }
        const float z = warp_sum4(v, lane);
        const int e = e_lo + 4 * eg + 2 * ((lane >> 4) & 1) + ((lane >> 3) & 1);
        if ((lane & 7) == 0 && e < e_hi) zf[e * L + (side == 0 ? l : l2)] = z / a.sqrt_d;
      }
    }
  }

  // ---- the four (L, d) caches at this cluster's positions, while the
  // cluster's barrier completes ------------------------------------------------
  cluster_arrive();
  {
    const T* const src4[4] = {s_keys, s_ca, s_cb, s_cond};
    const T* const now4[4] = {k_i, ca_i, cb_i, cond_i};
    T* const dst4[4] = {static_cast<T*>(a.dst_keys) + (long)i * L * d,
                        static_cast<T*>(a.dst_ca) + (long)i * L * d,
                        static_cast<T*>(a.dst_cb) + (long)i * L * d,
                        static_cast<T*>(a.dst_cond) + (long)i * L * d};
    copy_rows<T>(src4, now4, dst4, l0, l1, pos, d, k * kThreads + tid);
  }
  cluster_wait();

  // gather the other CTAs' scores
#pragma unroll 4
  for (int j = tid; j < P + E; j += kThreads) {
    const int owner = (j % n_warps) / kWarps;
    if (owner == k) continue;
    if (j < P)
      zc[j] = *cluster.map_shared_rank(zc + j, owner);
    else
      ze[j - P] = *cluster.map_shared_rank(ze + (j - P), owner);
  }
  if (scorer) {
#pragma unroll 4
    for (int it = tid; it < EL * P; it += kThreads) {
      const int e = e_lo + it / P, l = it % P;
      const int owner = ((e - e_lo) / 4 + EG * (l % n_pl)) / kWarps;
      if (owner != k) zf[e * L + l] = *cluster.map_shared_rank(zf + e * L + l, owner);
    }
  }
  __syncthreads();

  // backward normalizers: L1 over all (l <= pos, e), the same bits in every CTA
  float pa = 0.f, pb = 0.f;
  for (int it = tid; it < P * E; it += kThreads) {
    const float z = (zc[it / E] + ze[it % E]) / a.sqrt_d;
    pa += fmaxf(z, 0.f);
    pb += fmaxf(-z, 0.f);
  }
  const float suma = block_sum(pa, red) + a.eps;
  const float sumb = block_sum(pb, red + kWarps) + a.eps;

  if (scorer) {
    // forward weights: L1 over l <= pos for each e (a warp per e); the
    // backward weights of the row at pos
    for (int e = e_lo + warp; e < e_hi; e += kWarps) {
      float sa = 0.f, sb = 0.f;
      for (int l = lane; l < P; l += 32) {
        const float z = zf[e * L + l];
        sa += fmaxf(z, 0.f);
        sb += fmaxf(-z, 0.f);
      }
      sa = warp_sum(sa) + a.eps;
      sb = warp_sum(sb) + a.eps;
      for (int l = lane; l < P; l += 32) {
        const float z = zf[e * L + l];
        afw[e * L + l] = round_t<T>(fmaxf(z, 0.f) / sa);
        bfw[e * L + l] = round_t<T>(fmaxf(-z, 0.f) / sb);
      }
      if (lane == 0) {
        const float z = (zc[pos] + ze[e]) / a.sqrt_d;
        wpos[e] = round_t<T>(fmaxf(z, 0.f) / suma);
        wpos[E + e] = round_t<T>(fmaxf(-z, 0.f) / sumb);
      }
    }
    cp_async_wait_all();  // the columns of ca, cb and bias_i
    __syncthreads();
    // the new vals rows at pos for this CTA's columns: thread (item, lq),
    // item = (side, group of 4 e, 16-byte chunk), sums every nq-th staged
    // position for the group's four rows; the nq sums of an item (neighbouring
    // lanes) meet by shuffles in a fixed order
    const int cvs = cs / V, items = 2 * EG * cvs;  // (over this scorer's rows)
    int nq = 1;
    while (nq < 8 && 2 * nq * items <= kThreads) nq *= 2;
    for (int base = 0; base < items * nq; base += kThreads) {
      const int t = base + tid, item = t / nq, lq = t % nq;
      const bool on = item < items;
      const int side = item / (EG * cvs), eg = (item / cvs) % EG, cc = (item % cvs) * V;
      float acc[4][V];
#pragma unroll
      for (int ee = 0; ee < 4; ++ee)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[ee][j] = 0.f;
      if (on) {
        const float* w = side == 0 ? afw : bfw;
        const T* cols = cab + (long)side * L * cs + cc;
        for (int l = lq; l < P; l += nq) {
          const uint4 raw = lds16(cols + l * cs);
#pragma unroll
          for (int ee = 0; ee < 4; ++ee) {
            const float wl = 4 * eg + ee < EL ? w[(e_lo + 4 * eg + ee) * L + l] : 0.f;
#pragma unroll
            for (int j = 0; j < V; ++j) acc[ee][j] = fmaf(wl, elem<T>(raw, j), acc[ee][j]);
          }
        }
      }
      for (int m = 1; m < nq; m *= 2)
#pragma unroll
        for (int ee = 0; ee < 4; ++ee)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[ee][j] += __shfl_xor_sync(0xffffffffu, acc[ee][j], m);
      if (on && lq == 0) {
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) {
          const int e = e_lo + 4 * eg + ee;
          if (e >= e_hi) break;
          const uint4 braw = lds16(bias_s + (e - e_lo) * cs + cc);
          uint4 out;
          T* o = reinterpret_cast<T*>(&out);
          float* keep = (side == 0 ? newa : newb) + e * cs + cc;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            o[j] = from_f<T>(acc[ee][j] + elem<T>(braw, j));
            keep[j] = to_f<T>(o[j]);
          }
          st16((side == 0 ? d_va : d_vb) + ((long)pos * E + e) * d + c0 + cc, out);
        }
      }
    }
  }
  __syncthreads();  // q_s and the staged columns are read: both regions are free

  // ---- the stream: this cluster's rows copied, its rows l < pos contracted --
  float acc_a[V], acc_b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc_a[j] = acc_b[j] = 0.f;
  {
    const int n = (l1 - l0) * E, share = cdiv(n, kCluster);
    const int q0 = l0 * E + k * share, q1 = min(l1 * E, q0 + share);
    stream_vals<T>(s_va, s_vb, d_va, d_vb, q0, q1, pos, E, d, zc, ze, a.sqrt_d, suma, sumb,
                   acc_a, acc_b);
  }
  {
    const int rg = tid / vpr, col = (tid % vpr) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part[rg * d + col + j] = acc_a[j];
      part[(nrg + rg) * d + col + j] = acc_b[j];
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * d; c += kThreads) {
    const int side = c / d, cc = c % d;
    float s = 0.f;
    for (int g = 0; g < nrg; ++g) s += part[(side * nrg + g) * d + cc];
    sums[c] = s;
  }
  cluster.sync();

  // ---- this CTA's columns: the cluster's CTAs in rank order (the scorer:
  // then the row at pos), then the row's clusters in order --------------------
  float* pg = a.part + (long)i * chunks * 2 * d;  // (chunks, 2, d) partial sums of row i
  for (int it = tid; it < 2 * cs; it += kThreads) {
    const int side = it / cs, c = it % cs;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(sums, q)[side * d + c0 + c];
    if (scorer) {
      const float* nv = (side == 0 ? newa : newb) + c;
      for (int e = e_lo; e < e_hi; ++e) s = fmaf(wpos[side * E + e], nv[e * cs], s);
    }
    if (whole)
      ov[it] = s;
    else
      pg[(long)chunk * 2 * d + side * d + c0 + c] = s;
  }
  if (!whole) __threadfence();
  // B16's row operands on their way while the clusters meet (d <= kMaxD:
  // at most kMaxD / kThreads columns of LN2 a thread)
  constexpr int kLnPer = kMaxD / kThreads;
  float y_r = 0.f, sel_r = 0.f, bq_r = 0.f, bo_r = 0.f, g_r[kLnPer], b_r[kLnPer];
  if (tail_on) {
    if (tid < cs) {
      y_r = a.y[(long)i * d + c0 + tid];
      sel_r = a.sel[(long)i * d + c0 + tid];
      bq_r = a.bq[c0 + tid];
      bo_r = a.bo[c0 + tid];
    }
#pragma unroll
    for (int j = 0; j < kLnPer; ++j)
      if (tid + j * kThreads < d) {
        g_r[j] = a.ln_g[tid + j * kThreads];
        b_r[j] = a.ln_b[tid + j * kThreads];
      }
  }
  cluster.sync();  // the sums are read (and the partial sums written)
  if (!whole) {
    // the row's last cluster to arrive adds the clusters' sums, in order
    if (k == 0 && tid == 0) {
      const int last = atomicAdd(a.counter + i, 1) == chunks - 1;
      if (last) a.counter[i] = 0;  // as it was at launch, for the next one
      for (int q = 0; q < kCluster; ++q) *cluster.map_shared_rank(last_flag, q) = last;
    }
    cluster.sync();
    if (!*last_flag) return;
    __threadfence();
    for (int it = tid; it < 2 * cs; it += kThreads) {
      const int side = it / cs, c = it % cs;
      float s = 0.f;
#pragma unroll 8
      for (int g = 0; g < chunks; ++g) s += __ldcg(pg + (long)g * 2 * d + side * d + c0 + c);
      ov[it] = s;
    }
    __syncthreads();
  }
  if (!tail_on) {
    for (int c = tid; c < cs; c += kThreads) {
      const float s = a.sel[(long)i * d + c0 + c];
      a.out[(long)i * d + c0 + c] = s * ov[c] + (1.f - s) * ov[cs + c];
    }
    return;
  }

  // ---- B16: the cross-attention tail, CTA k on columns [c0, c0 + cs) -------
  const int hk = a.heads / kCluster, dk = d / a.heads;
  const int parts = kThreads / (cs / V);
  float* y1 = ov + 2 * cs;   // d: y + out (own columns, then gathered)
  float* x2 = y1 + d;        // d: LN2(y1) rounded
  float* o = x2 + d;         // d: the attention output rounded (own, then gathered)
  float* q = o + d;          // cs: q of this CTA's heads
  float* mo = q + cs;        // cs: the V and out_linear products of this CTA's columns
  float* pp = mo + cs;       // parts x cs: the products' parts
  float* sc = pp + parts * cs;  // hk x S: scores, then attention weights

  // LN2's statistics: each CTA's mean and sum of squared deviations over its
  // columns, combined in rank order (Chan et al.'s pairwise update)
  float s = 0.f;
  if (tid < cs) {
    const float v = y_r + sel_r * ov[tid] + (1.f - sel_r) * ov[cs + tid];
    y1[c0 + tid] = v;
    s = v;
  }
  const float mean_k = block_sum(s, red) / cs;
  float sq = 0.f;
  for (int c = tid; c < cs; c += kThreads) {
    const float dl = y1[c0 + c] - mean_k;
    sq = fmaf(dl, dl, sq);
  }
  sq = block_sum(sq, red + kWarps);
  if (tid == 0) {
    stat[0] = mean_k;
    stat[1] = sq;
  }
  cluster.sync();
  float mean = 0.f, m2 = 0.f;
#pragma unroll
  for (int p = 0; p < kCluster; ++p) {
    const float* st = cluster.map_shared_rank(stat, p);
    const float mb = st[0], m2b = st[1];
    if (p == 0) {
      mean = mb;
      m2 = m2b;
    } else {
      const float na = (float)(p * cs), nn = na + cs, delta = mb - mean;
      mean += delta * cs / nn;
      m2 += m2b + delta * delta * na * cs / nn;
    }
  }
  const float rstd = rsqrtf(m2 / d + a.ln_eps);
  for (int c = tid; c < d; c += kThreads) {
    const int owner = c / cs;
    if (owner != k) y1[c] = *cluster.map_shared_rank(y1 + c, owner);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kLnPer; ++j) {
    const int c = tid + j * kThreads;
    if (c < d) x2[c] = round_t<T>((y1[c] - mean) * rstd * g_r[j] + b_r[j]);
  }
  __syncthreads();

  uint4 none[1];  // (no rows preloaded)
  slice_product<T, 0>([&](int kk, int) { return x2[kk]; }, static_cast<const T*>(a.wq) + c0, d,
                      d, cs, none, pp, q);
  if (tid < cs) q[tid] = round_t<T>(q[tid] + bq_r);
  __syncthreads();
  // this thread's first rows of the V columns on their way while the scores
  // and the softmax run
  const long img = i / a.group;
  const T* __restrict__ kc = static_cast<const T*>(a.k_cross) + img * S * d;
  const T* __restrict__ vc = static_cast<const T*>(a.v_cross) + img * S * d;
  constexpr int kPreV = 8;
  uint4 vpre[kPreV];
  slice_preload<T, kPreV>(vc + c0, S, d, cs, vpre);

  // scores: a thread per (token, head) reads the head's dk columns of the
  // token's K row in 16-byte chunks, all in flight
  const float sqrt_dk = sqrtf((float)dk);
  for (int item = tid; item < S * hk; item += kThreads) {
    const int t = item / hk, h = item % hk;
    const T* krow = kc + (long)t * d + c0 + h * dk;
    const float* qh = q + h * dk;
    const bool real = a.enc_mask == nullptr || a.enc_mask[img * S + t] > 0.f;
    float z = 0.f;
#pragma unroll 8
    for (int ch = 0; ch < dk / V; ++ch) {
      const uint4 raw = ld16(krow + ch * V);
#pragma unroll
      for (int j = 0; j < V; ++j) z = fmaf(elem<T>(raw, j), qh[ch * V + j], z);
    }
    sc[h * S + t] = real ? z / sqrt_dk : a.attn_fill;
  }
  __syncthreads();
  // softmax over the tokens: a warp per head
  for (int h = warp; h < hk; h += kWarps) {
    float mx = -CUDART_INF_F;
    for (int t = lane; t < S; t += 32) mx = fmaxf(mx, sc[h * S + t]);
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < S; t += 32) {
      const float e = expf(sc[h * S + t] - mx);
      sc[h * S + t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < S; t += 32) sc[h * S + t] = round_t<T>(sc[h * S + t] / sum);
  }
  __syncthreads();
  slice_product<T, kPreV>([&](int t, int c) { return sc[(c / dk) * S + t]; }, vc + c0, S, d,
                          cs, vpre, pp, mo);
  for (int c = tid; c < cs; c += kThreads) o[c0 + c] = round_t<T>(mo[c]);
  cluster.sync();
  for (int c = tid; c < d; c += kThreads) {
    const int owner = c / cs;
    if (owner != k) o[c] = *cluster.map_shared_rank(o + c, owner);
  }
  __syncthreads();
  slice_product<T, 0>([&](int kk, int) { return o[kk]; }, static_cast<const T*>(a.wo) + c0, d,
                      d, cs, none, pp, mo);
  if (tid < cs) a.y_out[(long)i * d + c0 + tid] = y1[c0 + tid] + round_t<T>(mo[tid] + bo_r);
  cluster.sync();  // y1, o and the statistics are read: no CTA leaves while another reads them
}

template <typename T>
static cudaError_t launch_typed(const Args& a, int rows, int chunks, int smem,
                                cudaStream_t stream) {
  // the kernel's ceiling on dynamic shared memory, raised once to all a CTA
  // may hold (each launch still asks for its own plan's bytes): the call
  // costs the host time on every launch otherwise
  static const cudaError_t raised = cudaFuncSetAttribute(
      dyn_exp_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (raised != cudaSuccess) return raised;
  dim3 grid(kCluster * chunks, rows);
  dyn_exp_step_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The step's operands as the kernel reads them (the tail's stay unset).
static Args step_args(const void* reorder, const void* q_i, const void* bias_i,
                      const void* k_i, const void* ca_i, const void* cb_i,
                      const void* cond_i, const void* sel, const void* embed,
                      const void* const* src, void* const* dst, void* out, void* part,
                      void* counter, int L, int E, int d, int pos, float sqrt_d, float eps) {
  Args a = {};
  a.reorder = static_cast<const int*>(reorder);
  a.q_i = q_i; a.bias_i = bias_i; a.k_i = k_i; a.ca_i = ca_i; a.cb_i = cb_i;
  a.cond_i = cond_i; a.sel = static_cast<const float*>(sel); a.embed = embed;
  a.src_keys = src[0]; a.src_ca = src[1]; a.src_cb = src[2]; a.src_cond = src[3];
  a.src_va = src[4]; a.src_vb = src[5];
  a.dst_keys = dst[0]; a.dst_ca = dst[1]; a.dst_cb = dst[2]; a.dst_cond = dst[3];
  a.dst_va = dst[4]; a.dst_vb = dst[5];
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.counter = static_cast<int*>(counter);
  a.L = L; a.E = E; a.d = d; a.pos = pos; a.sqrt_d = sqrt_d; a.eps = eps;
  return a;
}

// The launch plan comes from ops/dyn_exp_step.py::step_plan: `chunks`
// clusters a row, the first `scorers` of them forming the forward scores
// (where chunks > 1), the others `per` positions each; shared regions of r1
// and r2 floats, `smem` bytes in all.
static cudaError_t launch(Args a, int rows, int chunks, int per, int scorers, int r1, int r2,
                          int smem, int dtype, void* stream) {
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  if (a.pos < 0 || a.pos >= a.L || chunks < 1 || per < 1 || scorers < 1 || smem > kMaxShared)
    return cudaErrorInvalidValue;
  a.per = per;
  a.scorers = scorers;
  a.r1 = r1;
  a.r2 = r2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_typed<float>(a, rows, chunks, smem, s);
  return launch_typed<__nv_bfloat16>(a, rows, chunks, smem, s);
}

extern "C" int dyn_exp_step_launch(
    const void* reorder, const void* q_i, const void* bias_i, const void* k_i,
    const void* ca_i, const void* cb_i, const void* cond_i, const void* sel,
    const void* embed, const void* src_keys, const void* src_ca,
    const void* src_cb, const void* src_cond, const void* src_va,
    const void* src_vb, void* dst_keys, void* dst_ca, void* dst_cb,
    void* dst_cond, void* dst_va, void* dst_vb, void* out, void* part, void* counter,
    int rows, int L, int E, int d, int pos, float sqrt_d, float eps, int chunks, int per,
    int scorers, int r1, int r2, int smem, int dtype, void* stream) {
  const void* src[6] = {src_keys, src_ca, src_cb, src_cond, src_va, src_vb};
  void* dst[6] = {dst_keys, dst_ca, dst_cb, dst_cond, dst_va, dst_vb};
  const Args a = step_args(reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src,
                           dst, out, part, counter, L, E, d, pos, sqrt_d, eps);
  return launch(a, rows, chunks, per, scorers, r1, r2, smem, dtype, stream);
}

// B16: the step above with the cross-attention tail. `y_out` (rows, d) fp32
// is the result; k_cross, v_cross (rows / group, S, d) and wq, wo (d, d) as
// (in, out) are in the cache type.
extern "C" int dyn_exp_cross_step_launch(
    const void* reorder, const void* q_i, const void* bias_i, const void* k_i,
    const void* ca_i, const void* cb_i, const void* cond_i, const void* sel,
    const void* embed, const void* src_keys, const void* src_ca,
    const void* src_cb, const void* src_cond, const void* src_va,
    const void* src_vb, void* dst_keys, void* dst_ca, void* dst_cb,
    void* dst_cond, void* dst_va, void* dst_vb, const void* y,
    const void* ln_g, const void* ln_b, const void* wq, const void* bq,
    const void* wo, const void* bo, const void* k_cross, const void* v_cross,
    const void* enc_mask, void* y_out, void* part, void* counter, int rows, int L, int E,
    int d, int pos, int S, int heads, int group, float sqrt_d, float eps,
    float ln_eps, float attn_fill, int chunks, int per, int scorers, int r1, int r2, int smem,
    int dtype, void* stream) {
  if (y == nullptr || group <= 0 || rows % group != 0 || heads <= 0)
    return cudaErrorInvalidValue;
  const void* src[6] = {src_keys, src_ca, src_cb, src_cond, src_va, src_vb};
  void* dst[6] = {dst_keys, dst_ca, dst_cb, dst_cond, dst_va, dst_vb};
  Args a = step_args(reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src, dst,
                     nullptr, part, counter, L, E, d, pos, sqrt_d, eps);
  a.y = static_cast<const float*>(y);
  a.ln_g = static_cast<const float*>(ln_g); a.ln_b = static_cast<const float*>(ln_b);
  a.wq = wq; a.wo = wo;
  a.bq = static_cast<const float*>(bq); a.bo = static_cast<const float*>(bo);
  a.k_cross = k_cross; a.v_cross = v_cross;
  a.enc_mask = static_cast<const float*>(enc_mask);
  a.y_out = static_cast<float*>(y_out);
  a.S = S; a.heads = heads; a.group = group; a.ln_eps = ln_eps; a.attn_fill = attn_fill;
  return launch(a, rows, chunks, per, scorers, r1, r2, smem, dtype, stream);
}
