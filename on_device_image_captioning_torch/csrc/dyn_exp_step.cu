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
// rounds them. src and dst must not alias: a row of one launch may still be
// read by another row (beam duplication), so the caller ping-pongs two sets.
//
// Bound on the H100: bytes. Each row streams its two (L, E, d) vals caches in
// and out (2 x 2 x 74 x 16 x 512 x 2 B = 4.8 MB per row at L = 74 in bf16);
// the scores are ~1.3k dot products of length d. With only B x beam rows
// (24 at b8/beam 3) and 132 SMs, one CTA per row would leave most SMs idle,
// so each row gets d / 64 CTAs, one per 64-column slice. Every CTA of a row
// recomputes the row's scores (cheap, L2-resident inputs) and then streams
// only its column slice of the caches, coalesced across 64 threads.
//
// B16: the same step with the decoder layer's cross-attention behind it, in
// the same launch. Replaces ops/dyn_exp_step.py::dyn_exp_cross_step_pallas
// (`_cross_tail`): y1 = y + out; x2 = LN2(y1); q = x2 Wq + bq; per head the
// scores of q against the image's cached K (S, d) / sqrt(dk), pad positions
// set to attn_fill, softmax over S, . V; y_out = y1 + (o Wo + bo). Row i reads
// image row i / group of K, V and the pad mask. LN2 and the attention need
// the row's whole out, which the row's d / 64 CTAs hold in slices: each CTA
// writes its slice to device memory ((B, d) fp32, 2 KB a row), fences, and
// counts itself on the row's counter; the CTA that arrives last runs the
// tail for the row (and sets the counter back to 0 for the next launch).
// Roundings follow `_cross_tail`: x2, q, the attention weights, o and the
// out_linear product are rounded through the storage type (the kernel is
// built for compute type == cache type); statistics, softmax and sums fp32.
// The Wq and Wo products (and the weights . V sum) are the kernel's own:
// a thread takes 16 bytes of output columns and a share of K, and the partial
// sums meet in shared memory; every loop keeps many 16-byte loads in flight,
// because a row's tail runs on one CTA and waits for L2, not for bandwidth.
// Bound: bytes, as K2, plus Wq, Wo (d x d each) and the images' K and V; the
// tail runs on B CTAs only, so its reads are latency, not bandwidth.
#include "common.cuh"

namespace {

constexpr int kCols = 64;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kCols;
constexpr int kWarps = kThreads / 32;

struct Args {
  const int* reorder;
  const void *q_i, *bias_i, *k_i, *ca_i, *cb_i, *cond_i;
  const float* sel;
  const void* embed;
  const void *src_keys, *src_ca, *src_cb, *src_cond, *src_va, *src_vb;
  void *dst_keys, *dst_ca, *dst_cb, *dst_cond, *dst_va, *dst_vb;
  float* out;
  int L, E, d, pos;
  float sqrt_d, eps;
  // the cross-attention tail (B16); y == nullptr: none
  const float *y, *ln_g, *ln_b;
  const void *wq, *wo;        // (d, d) as (in, out), storage type
  const float *bq, *bo;
  const void *k_cross, *v_cross;  // (B_img, S, d), storage type
  const float* enc_mask;      // (B_img, S), > 0 where the token is real, or null
  float* y_out;               // (B, d)
  int* counter;               // (B), all 0 at launch and again at exit
  int S, heads, group;
  float ln_eps, attn_fill;
};

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

template <typename T>
__device__ __forceinline__ float dot_row(const T* a, const T* b, int d, int lane) {
  float s = 0.f;
  for (int t = lane; t < d; t += 32) s = fmaf(to_f<T>(a[t]), to_f<T>(b[t]), s);
  return warp_sum(s);
}

// res[c] = sum_{k < K} coef(k, c) w[k, c] for all d columns (res in shared
// memory): thread (part, cg) sums its share of k for the V columns of its
// 16-byte chunk, whose coefficient coef(k, first column of the chunk) they
// share; the parts meet in `part`.
template <typename T, typename Coef>
__device__ __forceinline__ void row_times_matrix(Coef coef, const T* w, int K, int d,
                                                 float* part, float* res) {
  constexpr int V = 16 / sizeof(T);
  const int groups = d / V, parts = kThreads / groups;
  const int pt = threadIdx.x / groups, c0 = (threadIdx.x % groups) * V;
  const int span = (K + parts - 1) / parts;
  const int k_end = min(K, (pt + 1) * span);
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 8
  for (int k = pt * span; k < k_end; ++k) {
    const uint4 raw = *reinterpret_cast<const uint4*>(w + (long)k * d + c0);
    const T* wv = reinterpret_cast<const T*>(&raw);
    const float xk = coef(k, c0);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = fmaf(xk, to_f<T>(wv[j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[pt * d + c0 + j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float s = 0.f;
    for (int q = 0; q < parts; ++q) s += part[q * d + c];
    res[c] = s;
  }
  __syncthreads();
}

// The tail of B16 for row i, by one CTA; sm holds (4 + parts) d + heads S floats.
template <typename T>
__device__ void cross_tail(const Args& a, int i, float* sm, float* red) {
  constexpr int V = 16 / sizeof(T);
  const int d = a.d, S = a.S, H = a.heads, dk = a.d / a.heads;
  const int parts = kThreads / (d / V);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* yv = sm;              // y + out
  float* xr = yv + d;          // LN2(yv) rounded, later o rounded
  float* q = xr + d;           // q, later the out_linear product
  float* part = q + d;         // parts x d
  float* sc = part + parts * d;  // heads x S
  const long img = i / a.group;
  const T* kc = static_cast<const T*>(a.k_cross) + img * S * d;
  const T* vc = static_cast<const T*>(a.v_cross) + img * S * d;

  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float v = a.y[(long)i * d + c] + __ldcg(a.out + (long)i * d + c);
    yv[c] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / d;
  float sq = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float dl = yv[c] - mean;
    sq = fmaf(dl, dl, sq);
  }
  const float rstd = rsqrtf(block_sum(sq, red + kWarps) / d + a.ln_eps);
  for (int c = threadIdx.x; c < d; c += kThreads)
    xr[c] = round_t<T>((yv[c] - mean) * rstd * a.ln_g[c] + a.ln_b[c]);
  __syncthreads();

  row_times_matrix<T>([&](int k, int) { return xr[k]; }, static_cast<const T*>(a.wq), d, d,
                      part, q);
  for (int c = threadIdx.x; c < d; c += kThreads) q[c] = round_t<T>(q[c] + a.bq[c]);
  __syncthreads();

  // scores: a thread per (token, head) reads the head's dk columns of the
  // token's K row in 16-byte chunks, all of them in flight at once
  const float sqrt_dk = sqrtf((float)dk);
  for (int item = threadIdx.x; item < S * H; item += kThreads) {
    const int t = item / H, h = item % H;
    const uint4* krow = reinterpret_cast<const uint4*>(kc + (long)t * d + h * dk);
    const float* qh = q + h * dk;
    float z = 0.f;
#pragma unroll 8
    for (int ch = 0; ch < dk / V; ++ch) {
      const uint4 raw = krow[ch];
      const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) z = fmaf(to_f<T>(kv[j]), qh[ch * V + j], z);
    }
    z /= sqrt_dk;
    if (a.enc_mask != nullptr && !(a.enc_mask[img * S + t] > 0.f)) z = a.attn_fill;
    sc[h * S + t] = z;
  }
  __syncthreads();
  // softmax over the tokens: a warp per head
  for (int h = warp; h < H; h += kWarps) {
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
  row_times_matrix<T>([&](int t, int c0) { return sc[(c0 / dk) * S + t]; }, vc, S, d, part, q);
  for (int c = threadIdx.x; c < d; c += kThreads) xr[c] = round_t<T>(q[c]);
  __syncthreads();

  row_times_matrix<T>([&](int k, int) { return xr[k]; }, static_cast<const T*>(a.wo), d, d,
                      part, q);
  for (int c = threadIdx.x; c < d; c += kThreads)
    a.y_out[(long)i * d + c] = yv[c] + round_t<T>(q[c] + a.bo[c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dyn_exp_step_kernel(const Args a) {
  extern __shared__ float smem[];
  const int L = a.L, E = a.E, d = a.d, pos = a.pos, P = a.pos + 1;
  const int i = blockIdx.y;
  const long r = a.reorder[i];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float* afw = smem;             // E * L forward weights (+ side)
  float* bfw = afw + E * L;      // E * L forward weights (- side)
  float* abw = bfw + E * L;      // L * E backward weights (+ side)
  float* bbw = abw + L * E;      // L * E backward weights (- side)
  float* zc = bbw + L * E;       // L
  float* ze = zc + L;            // E
  float* newa = ze + E;          // E * kCols new vals_a row slice
  float* newb = newa + E * kCols;
  float* red = newb + E * kCols;  // kThreads reduction scratch (x2)

  const T* q_i = static_cast<const T*>(a.q_i) + (long)i * E * d;
  const T* bias_i = static_cast<const T*>(a.bias_i) + (long)i * E * d;
  const T* k_i = static_cast<const T*>(a.k_i) + (long)i * d;
  const T* ca_i = static_cast<const T*>(a.ca_i) + (long)i * d;
  const T* cb_i = static_cast<const T*>(a.cb_i) + (long)i * d;
  const T* cond_i = static_cast<const T*>(a.cond_i) + (long)i * d;
  const T* embed = static_cast<const T*>(a.embed);
  const T* s_keys = static_cast<const T*>(a.src_keys) + r * L * d;
  const T* s_ca = static_cast<const T*>(a.src_ca) + r * L * d;
  const T* s_cb = static_cast<const T*>(a.src_cb) + r * L * d;
  const T* s_cond = static_cast<const T*>(a.src_cond) + r * L * d;
  const T* s_va = static_cast<const T*>(a.src_va) + r * L * E * d;
  const T* s_vb = static_cast<const T*>(a.src_vb) + r * L * E * d;
  T* d_keys = static_cast<T*>(a.dst_keys) + (long)i * L * d;
  T* d_ca = static_cast<T*>(a.dst_ca) + (long)i * L * d;
  T* d_cb = static_cast<T*>(a.dst_cb) + (long)i * L * d;
  T* d_cond = static_cast<T*>(a.dst_cond) + (long)i * L * d;
  T* d_va = static_cast<T*>(a.dst_va) + (long)i * L * E * d;
  T* d_vb = static_cast<T*>(a.dst_vb) + (long)i * L * E * d;

  // ---- scores: one warp per dot product over the full width d ----------
  const int n_fw = E * P;
  const int total = n_fw + P + E;
  for (int item = warp; item < total; item += kWarps) {
    if (item < n_fw) {
      const int e = item / P, l = item % P;
      const T* key = l == pos ? k_i : s_keys + (long)l * d;
      const float z = dot_row<T>(q_i + (long)e * d, key, d, lane);
      if (lane == 0) afw[e * L + l] = z / a.sqrt_d;
    } else if (item < n_fw + P) {
      const int l = item - n_fw;
      const T* cond = l == pos ? cond_i : s_cond + (long)l * d;
      const float z = dot_row<T>(k_i, cond, d, lane);
      if (lane == 0) zc[l] = z;
    } else {
      const int e = item - n_fw - P;
      const float z = dot_row<T>(k_i, embed + (long)e * d, d, lane);
      if (lane == 0) ze[e] = z;
    }
  }
  __syncthreads();

  // forward weights: L1 over l <= pos for each e (one warp per e)
  for (int e = warp; e < E; e += kWarps) {
    float sa = 0.f, sb = 0.f;
    for (int l = lane; l < P; l += 32) {
      const float z = afw[e * L + l];
      sa += fmaxf(z, 0.f);
      sb += fmaxf(-z, 0.f);
    }
    sa = warp_sum(sa) + a.eps;
    sb = warp_sum(sb) + a.eps;
    for (int l = lane; l < P; l += 32) {
      const float z = afw[e * L + l];
      afw[e * L + l] = round_t<T>(fmaxf(z, 0.f) / sa);
      bfw[e * L + l] = round_t<T>(fmaxf(-z, 0.f) / sb);
    }
  }

  // backward weights: L1 over all (l <= pos, e)
  const int n_bw = P * E;
  float pa = 0.f, pb = 0.f;
  for (int item = threadIdx.x; item < n_bw; item += kThreads) {
    const float z = (zc[item / E] + ze[item % E]) / a.sqrt_d;
    pa += fmaxf(z, 0.f);
    pb += fmaxf(-z, 0.f);
  }
  const float suma = block_sum(pa, red) + a.eps;
  const float sumb = block_sum(pb, red + kWarps) + a.eps;
  for (int item = threadIdx.x; item < n_bw; item += kThreads) {
    const float z = (zc[item / E] + ze[item % E]) / a.sqrt_d;
    abw[item] = round_t<T>(fmaxf(z, 0.f) / suma);
    bbw[item] = round_t<T>(fmaxf(-z, 0.f) / sumb);
  }
  __syncthreads();

  // ---- this CTA's column slice ------------------------------------------
  const int cl = threadIdx.x % kCols, g = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + cl;

  for (int l = g; l < L; l += kGroups) {
    const long o = (long)l * d + col;
    const bool here = l == pos;
    d_keys[o] = here ? k_i[col] : s_keys[o];
    d_ca[o] = here ? ca_i[col] : s_ca[o];
    d_cb[o] = here ? cb_i[col] : s_cb[o];
    d_cond[o] = here ? cond_i[col] : s_cond[o];
  }

  // new vals rows at pos for this slice
  for (int e = g; e < E; e += kGroups) {
    float fa = 0.f, fb = 0.f;
    for (int l = 0; l < P; ++l) {
      const float cav = to_f<T>(l == pos ? ca_i[col] : s_ca[(long)l * d + col]);
      const float cbv = to_f<T>(l == pos ? cb_i[col] : s_cb[(long)l * d + col]);
      fa = fmaf(afw[e * L + l], cav, fa);
      fb = fmaf(bfw[e * L + l], cbv, fb);
    }
    const float bias = to_f<T>(bias_i[(long)e * d + col]);
    newa[e * kCols + cl] = round_t<T>(fa + bias);
    newb[e * kCols + cl] = round_t<T>(fb + bias);
  }
  __syncthreads();

  // stream the vals caches: copy every position, contract positions <= pos
  float acc_a = 0.f, acc_b = 0.f;
  for (int p = g; p < L * E; p += kGroups) {
    const int l = p / E, e = p % E;
    const long o = (long)p * d + col;
    float va, vb;
    if (l == pos) {
      va = newa[e * kCols + cl];
      vb = newb[e * kCols + cl];
      d_va[o] = from_f<T>(va);
      d_vb[o] = from_f<T>(vb);
    } else {
      const T ta = s_va[o], tb = s_vb[o];
      d_va[o] = ta;
      d_vb[o] = tb;
      va = to_f<T>(ta);
      vb = to_f<T>(tb);
    }
    if (l < P) {
      acc_a = fmaf(abw[p], va, acc_a);
      acc_b = fmaf(bbw[p], vb, acc_b);
    }
  }
  red[threadIdx.x] = acc_a;
  red[kThreads + threadIdx.x] = acc_b;
  __syncthreads();
  if (g == 0) {
    float oa = 0.f, ob = 0.f;
    for (int q = 0; q < kGroups; ++q) {
      oa += red[q * kCols + cl];
      ob += red[kThreads + q * kCols + cl];
    }
    const float s = a.sel[(long)i * d + col];
    a.out[(long)i * d + col] = s * oa + (1.f - s) * ob;
  }
  if (a.y == nullptr) return;

  // B16: the CTA of this row that arrives last runs the cross-attention tail
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(a.counter + i, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  cross_tail<T>(a, i, red + 2 * kThreads, red);
  if (threadIdx.x == 0) a.counter[i] = 0;
}

template <typename T>
static cudaError_t launch_typed(const Args& a, int rows, cudaStream_t stream) {
  size_t floats = 4 * (size_t)a.E * a.L + a.L + a.E +
                  2 * (size_t)a.E * kCols + 2 * kThreads;
  if (a.y != nullptr) {
    const int groups = a.d / (16 / (int)sizeof(T));
    if (groups > kThreads || kThreads % groups != 0 || a.heads <= 0 ||
        a.d % a.heads != 0 || (a.d / a.heads) % (16 / (int)sizeof(T)) != 0 || a.S <= 0 ||
        a.group <= 0)
      return cudaErrorInvalidValue;
    floats += (4 + kThreads / groups) * (size_t)a.d + (size_t)a.heads * a.S;
  }
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dyn_exp_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.d / kCols, rows);
  dyn_exp_step_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The step's operands as the kernel reads them (the tail's stay unset).
static Args step_args(const void* reorder, const void* q_i, const void* bias_i,
                      const void* k_i, const void* ca_i, const void* cb_i,
                      const void* cond_i, const void* sel, const void* embed,
                      const void* const* src, void* const* dst, void* out, int L, int E,
                      int d, int pos, float sqrt_d, float eps) {
  Args a = {};
  a.reorder = static_cast<const int*>(reorder);
  a.q_i = q_i; a.bias_i = bias_i; a.k_i = k_i; a.ca_i = ca_i; a.cb_i = cb_i;
  a.cond_i = cond_i; a.sel = static_cast<const float*>(sel); a.embed = embed;
  a.src_keys = src[0]; a.src_ca = src[1]; a.src_cb = src[2]; a.src_cond = src[3];
  a.src_va = src[4]; a.src_vb = src[5];
  a.dst_keys = dst[0]; a.dst_ca = dst[1]; a.dst_cb = dst[2]; a.dst_cond = dst[3];
  a.dst_va = dst[4]; a.dst_vb = dst[5];
  a.out = static_cast<float*>(out);
  a.L = L; a.E = E; a.d = d; a.pos = pos; a.sqrt_d = sqrt_d; a.eps = eps;
  return a;
}

static cudaError_t launch(const Args& a, int rows, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_typed<float>(a, rows, s);
  if (dtype == kBFloat16) return launch_typed<__nv_bfloat16>(a, rows, s);
  return cudaErrorInvalidValue;
}

extern "C" int dyn_exp_step_launch(
    const void* reorder, const void* q_i, const void* bias_i, const void* k_i,
    const void* ca_i, const void* cb_i, const void* cond_i, const void* sel,
    const void* embed, const void* src_keys, const void* src_ca,
    const void* src_cb, const void* src_cond, const void* src_va,
    const void* src_vb, void* dst_keys, void* dst_ca, void* dst_cb,
    void* dst_cond, void* dst_va, void* dst_vb, void* out, int rows, int L,
    int E, int d, int pos, float sqrt_d, float eps, int dtype, void* stream) {
  if (d % kCols != 0 || pos < 0 || pos >= L) return cudaErrorInvalidValue;
  const void* src[6] = {src_keys, src_ca, src_cb, src_cond, src_va, src_vb};
  void* dst[6] = {dst_keys, dst_ca, dst_cb, dst_cond, dst_va, dst_vb};
  const Args a = step_args(reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src,
                           dst, out, L, E, d, pos, sqrt_d, eps);
  return launch(a, rows, dtype, stream);
}

// B16: the step above with the cross-attention tail. `out` is (rows, d) fp32
// scratch for the dynamic-expansion output, `y_out` (rows, d) fp32 the result,
// `counter` (rows) int32 zeros (left at zero). k_cross, v_cross
// (rows / group, S, d) and wq, wo (d, d) as (in, out) are in the cache type.
extern "C" int dyn_exp_cross_step_launch(
    const void* reorder, const void* q_i, const void* bias_i, const void* k_i,
    const void* ca_i, const void* cb_i, const void* cond_i, const void* sel,
    const void* embed, const void* src_keys, const void* src_ca,
    const void* src_cb, const void* src_cond, const void* src_va,
    const void* src_vb, void* dst_keys, void* dst_ca, void* dst_cb,
    void* dst_cond, void* dst_va, void* dst_vb, void* out, const void* y,
    const void* ln_g, const void* ln_b, const void* wq, const void* bq,
    const void* wo, const void* bo, const void* k_cross, const void* v_cross,
    const void* enc_mask, void* y_out, void* counter, int rows, int L, int E,
    int d, int pos, int S, int heads, int group, float sqrt_d, float eps,
    float ln_eps, float attn_fill, int dtype, void* stream) {
  if (d % kCols != 0 || pos < 0 || pos >= L || y == nullptr || group <= 0 ||
      rows % group != 0)
    return cudaErrorInvalidValue;
  const void* src[6] = {src_keys, src_ca, src_cb, src_cond, src_va, src_vb};
  void* dst[6] = {dst_keys, dst_ca, dst_cb, dst_cond, dst_va, dst_vb};
  Args a = step_args(reorder, q_i, bias_i, k_i, ca_i, cb_i, cond_i, sel, embed, src, dst,
                     out, L, E, d, pos, sqrt_d, eps);
  a.y = static_cast<const float*>(y);
  a.ln_g = static_cast<const float*>(ln_g); a.ln_b = static_cast<const float*>(ln_b);
  a.wq = wq; a.wo = wo;
  a.bq = static_cast<const float*>(bq); a.bo = static_cast<const float*>(bo);
  a.k_cross = k_cross; a.v_cross = v_cross;
  a.enc_mask = static_cast<const float*>(enc_mask);
  a.y_out = static_cast<float*>(y_out); a.counter = static_cast<int*>(counter);
  a.S = S; a.heads = heads; a.group = group; a.ln_eps = ln_eps; a.attn_fill = attn_fill;
  return launch(a, rows, dtype, stream);
}
