// B9c: backward of the MLP half of a Swin block, y = x2 + m2 * fc2(GELU(fc1(LN2(x2)))),
// from the saved x2 and the output gradient dy, over flat rows (R, C).
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// _mlp_bwd_call and _mlp_bwd_call_emit (`_mlp_bwd_kernel`,
// `_mlp_bwd_emit_kernel`). The two TPU forms are one function: the emit form
// moves the weight-gradient products outside the kernel only because the fp32
// accumulators do not fit its scoped VMEM at C = 768. The TPU kernel holds a
// tile of rows, both weights and the fp32 dW1, dW2 accumulators in VMEM and
// carries the sums over a sequential grid. A thread block here has 227 KB of
// shared memory and the grid runs in no order, so this is a chain of
// launches, every product of the TPU kernel's body one of the port's own
// backward products (fused_linear.cuh: bf16 on wgmma in the tile forms and
// splits of the launch plan, ops/linear_plan.py::grad_plan), every sum over
// the rows a fixed-order sum of partials (two launches agree bit for bit).
//
// Bound on the H100: operations, 5 products of 2 C 4C flops a row (40 C^2)
// against 6 C bytes of x2, dy and dx2 in bf16. The chain moves the hidden
// rows g and dh1 through device memory, 4 x 4C bytes a row beside those 6 C
// (h1 stays in registers in bf16); PERF.md has the times. Seven launches in
// bf16:
//
//   1. xn2 = round(LN2(x2)); dmlp = round(dy * m2[image]), db2 partials  rows_prep
//   2. h1 = xn2 @ W1 + b1 and dg = dmlp @ W2^T of one tile, in one CTA:
//      g = round(GELU(h1)), dh1 = round(dg * GELU'(h1)), db1 partials
//      by row tile                                                       hidden_grad
//   3. dW2 = g^T @ dmlp        fp32 partials by chunk of rows            X^T @ dY
//   4. dW1 = xn2^T @ dh1       fp32 partials by chunk of rows            X^T @ dY
//   5. dxn2 = dh1 @ W1^T (fp32)                                          dY @ W^T
//   6. dx2 = round(dy + LN2 backward(dxn2)), dg2, dbe2 partials          ln_bwd
//   7. dW1, db1, dW2, db2, dg2, dbe2 = the partials summed in order      sum_partials
// fp32 runs step 2 as two products on the CUDA cores with h1 kept in fp32
// between them (kEpiGeluFwd, then kEpiGeluBwd): eight launches.
// The roundings are `_mlp_bwd_kernel`'s: h1 stays fp32, g, dmlp and dh1 are
// rounded to the storage type before they enter a product, the bias and
// LayerNorm gradients sum fp32 values.
#include "backward_rows.cuh"
#include "fused_linear.cuh"

namespace {

// B9c's hidden rows in one bf16 launch: h1 = xn @ W1 + b1 (x @ W) and dg =
// d @ W2^T (dY @ W^T) of the same BM x BN tile, one ring pass after the other
// (each with its own barriers), then g = round(GELU(h1)) and dh1 =
// round(dg * GELU'(h1)) from the registers (h1 never leaves them: the two
// launches of kEpiGeluFwd and kEpiGeluBwd move it through device memory in
// fp32), and the column sums of dh1 over the tile's rows into row blockIdx.y
// of col_part. Tile form kHiddenForm (ops/swin_block_fused.py mirrors its rows).
struct HiddenArgs {
  const void* xn;     // (M, K) row-major
  const void* w1;     // (K, N) row-major
  const void* d;      // (M, K) row-major
  const void* w2;     // (N, K) row-major
  const float* bias;  // (N) or null
  void* g;            // (M, N)
  void* dh;           // (M, N)
  float* col_part;    // (row tiles, N)
  int M, N, K;
};
constexpr GradForm kHiddenForm = {128, 64, 64, 3, 2};
// the ring and its barriers, a second set of barriers and the bias of the
// tile's columns
constexpr int kHiddenSmem =
    grad_smem(kHiddenForm) + 2 * kHiddenForm.stages * 8 + kHiddenForm.bn * 4;

template <int BM, int BN, int BK, int S, int CTAS>
__global__ void __launch_bounds__(2 * BM, CTAS) hidden_grad_kernel(HiddenArgs p) {
  typedef __nv_bfloat16 T;
  constexpr int THREADS = 2 * BM, STAGE = BM * BK * 2 + BK * BN * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  uint64_t* full2 = empty + S;
  uint64_t* empty2 = full2 + S;
  float* bias_s = reinterpret_cast<float*>(empty2 + S);
  const int tid = threadIdx.x, wg = tid >> 7;
  const long m0 = static_cast<long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const uint32_t ring_s = smem_u32(ring);
  if (tid == 0) {
    for (int s = 0; s < 4 * S; ++s) mbar_init(&full[s], THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += THREADS)
    bias_s[i] = (p.bias != nullptr && n0 + i < p.N) ? p.bias[n0 + i] : 0.f;
  __syncthreads();

  float h[BN / 2], dg[BN / 2];
  grad_mainloop<BM, BN, BK, S, false, true>(h, static_cast<const T*>(p.xn), p.K,
                                            static_cast<const T*>(p.w1), p.N, p.M, p.N, m0, n0,
                                            0, p.K, ring_s, full, empty);
  __syncthreads();  // the ring is free for the second product
  grad_mainloop<BM, BN, BK, S, false, false>(dg, static_cast<const T*>(p.d), p.K,
                                             static_cast<const T*>(p.w2), p.K, p.M, p.N, m0, n0,
                                             0, p.K, ring_s, full2, empty2);
  __syncthreads();  // the ring takes the two rounded tiles now

  // the C layout of linear_wgmma_kernel's epilogue; g's tile, then dh1's, in
  // the ring as rows of BN values and 16 bytes
  constexpr int ST = BN * 2 + 16;
  static_assert(2 * BM * ST <= S * STAGE, "both tiles fit the ring");
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  uint8_t* gt = ring;
  uint8_t* dt = ring + BM * ST;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bool in = m0 + r0 + 8 * hh < p.M && n0 + c < p.N;
      float gv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // GELU(v) = v Phi(v) and GELU'(v) = Phi(v) + v phi(v) share Phi: the
        // same roundings as gelu_exact and gelu_grad, one erf
        const float v = h[4 * j + 2 * hh + e] + bias_s[c + e];
        const float phi = 0.5f * (1.0f + erff(v * 0.7071067811865476f));
        gv[e] = in ? v * phi : 0.f;
        dv[e] = in ? dg[4 * j + 2 * hh + e] *
                         (phi + v * expf(-0.5f * v * v) * 0.3989422804014327f)
                   : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(gt + (r0 + 8 * hh) * ST + c * 2) =
          __floats2bfloat162_rn(gv[0], gv[1]);
      *reinterpret_cast<__nv_bfloat162*>(dt + (r0 + 8 * hh) * ST + c * 2) =
          __floats2bfloat162_rn(dv[0], dv[1]);
    }
  }
  __syncthreads();
  constexpr int CH = BN / 8, PER = BM * CH / THREADS;
  static_assert((BM * CH) % THREADS == 0, "whole chunks a thread");
  T* g = static_cast<T*>(p.g);
  T* dh = static_cast<T*>(p.dh);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS, row = e / CH, ch = e % CH;
    const long r = m0 + row;
    const int c = n0 + ch * 8;
    if (r < p.M && c < p.N) {
      *reinterpret_cast<uint4*>(g + r * p.N + c) =
          *reinterpret_cast<const uint4*>(gt + row * ST + ch * 16);
      *reinterpret_cast<uint4*>(dh + r * p.N + c) =
          *reinterpret_cast<const uint4*>(dt + row * ST + ch * 16);
    }
  }
  for (int c = tid; c < BN; c += THREADS) {  // rows past M were staged as zeros
    float sum = 0.f;
    for (int row = 0; row < BM; ++row)
      sum += __bfloat162float(*reinterpret_cast<const T*>(dt + row * ST + c * 2));
    if (n0 + c < p.N) p.col_part[static_cast<long>(blockIdx.y) * p.N + n0 + c] = sum;
  }
}

static cudaError_t launch_hidden_grad(const HiddenArgs& p, cudaStream_t s) {
  constexpr GradForm f = kHiddenForm;
  static_assert(kHiddenSmem <= 232448 && f.ctas * (kHiddenSmem + 1024) <= 233472,
                "a CTA's and an SM's shared memory");
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.N % 8 != 0 || p.K % 8 != 0 ||
      p.col_part == nullptr)
    return cudaErrorInvalidValue;
  const auto kernel = hidden_grad_kernel<f.bm, f.bn, f.bk, f.stages, f.ctas>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHiddenSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(static_cast<unsigned>((p.N + f.bn - 1) / f.bn),
            static_cast<unsigned>((p.M + f.bm - 1) / f.bm));
  kernel<<<grid, 2 * f.bm, kHiddenSmem, s>>>(p);
  return cudaGetLastError();
}

// The launch plan's ints, in this order (ops/swin_block_fused.py::swin_mlp_bwd)
enum MlpPlan { kDxnForm, kW2Form, kW2Chunk, kW1Form, kW1Chunk, kMlpPlanLen };

struct MlpBwdArgs {
  const void *x2, *dy, *w1, *w2;
  const float *g2, *b2, *b1, *m2;
  void *xn2, *g, *dmlp, *dh1, *dx2;
  float *h1, *dxn2;
  float *dw1_part, *dw2_part, *db1_part, *db2_part, *dg2_part, *dbe2_part;
  float *dw1, *db1, *dw2, *db2, *dg2, *dbe2;
  int rows, c, hid, rows_per_image;
  const int* plan;
  float eps;
};

template <typename T>
cudaError_t mlp_bwd_typed(const MlpBwdArgs& p, cudaStream_t s) {
  const int rows = p.rows, c = p.c, hid = p.hid;
  const int* plan = p.plan;
  cudaError_t err = launch_rows_prep<T>(p.x2, p.g2, p.b2, p.xn2, p.dy, p.m2, p.dmlp,
                                        p.db2_part, rows, c, p.rows_per_image, p.eps, s);
  if (err != cudaSuccess) return err;

  int db1_parts;
  if constexpr (sizeof(T) == 2) {  // h1 stays in registers
    HiddenArgs hg = {p.xn2, p.w1, p.dmlp, p.w2, p.b1, p.g, p.dh1, p.db1_part, rows, hid, c};
    if ((err = launch_hidden_grad(hg, s)) != cudaSuccess) return err;
    db1_parts = (rows + kHiddenForm.bm - 1) / kHiddenForm.bm;
  } else {  // fp32: h1 through device memory, the two products on the CUDA cores
    if (p.h1 == nullptr) return cudaErrorInvalidValue;
    GemmArgs fc1 = xw_args(p.xn2, p.w1, rows, c, hid);
    fc1.bias = p.b1; fc1.aux = p.h1; fc1.out_t = p.g; fc1.epi = kEpiGeluFwd;
    if ((err = launch_grad<T>(fc1, kXW, -1, s)) != cudaSuccess) return err;
    GemmArgs dg = input_grad_args(p.dmlp, p.w2, rows, hid, c);
    dg.aux = p.h1; dg.out_t = p.dh1; dg.epi = kEpiGeluBwd; dg.col_part = p.db1_part;
    if ((err = launch_grad<T>(dg, kDYWT, -1, s)) != cudaSuccess) return err;
    db1_parts = (rows + 127) / 128;  // grad_fp32_kernel's row tiles
  }

  GemmArgs dw2 = weight_grad_args(p.g, p.dmlp, p.dw2_part, rows, hid, c, plan[kW2Chunk]);
  if ((err = launch_grad<T>(dw2, kATB, plan[kW2Form], s)) != cudaSuccess) return err;
  GemmArgs dw1 = weight_grad_args(p.xn2, p.dh1, p.dw1_part, rows, c, hid, plan[kW1Chunk]);
  if ((err = launch_grad<T>(dw1, kATB, plan[kW1Form], s)) != cudaSuccess) return err;

  GemmArgs dxn = input_grad_args(p.dh1, p.w1, rows, c, hid);
  dxn.out_f = p.dxn2;
  if ((err = launch_grad<T>(dxn, kDYWT, plan[kDxnForm], s)) != cudaSuccess) return err;
  if ((err = launch_ln_bwd<T>(p.x2, p.dxn2, p.g2, p.dy, p.dx2, p.dg2_part, p.dbe2_part, rows, c,
                              p.eps, s)) != cudaSuccess)
    return err;

  const int parts = row_parts(rows);
  PartialSums sums = {};
  sums.job[0] = {p.dw1_part, p.dw1, (rows + plan[kW1Chunk] - 1) / plan[kW1Chunk], c * hid};
  sums.job[1] = {p.dw2_part, p.dw2, (rows + plan[kW2Chunk] - 1) / plan[kW2Chunk], hid * c};
  sums.job[2] = {p.db1_part, p.db1, db1_parts, hid};
  sums.job[3] = {p.db2_part, p.db2, parts, c};
  sums.job[4] = {p.dg2_part, p.dg2, parts, c};
  sums.job[5] = {p.dbe2_part, p.dbe2, parts, c};
  sums.n = 6;
  return launch_sum_partials(sums, s);
}

}  // namespace

// x2, dy, dx2 (rows, c); w1 (c, hid), w2 (hid, c) in the storage type; g2, b2,
// b1 fp32 (b1 may be null); m2 (rows / rows_per_image) fp32. Scratch: xn2,
// dmlp (rows, c) and g, dh1 (rows, hid) in the storage type, h1 (rows, hid;
// fp32 only, else null) and dxn2 (rows, c) fp32; the fp32 partials dw1_part
// (chunks of dW1, c, hid), dw2_part (chunks of dW2, hid, c), db1_part (row
// tiles of dh1's product: of kHiddenForm in bf16, of 128 rows in fp32, hid),
// db2_part, dg2_part, dbe2_part (row_parts(rows), c). Outputs dw1 (c, hid),
// db1 (hid), dw2 (hid, c), db2 (c), dg2, dbe2 (c) fp32. plan: kMlpPlanLen
// ints, the tile forms (bf16) and chunks of rows of the products (the launch
// plan's, ops/swin_block_fused.py::swin_mlp_bwd).
extern "C" int swin_mlp_bwd_launch(
    const void* x2, const void* dy, const void* g2, const void* b2, const void* w1,
    const void* b1, const void* w2, const void* m2, void* xn2, void* h1, void* g, void* dmlp,
    void* dh1, void* dxn2, void* dx2, void* dw1_part, void* dw2_part, void* db1_part,
    void* db2_part, void* dg2_part, void* dbe2_part, void* dw1, void* db1, void* dw2, void* db2,
    void* dg2, void* dbe2, int rows, int c, int hid, int rows_per_image, float eps,
    const int* plan, int dtype, void* stream) {
  if (rows <= 0 || c <= 0 || hid <= 0 || rows_per_image <= 0 || rows % rows_per_image != 0 ||
      plan == nullptr || plan[kW1Chunk] <= 0 || plan[kW2Chunk] <= 0)
    return cudaErrorInvalidValue;
  MlpBwdArgs p = {};
  p.x2 = x2; p.dy = dy; p.w1 = w1; p.w2 = w2;
  p.g2 = static_cast<const float*>(g2); p.b2 = static_cast<const float*>(b2);
  p.b1 = static_cast<const float*>(b1); p.m2 = static_cast<const float*>(m2);
  p.xn2 = xn2; p.g = g; p.dmlp = dmlp; p.dh1 = dh1; p.dx2 = dx2;
  p.h1 = static_cast<float*>(h1); p.dxn2 = static_cast<float*>(dxn2);
  p.dw1_part = static_cast<float*>(dw1_part); p.dw2_part = static_cast<float*>(dw2_part);
  p.db1_part = static_cast<float*>(db1_part); p.db2_part = static_cast<float*>(db2_part);
  p.dg2_part = static_cast<float*>(dg2_part); p.dbe2_part = static_cast<float*>(dbe2_part);
  p.dw1 = static_cast<float*>(dw1); p.db1 = static_cast<float*>(db1);
  p.dw2 = static_cast<float*>(dw2); p.db2 = static_cast<float*>(db2);
  p.dg2 = static_cast<float*>(dg2); p.dbe2 = static_cast<float*>(dbe2);
  p.rows = rows; p.c = c; p.hid = hid; p.rows_per_image = rows_per_image; p.eps = eps;
  p.plan = plan;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return mlp_bwd_typed<float>(p, s);
  if (dtype == kBFloat16) return mlp_bwd_typed<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}
