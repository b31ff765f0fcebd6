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
// launches; every product of the TPU kernel's body is one of the port's own
// products (fused_linear.cuh), and the sums over all rows are atomic adds of
// per-CTA partials into outputs the wrapper has zeroed.
//
// Bound on the H100: operations, 5 products of 2 C 4C flops a row (40 C^2)
// against 6 C bytes of x2, dy and dx2 in bf16. The chain moves the hidden
// rows (h1 fp32, g, dh1) through device memory, 8 x 4C bytes a row beside
// those 6 C; PERF.md has the times.
//
//   1. xn2  = round(LN2(x2))                       ln_rows
//   2. h1   = xn2 @ W1 + b1 (fp32, kept), g = round(GELU(h1))
//   3. dmlp = round(dy * m2[image]), db2 = sum dmlp       scale_rows, col_sum
//   4. dh1  = round((dmlp @ W2^T) * GELU'(h1)), db1 = sum dh1
//   5. dW2  = g^T @ dmlp, dW1 = xn2^T @ dh1               fp32, split over rows
//   6. dxn2 = dh1 @ W1^T (fp32)
//   7. dx2  = round(dy + LN2 backward(dxn2)), dg2, dbe2   ln_bwd
// The roundings are `_mlp_bwd_kernel`'s: h1 stays fp32, g, dmlp and dh1 are
// rounded to the storage type before they enter a product, the bias and
// LayerNorm gradients sum fp32 values.
#include "backward_rows.cuh"
#include "fused_linear.cuh"

namespace {

struct MlpBwdArgs {
  const void *x2, *dy, *w1, *w2;
  const float *g2, *b2, *b1, *m2;
  void *xn2, *g, *dmlp, *dh1, *dx2;
  float *h1, *dxn2, *dw1, *db1, *dw2, *db2, *dg2, *dbe2;
  int rows, c, hid, rows_per_image;
  float eps;
};

template <typename T>
cudaError_t mlp_bwd_typed(const MlpBwdArgs& p, cudaStream_t s) {
  const int rows = p.rows, c = p.c, hid = p.hid;
  cudaError_t err = launch_ln_rows<T>(p.x2, p.g2, p.b2, p.xn2, rows, c, p.eps, s);
  if (err != cudaSuccess) return err;

  GemmArgs fc1 = {};
  fc1.a = p.xn2; fc1.sam = c; fc1.sak = 1;
  fc1.b = p.w1; fc1.sbk = hid; fc1.sbn = 1;
  fc1.M = rows; fc1.N = hid; fc1.K = c;
  fc1.bias = p.b1; fc1.aux = p.h1; fc1.out_t = p.g; fc1.epi = kEpiGeluFwd;
  if ((err = launch_gemm<T>(fc1, 1, s)) != cudaSuccess) return err;

  if ((err = launch_scale_rows<T>(p.dy, p.m2, p.dmlp, rows, c, p.rows_per_image, s)) !=
      cudaSuccess)
    return err;
  if ((err = launch_col_sum<T, T>(p.dmlp, p.db2, nullptr, rows, c, s)) != cudaSuccess) return err;

  GemmArgs dg = input_grad_args(p.dmlp, p.w2, rows, hid, c);
  dg.aux = p.h1; dg.out_t = p.dh1; dg.epi = kEpiGeluBwd;
  if ((err = launch_gemm<T>(dg, 1, s)) != cudaSuccess) return err;
  if ((err = launch_col_sum<T, T>(p.dh1, p.db1, nullptr, rows, hid, s)) != cudaSuccess) return err;

  if ((err = launch_weight_grad<T>(p.g, p.dmlp, p.dw2, rows, hid, c, s)) != cudaSuccess)
    return err;
  if ((err = launch_weight_grad<T>(p.xn2, p.dh1, p.dw1, rows, c, hid, s)) != cudaSuccess)
    return err;

  GemmArgs dxn = input_grad_args(p.dh1, p.w1, rows, c, hid);
  dxn.out_f = p.dxn2;
  if ((err = launch_gemm<T>(dxn, 1, s)) != cudaSuccess) return err;
  return launch_ln_bwd<T>(p.x2, p.dxn2, p.g2, p.dy, p.dx2, p.dg2, p.dbe2, rows, c, p.eps, s);
}

}  // namespace

// x2, dy, dx2 (rows, c); w1 (c, hid), w2 (hid, c) in the storage type; g2, b2,
// b1 fp32 (b1 may be null); m2 (rows / rows_per_image) fp32. Scratch: xn2,
// dmlp (rows, c) and g, dh1 (rows, hid) in the storage type, h1 (rows, hid)
// and dxn2 (rows, c) fp32. Outputs dw1 (c, hid), db1 (hid), dw2 (hid, c),
// db2 (c), dg2, dbe2 (c) are fp32 and must arrive zeroed.
extern "C" int swin_mlp_bwd_launch(
    const void* x2, const void* dy, const void* g2, const void* b2, const void* w1,
    const void* b1, const void* w2, const void* m2, void* xn2, void* h1, void* g, void* dmlp,
    void* dh1, void* dxn2, void* dx2, void* dw1, void* db1, void* dw2, void* db2, void* dg2,
    void* dbe2, int rows, int c, int hid, int rows_per_image, float eps, int dtype,
    void* stream) {
  if (rows <= 0 || c <= 0 || hid <= 0 || rows_per_image <= 0 || rows % rows_per_image != 0)
    return cudaErrorInvalidValue;
  MlpBwdArgs p = {};
  p.x2 = x2; p.dy = dy; p.w1 = w1; p.w2 = w2;
  p.g2 = static_cast<const float*>(g2); p.b2 = static_cast<const float*>(b2);
  p.b1 = static_cast<const float*>(b1); p.m2 = static_cast<const float*>(m2);
  p.xn2 = xn2; p.g = g; p.dmlp = dmlp; p.dh1 = dh1; p.dx2 = dx2;
  p.h1 = static_cast<float*>(h1); p.dxn2 = static_cast<float*>(dxn2);
  p.dw1 = static_cast<float*>(dw1); p.db1 = static_cast<float*>(db1);
  p.dw2 = static_cast<float*>(dw2); p.db2 = static_cast<float*>(db2);
  p.dg2 = static_cast<float*>(dg2); p.dbe2 = static_cast<float*>(dbe2);
  p.rows = rows; p.c = c; p.hid = hid; p.rows_per_image = rows_per_image; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return mlp_bwd_typed<float>(p, s);
  if (dtype == kBFloat16) return mlp_bwd_typed<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}
