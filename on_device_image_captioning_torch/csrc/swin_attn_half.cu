// B4: the attention half of a Swin block on the window layout,
// out = x' + proj(window_attention(LN1(x'))), where x' is x itself or, with a
// transition, x read from the previous block's shift layout.
//
// Replaces on_device_image_captioning_tpu/ops/swin_block_fused.py::
// swin_attn_half_fused. The TPU kernel holds a strip of windows, their qkv and
// the weights in VMEM and folds the transition in as one-hot P4 products
// (models/swin.py transition_pieces). A thread block here has 227 KB of shared
// memory: one window's qkv at C = 768 is 144 x 2304 x 2 B = 663 KB and
// LN1(x) alone 221 KB, and the proj product sums over all heads, so one
// block cannot carry a window from x to out at any width but the first.
//
// Bound on the H100: operations. Per row 8 C^2 flops of products plus
// 4 N C of attention against 4 C bytes of x in and out (bf16): about 2 C
// flop/byte, 384 to 1536, above the card's balance point. bf16 runs on the
// tensor cores (nvcuda::wmma in both the products and the attention core),
// fp32 on the CUDA cores as full fp32.
//
// Design: a chain of three launches at every width (C = 192, 384, 768):
//   1. qkv  = LN1(x') @ Wqkv + b     x' gathered by map_row(kMapTransition)
//                                    where the rows are read, LayerNorm
//                                    prologue (fused_linear.cuh)
//   2. attn = window attention core  window_attention.cuh with the fused
//                                    kernels' rounding (q scaled in the
//                                    storage type, division after e.v);
//                                    scores only ever in shared memory
//   3. out  = x' + attn @ Wproj + b  residual rows gathered by the same map
// The transition is index arithmetic in launch 1's loads and launch 3's
// residual reads: no P4 matrix, no separate permuting pass. qkv (rows, 3C)
// and attn (rows, C) go through device memory once each way: 16 C bytes per
// row in bf16 beside the 4 C the function must move. The mask row of a window
// is its index within its image in the TO layout (w % nW), which is the
// layout launch 2 runs in.
#include "fused_linear.cuh"
#include "window_attention.cuh"

template <typename T>
static cudaError_t attn_half_typed(const void* x, const float* ln_g,
                                const float* ln_b, const void* wqkv,
                                const float* bqkv, const void* wproj,
                                const float* bproj, const float* bias,
                                const float* mask, void* qkv, void* attn,
                                void* out, int bw, int n, int c, int heads,
                                int num_windows, float scale, float eps,
                                int map, Geometry geo, int dtype,
                                const float* m1, int rows_per_image,
                                cudaStream_t s) {
  LinearArgs p = {};
  p.a = x; p.w = wqkv; p.bias = bqkv; p.ln_g = ln_g; p.ln_b = ln_b;
  p.out = qkv; p.M = bw * n; p.N = 3 * c; p.K = c;
  p.a_map = map; p.segs = 1; p.geo = geo; p.eps = eps;
  cudaError_t err = launch_linear_wide<T>(p, s);
  if (err != cudaSuccess) return err;
  err = launch_window_attention<true>(qkv, bias, mask, attn, bw, n, c, heads,
                                      num_windows, scale, dtype, s);
  if (err != cudaSuccess) return err;
  LinearArgs q = {};
  q.a = attn; q.w = wproj; q.bias = bproj; q.resid = x; q.resid_map = map;
  q.out = out; q.M = bw * n; q.N = c; q.K = c;
  q.a_map = kMapIdentity; q.segs = 1; q.geo = geo; q.eps = eps;
  q.row_scale = m1; q.scale_rows = rows_per_image;
  return launch_linear_wide<T>(q, s);
}

static int attn_half_dispatch(const void* x, const void* ln_g,
                              const void* ln_b, const void* wqkv,
                              const void* bqkv, const void* wproj,
                              const void* bproj, const void* bias,
                              const void* mask, void* qkv, void* attn,
                              void* out, int bw, int n, int c,
                              int heads, int num_windows, float scale,
                              float eps, int transition, int res,
                              int window, int delta, const void* m1,
                              int rows_per_image, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int map = kMapIdentity;
  Geometry geo = {0, 0, 0};
  if (transition) {
    if (window <= 0 || window * window != n || res % window != 0 ||
        bw % ((res / window) * (res / window)) != 0 || delta < 0 || delta >= res)
      return cudaErrorInvalidValue;
    map = kMapTransition;
    geo = Geometry{res, window, delta};
  }
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const float* fq = static_cast<const float*>(bqkv);
  const float* fp = static_cast<const float*>(bproj);
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  const float* fm1 = static_cast<const float*>(m1);
  if (dtype == kFloat32)
    return attn_half_typed<float>(x, g, b, wqkv, fq, wproj, fp, fbias, fmask, qkv,
                               attn, out, bw, n, c, heads, num_windows, scale,
                               eps, map, geo, dtype, fm1, rows_per_image, s);
  if (dtype == kBFloat16)
    return attn_half_typed<__nv_bfloat16>(x, g, b, wqkv, fq, wproj, fp, fbias,
                                       fmask, qkv, attn, out, bw, n, c, heads,
                                       num_windows, scale, eps, map, geo, dtype,
                                       fm1, rows_per_image, s);
  return cudaErrorInvalidValue;
}

// x, out (bw, n, c); wqkv (c, 3c), wproj (c, c) in the storage type; bias
// (heads, n, n) fp32; mask (num_windows, n, n) fp32 or null; qkv (bw, n, 3c)
// and attn (bw, n, c) scratch. transition != 0 reads x through the window
// transition of a res grid with delta = (to_shift - from_shift) mod res.
extern "C" int swin_attn_half_launch(const void* x, const void* ln_g,
                                     const void* ln_b, const void* wqkv,
                                     const void* bqkv, const void* wproj,
                                     const void* bproj, const void* bias,
                                     const void* mask, void* qkv, void* attn,
                                     void* out, int bw, int n, int c,
                                     int heads, int num_windows, float scale,
                                     float eps, int transition, int res,
                                     int window, int delta, int dtype,
                                     void* stream) {
  return attn_half_dispatch(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                            qkv, attn, out, bw, n, c, heads, num_windows, scale,
                            eps, transition, res, window, delta, nullptr, 1,
                            dtype, stream);
}

// B10a, the training forward (`_attn_half_train_fwd_call`): the same with the
// per-image stochastic-depth scale on the branch, out = x + m1[image] * proj(...),
// where window w belongs to image w / windows_per_image; m1 is fp32 (bw /
// windows_per_image). x is already in the block's layout: the backward saves
// this x, so the transition before it is a launch of its own. The scale
// multiplies the rounded proj output in fp32 in launch 3's epilogue, before
// the residual add and its rounding.
extern "C" int swin_attn_half_train_launch(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* mask, const void* m1, void* qkv, void* attn, void* out, int bw,
    int n, int c, int heads, int num_windows, int windows_per_image, float scale,
    float eps, int dtype, void* stream) {
  if (m1 == nullptr || windows_per_image <= 0 || bw % windows_per_image != 0)
    return cudaErrorInvalidValue;
  return attn_half_dispatch(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask,
                            qkv, attn, out, bw, n, c, heads, num_windows, scale,
                            eps, 0, 0, 0, 0, m1, windows_per_image * n, dtype,
                            stream);
}
