// The backbone's shared product (fused_linear.cuh) alone, behind a C entry
// point: for the card tests of its shapes, row maps and epilogues, and for
// timing it beside a library product. The main path reaches the product only
// through B4, B5, B8, B9b, B10a and B10b (their own .cu files). The same for
// the training backwards' product (B9b, B9c): grad_product_launch.
#include "fused_linear.cuh"

// out (M, N) = epilogue(prologue(gather(a)) @ w); a holds rows of K / segs
// gathered by a_map (kMapIdentity, kMapTransition or kMapMerge over a res grid
// of window x window windows, delta as window_layout.cuh says); ln_g / ln_b
// (K) fp32 or null; bias (N) fp32 or null; resid rows of N gathered by
// resid_map, or null; row_scale (M / scale_rows) fp32 or null; ln_rows (M, K)
// scratch in the storage type where there is a LayerNorm prologue (bf16).
// form: the bf16 product's tile form (ops/linear_plan.py; fp32 reads neither
// it nor ln_rows).
extern "C" int fused_linear_launch(const void* a, const void* w, const void* bias,
                                   const void* ln_g, const void* ln_b, const void* resid,
                                   const void* row_scale, void* ln_rows, void* out, int M,
                                   int N, int K, int segs, int a_map, int resid_map, int res,
                                   int window, int delta, int scale_rows, int gelu, float eps,
                                   int form, int dtype, void* stream) {
  if (a_map == kMapRaster || resid_map == kMapRaster || resid_map == kMapMerge || scale_rows < 1)
    return cudaErrorInvalidValue;
  LinearArgs p = {};
  p.a = a; p.w = w; p.bias = static_cast<const float*>(bias);
  p.ln_g = static_cast<const float*>(ln_g); p.ln_b = static_cast<const float*>(ln_b);
  p.resid = resid; p.out = out; p.ln_rows = ln_rows;
  p.row_scale = static_cast<const float*>(row_scale); p.scale_rows = scale_rows;
  p.M = M; p.N = N; p.K = K; p.segs = segs; p.a_map = a_map; p.resid_map = resid_map;
  p.geo = Geometry{res, window, delta}; p.eps = eps; p.gelu = gelu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_linear_wide<float>(p, form, s);
  if (dtype == kBFloat16) return launch_linear_wide<__nv_bfloat16>(p, form, s);
  return cudaErrorInvalidValue;
}

// out (M, N) = A @ B in `layout` (kXW a (M, K) @ b (K, N); kDYWT a (M, K)
// @ b (N, K)^T; kATB a (K, M)^T @ b (K, N)), all row-major with row strides
// lda, ldb; out fp32, or rounded to the operands' type where `rounded` (K
// not split); K in chunks of k_chunk (the plan's,
// ops/linear_plan.py::grad_plan): split, the chunks' fp32 partial slabs go to
// part (chunks, M, N) and are summed in order into out (a second launch);
// else straight into out. form: the bf16 product's tile form (fp32 ignores
// it).
extern "C" int grad_product_launch(const void* a, const void* b, void* part, void* out, int M,
                                   int N, int K, int lda, int ldb, int k_chunk, int layout,
                                   int form, int rounded, int dtype, void* stream) {
  const bool split = k_chunk < K;
  if (k_chunk <= 0 || (split && (part == nullptr || rounded))) return cudaErrorInvalidValue;
  GemmArgs p = {};
  p.a = a; p.lda = lda; p.b = b; p.ldb = ldb;
  p.M = M; p.N = N; p.K = K; p.k_chunk = k_chunk;
  if (rounded)
    p.out_t = out;
  else
    p.out_f = static_cast<float*>(split ? part : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kFloat32   ? launch_grad<float>(p, layout, form, s)
                    : dtype == kBFloat16 ? launch_grad<__nv_bfloat16>(p, layout, form, s)
                                         : cudaErrorInvalidValue;
  if (err != cudaSuccess || !split) return err;
  PartialSums sums = {};
  sums.job[0] = {static_cast<const float*>(part), static_cast<float*>(out),
                 (K + k_chunk - 1) / k_chunk, M * N};
  sums.n = 1;
  return launch_sum_partials(sums, s);
}
