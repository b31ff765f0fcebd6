// B7 and B8: the stage boundaries of the window-resident Swin backbone.
//
// B7 replaces on_device_image_captioning_tpu/ops/stage_boundary.py::
// patch_embed_fused: space-to-depth rows (B, res, res, K = 48) -> product
// K -> C with bias -> LayerNorm(C) -> stored in window layout
// (B nW, window^2, C). One launch: the output row of window-layout row r
// reads raster row map_row(kMapRaster, r), so the window partition is index
// arithmetic in the loads; a block holds whole 192-wide output rows, so the
// LayerNorm is an epilogue over shared memory.
// Bound: bytes (2 K C flops per row against (K + C) * itemsize bytes,
// 38 flop/byte in bf16): the image rows in and the embedding out.
//
// B8 replaces ops/stage_boundary.py::downsample_fused: window layout in ->
// 2x2 merge in the order (even,even), (odd,even), (even,odd), (odd,odd) ->
// LayerNorm(4C) -> product 4C -> 2C without bias -> window layout out. One
// launch: output row r gathers its four source rows (map_row(kMapMerge, r,
// seg)) side by side along K, the LayerNorm is a prologue over those four
// rows, and the store is contiguous because r already counts in the output's
// window layout. No one-hot selection matrix (merge_selection) exists here.
// Bound: operations or bytes, close to the balance point (16 C^2 flops per
// output row against 12 C bytes in bf16, 1.3 C flop/byte: 256 to 1024). bf16
// runs on warpgroup MMA in the tile form of the wrapper's launch plan, fp32 on
// the CUDA cores (fused_linear.cuh).
#include "fused_linear.cuh"

template <typename T>
static cudaError_t patch_embed_typed(const void* x, const void* w,
                                     const float* bias, const float* ln_g,
                                     const float* ln_b, void* out, int batch,
                                     int res, int window, int k, int c,
                                     float eps, cudaStream_t s) {
  LinearArgs p = {};
  p.a = x; p.w = w; p.bias = bias; p.ln2_g = ln_g; p.ln2_b = ln_b; p.out = out;
  p.M = batch * res * res; p.N = c; p.K = k;
  p.a_map = kMapRaster; p.segs = 1; p.geo = Geometry{res, window, 0};
  p.eps = eps;
  return launch_linear_rows<T>(p, s);
}

template <typename T>
static cudaError_t downsample_typed(const void* x, const float* ln_g,
                                    const float* ln_b, const void* w, void* out,
                                    int batch, int res, int window, int c,
                                    float eps, int form, void* ln_rows,
                                    cudaStream_t s) {
  LinearArgs p = {};
  p.a = x; p.w = w; p.ln_g = ln_g; p.ln_b = ln_b; p.out = out;
  p.M = batch * (res / 2) * (res / 2); p.N = 2 * c; p.K = 4 * c;
  p.a_map = kMapMerge; p.segs = 4; p.geo = Geometry{res, window, 0};
  p.eps = eps;
  p.ln_rows = ln_rows;
  return launch_linear_wide<T>(p, form, s);
}

// x (batch, res, res, k) raster; w (k, c); out (batch * (res/window)^2,
// window^2, c). res must be a multiple of window, c at most 192.
extern "C" int patch_embed_launch(const void* x, const void* w,
                                  const void* bias, const void* ln_g,
                                  const void* ln_b, void* out, int batch,
                                  int res, int window, int k, int c, float eps,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window <= 0 || res % window != 0) return cudaErrorInvalidValue;
  const float* fb = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  if (dtype == kFloat32)
    return patch_embed_typed<float>(x, w, fb, g, b, out, batch, res, window, k,
                                    c, eps, s);
  if (dtype == kBFloat16)
    return patch_embed_typed<__nv_bfloat16>(x, w, fb, g, b, out, batch, res,
                                            window, k, c, eps, s);
  return cudaErrorInvalidValue;
}

// x (batch * (res/window)^2, window^2, c) window layout of a res grid; w
// (4c, 2c); out (batch * (res/2/window)^2, window^2, 2c). res / 2 must be a
// multiple of window. form is the bf16 product's tile form (the launch
// plan's) and ln_rows (rows of out, 4c) scratch in the storage type for the
// merged rows after the LayerNorm; fp32 reads neither.
extern "C" int downsample_launch(const void* x, const void* ln_g,
                                 const void* ln_b, const void* w, void* out,
                                 int batch, int res, int window, int c,
                                 float eps, int form, void* ln_rows, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window <= 0 || res % (2 * window) != 0) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  if (dtype == kFloat32)
    return downsample_typed<float>(x, g, b, w, out, batch, res, window, c, eps, form,
                                   ln_rows, s);
  if (dtype == kBFloat16)
    return downsample_typed<__nv_bfloat16>(x, g, b, w, out, batch, res, window,
                                           c, eps, form, ln_rows, s);
  return cudaErrorInvalidValue;
}
