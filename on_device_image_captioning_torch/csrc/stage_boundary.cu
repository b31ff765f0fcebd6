// B7 and B8: the stage boundaries of the window-resident Swin backbone.
//
// B7 replaces on_device_image_captioning_tpu/ops/stage_boundary.py::
// patch_embed_fused: space-to-depth rows (B, res, res, K = 48) -> product
// K -> C with bias -> LayerNorm(C) -> stored in window layout
// (B nW, window^2, C). Output row r of the window layout reads raster row
// map_row(kMapRaster, r), so the window partition is index arithmetic in the
// loads. Bound: bytes (2 K C flops per row against (K + C) * itemsize bytes,
// 38 flop/byte in bf16): the image rows in and the embedding out.
//   bf16 at C = 192 (Swin-L's width; K a multiple of 16 up to 48):
//   patch_embed_wgmma_kernel, one warpgroup a CTA, persistent: the CTA keeps
//   W (K x 192, 18 KB at K = 48) in shared memory for all its tiles and walks
//   row tiles of 64, blockIdx.x, + gridDim.x, ... (the grid from
//   ops/stage_boundary.py::embed_plan: as few CTAs as give every one the same
//   number of tiles in the card's slots). The next tiles' 96-byte input rows
//   come in by cp.async, kEmbedStages - 1 tiles ahead, while the current tile
//   computes; the product is K / 16 steps of wgmma m64n192k16 with fp32
//   accumulators; the epilogue adds the bias and rounds, takes the 192-wide
//   row's LayerNorm on the accumulators in registers (a row's values lie on a
//   quad of lanes: both sums are quad shuffles), rounds once more and stages
//   the tile in shared memory, from which whole 384-byte rows go out in
//   16-byte stores, each warp its own 16 rows. Three CTAs an SM (168
//   registers): two (188 registers) took a third longer at B = 2 and b8.
//   fp32, and other widths: fused_linear_kernel on the CUDA cores (32 x 192,
//   the LayerNorm an epilogue over shared memory).
//
// B8 replaces ops/stage_boundary.py::downsample_fused: window layout in ->
// 2x2 merge in the order (even,even), (odd,even), (even,odd), (odd,odd) ->
// LayerNorm(4C) -> product 4C -> 2C without bias -> window layout out.
// Output row r gathers its four source rows (map_row(kMapMerge, r, seg))
// side by side along K, and the store is contiguous because r already counts
// in the output's window layout. No one-hot selection matrix
// (merge_selection) exists here. Bound: operations or bytes, close to the
// balance point (16 C^2 flops per output row against 12 C bytes in bf16,
// 1.3 C flop/byte: 256 to 1024; at stage 2 the weight's 9.4 MB set it).
//   bf16, in the route, tile and split of ops/linear_plan.py::merge_plan:
//   where the tiles leave CTA slots idle (stage 2 at every batch, stages 0
//   and 1 at b1 and B = 2), the MERGE form of the shared product
//   (fused_linear.cuh): a pre-pass of 8 bytes a row (mean, 1/sqrt(var +
//   eps)), then the product, which normalizes each gathered A slab in its
//   ring (no (M, 4C) scratch written and read back) and splits K over a
//   cluster along z. Where the tiles fill the card (b8 stages 0 and 1), the
//   scratch route: ln_rows_kernel writes the normalized (M, 4C) rows once and
//   the plain form reads them, K whole (normalizing in the ring would repeat
//   the work for each of the row's 3 to 6 column tiles: measured slower
//   there, PERF.md).
//   fp32: fused_linear_kernel on the CUDA cores, the LayerNorm applied as A
//   is stored, K not split.
#include "fused_linear.cuh"

namespace {

constexpr int kEmbedN = 192;      // output width of the bf16 kernel (wgmma n192)
constexpr int kEmbedRows = 64;    // rows a tile: one warpgroup's wgmma m64
constexpr int kEmbedThreads = 128;
constexpr int kEmbedMaxK = 48;    // an input row of up to 96 bytes (Swin's 4 x 4 x 3)
constexpr int kEmbedStages = 3;   // tiles in flight in the input ring
constexpr int kEmbedCtas = 3;     // CTAs an SM (the launch bounds: 168 registers)
constexpr int kEmbedStage = kEmbedRows * 128;         // bytes of a ring stage
constexpr int kEmbedStaged = kEmbedN * 2 + 16;        // bytes of a staged output row
// dynamic shared memory: 1024 to align, W (three 64-column blocks of K rows
// of 128 bytes), the ring, the staged tile, bias and LayerNorm scale and shift
constexpr int kEmbedSmem = 1024 + 3 * kEmbedMaxK * 128 + kEmbedStages * kEmbedStage +
                           kEmbedRows * kEmbedStaged + 3 * kEmbedN * 4;
static_assert(kEmbedCtas * (kEmbedSmem + 1024) <= 233472, "an SM's shared memory");

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct EmbedArgs {
  const __nv_bfloat16* x;  // (M) raster rows of K
  const __nv_bfloat16* w;  // (K, 192) row-major
  const float* bias;       // (192)
  const float* ln_g;       // (192)
  const float* ln_b;       // (192)
  __nv_bfloat16* out;      // (M, 192) window layout
  int M;  // rows (the launcher refuses 2^31 or more)
  int K;
  int tiles;  // ceil(M / 64)
  Geometry geo;
  float eps;
};

__global__ void __launch_bounds__(kEmbedThreads, kEmbedCtas)
    patch_embed_wgmma_kernel(EmbedArgs p) {
  typedef __nv_bfloat16 T;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* w_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int wblock = p.K * 128;  // bytes of a 64-column block of W (a multiple of 1024)
  uint8_t* ring = w_s + 3 * wblock;
  uint8_t* staged = ring + kEmbedStages * kEmbedStage;
  float2* prm = reinterpret_cast<float2*>(staged + kEmbedRows * kEmbedStaged);
  const uint32_t w_u = smem_u32(w_s), ring_u = smem_u32(ring);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // bias, LayerNorm scale and shift as pairs of columns (2 c, 2 c + 1)
  for (int i = tid; i < kEmbedN / 2; i += kEmbedThreads) {
    prm[i] = make_float2(p.bias[2 * i], p.bias[2 * i + 1]);
    prm[kEmbedN / 2 + i] = make_float2(p.ln_g[2 * i], p.ln_g[2 * i + 1]);
    prm[kEmbedN + i] = make_float2(p.ln_b[2 * i], p.ln_b[2 * i + 1]);
  }
  // W as three 64-column blocks of K rows of 128 bytes in the 128-byte
  // swizzle, MN-major for the transpose bit (fused_linear.cuh's W slabs)
  for (int e = tid; e < p.K * (kEmbedN / 8); e += kEmbedThreads) {
    const int kr = e / (kEmbedN / 8), ch = e % (kEmbedN / 8);
    cp_async16(w_u + (ch >> 3) * wblock + kr * 128 + (((ch & 7) ^ (kr & 7)) << 4),
               p.w + static_cast<long>(kr) * kEmbedN + ch * 8, true);
  }
  // tile t's input rows into stage s: two threads a row, row m of the tile
  // (output row 64 t + m, window layout) reading raster row (img, y, x) in
  // 32-bit arithmetic once a thread (window_layout.cuh's map, M < 2^31),
  // K-major in the 128-byte swizzle
  const int m_ld = tid >> 1, half = tid & 1, cpr = p.K / 8;
  const int n = p.geo.window * p.geo.window, wn = p.geo.res / p.geo.window;
  const int per_img = p.geo.res * p.geo.res;
  auto load = [&](int t, int s) {
    const int r = t * kEmbedRows + m_ld;
    const bool ok = r < p.M;
    int src = 0;
    if (ok) {
      const int img = r / per_img, f = r - img * per_img, w = f / n, q = f - w * n;
      const int wy = w / wn, qy = q / p.geo.window;
      const int y = wy * p.geo.window + qy, x = (w - wy * wn) * p.geo.window + q -
                                                qy * p.geo.window;
      src = (img * p.geo.res + y) * p.geo.res + x;
    }
    const T* row = p.x + static_cast<long>(src) * p.K;
    for (int c = half; c < cpr; c += 2)
      cp_async16(ring_u + s * kEmbedStage + m_ld * 128 + ((c ^ (m_ld & 7)) << 4), row + c * 8,
                 ok);
  };
  const int t0 = blockIdx.x, step = gridDim.x;
#pragma unroll
  for (int i = 0; i < kEmbedStages - 1; ++i) {  // one commit group a tile (W in the first)
    if (t0 + i * step < p.tiles) load(t0 + i * step, i);
    cp_async_commit();
  }

  // accumulator d[4 j + 2 h + b] of lane l in warp v is row 16 v + l / 4 +
  // 8 h, column 8 j + 2 (l % 4) + b of the tile; warp v stages and stores
  // its own 16 rows
  const int r0 = warp * 16 + (lane >> 2), cq = lane & 3;
  uint8_t* wstaged = staged + warp * 16 * kEmbedStaged;
  for (int i = 0, t = t0; t < p.tiles; ++i, t += step) {
    const int s = i % kEmbedStages;
    cp_async_wait<kEmbedStages - 2>();  // tile i's rows (and W) have landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; every warp is done with tile i - 1
    const int next = t + (kEmbedStages - 1) * step;  // into the stage tile i - 1 used
    if (next < p.tiles) load(next, (i + kEmbedStages - 1) % kEmbedStages);
    cp_async_commit();

    float acc[96];
#pragma unroll
    for (int e = 0; e < 96; ++e) acc[e] = 0.f;
    fence_acc(acc);
    wgmma_fence();
    for (int kk = 0; kk < p.K / 16; ++kk)
      wgmma_t_n192<0, 1>(acc, smem_desc(ring_u + s * kEmbedStage + kk * 32, 16, 1024, 1),
                         smem_desc(w_u + kk * 2048, wblock, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);

    // + bias, rounded (the product's output), then the row's LayerNorm:
    // fp32 statistics in two passes over the rounded values, the result
    // rounded once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const float2 b = prm[4 * j + cq];
        const float v0 = round_t<T>(acc[4 * j + 2 * h] + b.x);
        const float v1 = round_t<T>(acc[4 * j + 2 * h + 1] + b.y);
        acc[4 * j + 2 * h] = v0;
        acc[4 * j + 2 * h + 1] = v1;
        sum += v0 + v1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum / kEmbedN;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const float d0 = acc[4 * j + 2 * h] - mean, d1 = acc[4 * j + 2 * h + 1] - mean;
        sq = fmaf(d0, d0, sq);
        sq = fmaf(d1, d1, sq);
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      const float rstd = 1.0f / sqrtf(sq / kEmbedN + p.eps);
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const float2 g = prm[kEmbedN / 2 + 4 * j + cq], b = prm[kEmbedN + 4 * j + cq];
        const float y0 = (acc[4 * j + 2 * h] - mean) * rstd * g.x + b.x;
        const float y1 = (acc[4 * j + 2 * h + 1] - mean) * rstd * g.y + b.y;
        *reinterpret_cast<__nv_bfloat162*>(staged + (r0 + 8 * h) * kEmbedStaged +
                                           (8 * j + 2 * cq) * 2) = __floats2bfloat162_rn(y0, y1);
      }
    }
    __syncwarp();
    // the warp's 16 rows, whole, in 16-byte chunks (the tile's rows are
    // consecutive output rows)
    constexpr int CH = kEmbedN / 8;
#pragma unroll
    for (int e = lane; e < 16 * CH; e += 32) {
      const int row = e / CH, ch = e % CH;
      const int r = t * kEmbedRows + warp * 16 + row;
      if (r < p.M)
        *reinterpret_cast<uint4*>(p.out + static_cast<long>(r) * kEmbedN + ch * 8) =
            *reinterpret_cast<const uint4*>(wstaged + row * kEmbedStaged + ch * 16);
    }
    __syncwarp();  // the warp's staged rows are read before its next tile's are written
  }
  cp_async_wait<0>();  // nothing in flight when the CTA leaves
}

cudaError_t patch_embed_bf16(const EmbedArgs& p, int ctas, cudaStream_t s) {
  if (p.K < 16 || p.K > kEmbedMaxK || p.K % 16 != 0 || ctas < 1 || p.M < 1)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      patch_embed_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kEmbedSmem);
  if (attr != cudaSuccess) return attr;
  patch_embed_wgmma_kernel<<<static_cast<unsigned>(ctas), kEmbedThreads, kEmbedSmem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t patch_embed_rows(const void* x, const void* w, const float* bias, const float* ln_g,
                             const float* ln_b, void* out, int batch, int res, int window, int k,
                             int c, float eps, cudaStream_t s) {
  LinearArgs p = {};
  p.a = x; p.w = w; p.bias = bias; p.ln2_g = ln_g; p.ln2_b = ln_b; p.out = out;
  p.M = batch * res * res; p.N = c; p.K = k;
  p.a_map = kMapRaster; p.segs = 1; p.geo = Geometry{res, window, 0};
  p.eps = eps;
  return launch_linear_rows<T>(p, s);
}

LinearArgs downsample_args(const void* x, const float* ln_g, const float* ln_b, const void* w,
                           void* out, int batch, int res, int window, int c, float eps) {
  LinearArgs p = {};
  p.a = x; p.w = w; p.ln_g = ln_g; p.ln_b = ln_b; p.out = out;
  p.M = batch * (res / 2) * (res / 2); p.N = 2 * c; p.K = 4 * c;
  p.a_map = kMapMerge; p.segs = 4; p.geo = Geometry{res, window, 0};
  p.eps = eps;
  return p;
}

}  // namespace

// x (batch, res, res, k) raster; w (k, c); out (batch * (res/window)^2,
// window^2, c). res must be a multiple of window. ctas > 0: the bf16 kernel
// (c = 192, k a multiple of 16 up to 48, kEmbedMaxK) on that many
// persistent CTAs (the launch plan's); ctas = 0: the CUDA cores' kernel
// (fp32, or bf16 at any c up to 192).
extern "C" int patch_embed_launch(const void* x, const void* w,
                                  const void* bias, const void* ln_g,
                                  const void* ln_b, void* out, int batch,
                                  int res, int window, int k, int c, float eps,
                                  int ctas, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window <= 0 || res % window != 0 || ctas < 0) return cudaErrorInvalidValue;
  const float* fb = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  if (ctas > 0) {
    if (dtype != kBFloat16 || c != kEmbedN) return cudaErrorInvalidValue;
    EmbedArgs p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.w = static_cast<const __nv_bfloat16*>(w);
    p.bias = fb; p.ln_g = g; p.ln_b = b;
    p.out = static_cast<__nv_bfloat16*>(out);
    const long rows = static_cast<long>(batch) * res * res;
    if (rows >= (1L << 31) - kEmbedRows) return cudaErrorInvalidValue;
    p.M = static_cast<int>(rows);
    p.K = k;
    p.tiles = (p.M + kEmbedRows - 1) / kEmbedRows;
    p.geo = Geometry{res, window, 0};
    p.eps = eps;
    return patch_embed_bf16(p, ctas, s);
  }
  if (dtype == kFloat32)
    return patch_embed_rows<float>(x, w, fb, g, b, out, batch, res, window, k, c, eps, s);
  if (dtype == kBFloat16)
    return patch_embed_rows<__nv_bfloat16>(x, w, fb, g, b, out, batch, res, window, k, c, eps,
                                           s);
  return cudaErrorInvalidValue;
}

// x (batch * (res/window)^2, window^2, c) window layout of a res grid; w
// (4c, 2c); out (batch * (res/2/window)^2, window^2, 2c). res / 2 must be a
// multiple of window. bf16: form (an index of kProductForms), splits and
// k_chunk are the launch plan's (ops/linear_plan.py::merge_plan). splits = 1
// is the scratch route: scratch holds (rows of out, 4c) bf16 for the
// normalized rows; splits > 1 the MERGE form: scratch holds (rows of out)
// float2 for the pre-pass's row statistics. prologue_ready = 1 launches the
// product alone, on what an earlier launch left in scratch. fp32 reads none
// of them.
extern "C" int downsample_launch(const void* x, const void* ln_g,
                                 const void* ln_b, const void* w, void* out,
                                 int batch, int res, int window, int c,
                                 float eps, int form, int splits, int k_chunk, void* scratch,
                                 int prologue_ready, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window <= 0 || res % (2 * window) != 0) return cudaErrorInvalidValue;
  LinearArgs p = downsample_args(x, static_cast<const float*>(ln_g),
                                 static_cast<const float*>(ln_b), w, out, batch, res, window, c,
                                 eps);
  if (dtype == kFloat32) return launch_linear_wide<float>(p, form, s);
  if (dtype != kBFloat16 || scratch == nullptr || splits < 1) return cudaErrorInvalidValue;
  if (splits > 1) {
    p.row_stats = static_cast<float2*>(scratch);
    p.k_chunk = k_chunk;
    return launch_merge(p, form, splits, prologue_ready != 0, s);
  }
  if (k_chunk != p.K) return cudaErrorInvalidValue;
  p.ln_rows = scratch;
  if (prologue_ready != 0) {  // the product alone, on the normalized rows
    p.a = scratch;
    p.a_map = kMapIdentity;
    p.segs = 1;
    p.ln_g = p.ln_b = nullptr;
  }
  return launch_linear_wide<__nv_bfloat16>(p, form, s);
}
