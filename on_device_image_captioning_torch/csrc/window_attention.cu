// K1's C entry point: the window-attention core of window_attention.cuh with
// window_attention_pallas's rounding (see the header for the kernel, its
// bound and its design).
#include "window_attention.cuh"

extern "C" int window_attention_launch(const void* qkv, const void* bias,
                                       const void* mask, void* out, int bw,
                                       int n, int c, int heads,
                                       int num_windows, float scale, int dtype,
                                       void* stream) {
  return launch_window_attention<false>(qkv, bias, mask, out, bw, n, c, heads,
                                        num_windows, scale, dtype,
                                        static_cast<cudaStream_t>(stream));
}
