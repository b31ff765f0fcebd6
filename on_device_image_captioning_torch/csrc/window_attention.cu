// K1's C entry point: the window-attention core of window_attention.cuh with
// window_attention_pallas's rounding (see the header for the kernels, their
// bound and their design); heads_per_cta and splits are the launch plan's
// (ops/window_attention.py::attention_plan).
#include "window_attention.cuh"

extern "C" int window_attention_launch(const void* qkv, const void* bias,
                                       const void* mask, void* out, int bw,
                                       int n, int c, int heads,
                                       int num_windows, float scale,
                                       int heads_per_cta, int splits, int dtype,
                                       void* stream) {
  return launch_window_attention<false>(qkv, bias, mask, out, bw, n, c, heads,
                                        num_windows, scale, heads_per_cta, splits,
                                        dtype, static_cast<cudaStream_t>(stream));
}

// The registers and local memory a thread of each kernel instance above
// (window_attention.cuh::attention_attributes; ops/window_attention.py::
// kernel_resources).
extern "C" int window_attention_attributes(int which, int* registers, int* local_bytes) {
  return attention_attributes<false>(which, registers, local_bytes);
}
