// Start-up kernel for NVIDIA Hopper (sm_90a): o = x + 1.
//
// Replaces the one-op Pallas kernel of cuda_satabsearch_tpu/core/warmup.py
// warm_backend (inline `kernel` :48-49, pallas_call :51), which ran once
// to open the TPU's compile session.  Here it is launched once when a
// search session starts (core/warmup.py), on f32[8, 128], so the CUDA
// context and the kernel library (built with nvcc at first use) are
// brought up before the first search.  Plain PyTorch version: x + 1.
// Built into the same library as csrc/sa_search.cu (ops/sa_kernel.py).

#include <cuda_runtime.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// Launches o = x + 1 over n floats on `stream`; returns the cudaError_t
// of the launch (0 = success).
int add_one_launch(const float* x, float* o, int n, void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (n + kThreads - 1) / kThreads;
  add_one_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
