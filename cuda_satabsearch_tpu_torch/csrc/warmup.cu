// Start-up kernel for NVIDIA Hopper (sm_90a): o = x + 1.
//
// Replaces the one-op Pallas kernel of cuda_satabsearch_tpu/core/warmup.py
// warm_backend (inline `kernel` :48-49, pallas_call :51), which ran once
// to open the TPU's compile session.  Here it is launched once when a
// search session starts (core/warmup.py), on f32[8, 128], so the CUDA
// context and the kernel library (built with nvcc at first use) are
// brought up before the first search.  Plain PyTorch version: x + 1.
// Built into the same library as csrc/sa_search.cu (ops/sa_kernel.py).
//
// Bound: the launch, not the card.  f32[8, 128] is 4 KB, a microsecond
// or two of device work; a call's time is the host's launch path.  So
// the work is one CTA of 256 threads, each moving one 128-bit float4
// (f32[8, 128] is exactly 256 float4s), with no grid to schedule beyond
// one SM.  Other sizes loop over the same CTA shape (grid-stride), and a
// scalar tail takes the last n % 4 floats; pointers not 16-byte aligned
// take the scalar path throughout.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
    add_one_vec4(const float4* __restrict__ x, float4* __restrict__ o,
                 const float* __restrict__ xs, float* __restrict__ os,
                 int nvec, int n) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < nvec; i += stride) {
    float4 v = x[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    o[i] = v;
  }
  // scalar tail: the last n - 4 * nvec (< 4) floats
  const int t = 4 * nvec + blockIdx.x * kThreads + threadIdx.x;
  if (t < n) os[t] = xs[t] + 1.0f;
}

__global__ void __launch_bounds__(kThreads)
    add_one_scalar(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    o[i] = x[i] + 1.0f;
}

int blocks_for(int items) {
  const int b = (items + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace

extern "C" {

// Launches o = x + 1 over n floats on `stream`; returns the cudaError_t
// of the launch (0 = success).
int add_one_launch(const float* x, float* o, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (aligned) {
    const int nvec = n / 4;
    add_one_vec4<<<blocks_for(nvec), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o), x,
        o, nvec, n);
  } else {
    add_one_scalar<<<blocks_for(n), kThreads, 0, s>>>(x, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
