// K0: the toolchain probe, y = 2x on f32.
//
// Replaces the canary kernel `k` of ppr_tpu/ops/pallas_dense.py
// (_CANARY_CODE), which the JAX package compiles and runs once before it
// trusts its Pallas kernels. Here the probe shows that nvcc built a library
// for this card and that a kernel from it launches and computes: the
// wrapper (ops/probe.py) runs it once per process on a [8, 128] tensor of
// ones before the first dense-kernel launch and checks the result bit for
// bit. It reads and writes 4 KB; launch latency is all it costs.

#include <cuda_runtime.h>

namespace {

__global__ void ppr_probe_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" {

// Launches K0 on `stream`; returns cudaGetLastError() (0 on success).
int ppr_probe_double(const float* x, float* y, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  ppr_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(x, y, n);
  return (int)cudaGetLastError();
}

const char* ppr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
