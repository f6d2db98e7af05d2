// K3 and the row-gather probes P1-P4: row gathers from a node-major table
// f32 [n_rows, cols] with int32 row indices.
//
// ppr_gather_segment_sum (K3) replaces the gather_accum mode of
// scripts/bench_pallas_row_gather.py::make (P4), `out[dst[i]] += table[src[i]]`,
// and is the sparse tail of every sparse push operator of the port
// (ops/spmv.py: push_out, push_out_t, pull_out_norm; ops/hub_split.py:
// push_out_hybrid_t). With the edges sorted by destination and a row pointer
// ptr (int64 [n_out + 1]):
//
//     out[d, :] = sum over e in [ptr[d], ptr[d+1]) of table[src[e], :]
//
// summed in edge order in f32 registers; an empty segment gives 0. It takes
// the place of index_select + segment_reduce and never writes their
// [m, cols] per-edge intermediate.
//
// ppr_row_gather replaces P1, P2 and P3 (scripts/probe_mosaic_gather.py:
// vmem_axis0_gather, vmem_dynamic_row_loop, hbm_indexed_row_dma) and the
// gather mode of P4: out[i, :] = table[idx[i], :]. The three TPU probes
// differ only in the TPU mechanism (a vector gather from VMEM, a scalar
// loop, a per-row DMA from HBM); on Hopper the table sits in device memory
// and its rows come through L2, so one kernel is the counterpart of all.
//
// What bounds both on an H100: bytes. Each index moves one cols-wide row
// (a random row read, whose cost is its DRAM or L2 transaction), and each
// output row is written once. The design keeps the reads coalesced and
// wide and writes nothing else: one warp owns one output row and one tile
// of columns; every lane reads the row's index (one broadcast load), then
// its own 16-byte slice of the table row (float4, 128 columns a warp) when
// cols % 4 == 0 and both base pointers are 16-byte aligned, else one float
// (32 columns a warp). K3 loads kUnroll edges' rows before it adds them, so
// several row reads are in flight per warp, and adds them in edge order.
// No shared memory, no atomics: the result has the same bits every run.
// Several warps share a block, on consecutive output rows. Row offsets are
// 64-bit (src * cols passes 2^31 at a million nodes and cols 2048).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kUnroll = 4;
constexpr unsigned kMaxColTiles = 65535;   // gridDim.y limit

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }

__device__ __forceinline__ void add_to(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// T is float (one column a lane) or float4 (four columns a lane).
template <typename T>
__global__ void ppr_gather_segment_sum_kernel(
    const float* __restrict__ table, const int* __restrict__ src,
    const long long* __restrict__ ptr, float* __restrict__ out, int n_out,
    int cols) {
  constexpr int kWidth = sizeof(T) / sizeof(float);
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int col = (blockIdx.y * 32 + lane) * kWidth;
  if (d >= n_out || col >= cols) return;   // no warp-wide operation follows
  const long long lo = ptr[d];
  const long long hi = ptr[d + 1];
  const float* base = table + col;
  T acc = zero<T>();
  long long e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t row = static_cast<size_t>(src[e + u]) * cols;
      v[u] = __ldg(reinterpret_cast<const T*>(base + row));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_to(acc, v[u]);
  }
  for (; e < hi; ++e) {
    const size_t row = static_cast<size_t>(src[e]) * cols;
    add_to(acc, __ldg(reinterpret_cast<const T*>(base + row)));
  }
  *reinterpret_cast<T*>(out + static_cast<size_t>(d) * cols + col) = acc;
}

template <typename T>
__global__ void ppr_row_gather_kernel(const float* __restrict__ table,
                                      const int* __restrict__ idx,
                                      float* __restrict__ out, int rows,
                                      int cols) {
  constexpr int kWidth = sizeof(T) / sizeof(float);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int col = (blockIdx.y * 32 + lane) * kWidth;
  if (i >= rows || col >= cols) return;
  const size_t row = static_cast<size_t>(idx[i]) * cols;
  *reinterpret_cast<T*>(out + static_cast<size_t>(i) * cols + col) =
      __ldg(reinterpret_cast<const T*>(table + row + col));
}

bool use_float4(const float* table, const float* out, int cols) {
  return cols % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(table) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(out) % 16) == 0;
}

// The launch grid: x over output rows (kWarpsPerBlock a block), y over
// column tiles of 32 lanes * width. 0 tiles means the shape is refused.
dim3 grid_for(int rows, int cols, bool vec4) {
  const unsigned per_warp = vec4 ? 128u : 32u;
  const unsigned tiles = (static_cast<unsigned>(cols) + per_warp - 1) / per_warp;
  if (tiles > kMaxColTiles) return dim3(0, 0);
  return dim3((static_cast<unsigned>(rows) + kWarpsPerBlock - 1) /
                  kWarpsPerBlock,
              tiles);
}

}  // namespace

extern "C" {

// K3 on `stream`: out [n_out, cols] from table [*, cols], src [ptr[n_out]],
// ptr [n_out + 1]. Returns cudaGetLastError() (0 on success).
int ppr_gather_segment_sum(const float* table, const int* src,
                           const long long* ptr, float* out, int n_out,
                           int cols, void* stream) {
  if (n_out <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const bool vec4 = use_float4(table, out, cols);
  const dim3 grid = grid_for(n_out, cols, vec4);
  if (grid.x == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4) {
    ppr_gather_segment_sum_kernel<float4><<<grid, kThreads, 0, s>>>(
        table, src, ptr, out, n_out, cols);
  } else {
    ppr_gather_segment_sum_kernel<float><<<grid, kThreads, 0, s>>>(
        table, src, ptr, out, n_out, cols);
  }
  return (int)cudaGetLastError();
}

// P1-P4 gather on `stream`: out [rows, cols] = table[idx[0..rows), :].
// Returns cudaGetLastError() (0 on success).
int ppr_row_gather(const float* table, const int* idx, float* out, int rows,
                   int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const bool vec4 = use_float4(table, out, cols);
  const dim3 grid = grid_for(rows, cols, vec4);
  if (grid.x == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4) {
    ppr_row_gather_kernel<float4><<<grid, kThreads, 0, s>>>(table, idx, out,
                                                            rows, cols);
  } else {
    ppr_row_gather_kernel<float><<<grid, kThreads, 0, s>>>(table, idx, out,
                                                           rows, cols);
  }
  return (int)cudaGetLastError();
}

const char* ppr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
