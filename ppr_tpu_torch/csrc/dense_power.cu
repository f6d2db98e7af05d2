// K1 and K2: fused dense propagation for graphs with a dense operator W,
// the row-normalized f32 operator [n, n], n <= 1024, n a multiple of 4.
//
// K1 replaces ppr_tpu/ops/pallas_dense.py::dense_power_iterations (Pallas
// body _ppr_kernel). For each source row b, `iters` rounds of
//
//     p += alpha * r
//     r_d = r * dang                      (residue sitting on dangling nodes)
//     r  = keep * [ (r - r_d) @ W + sum(r_d) * onehot ]   (keep = 1 - alpha)
//
// with the sum(r_d) term dropped when dangling_to_source is 0.
//
// K2 replaces ppr_tpu/ops/pallas_dense.py::dense_pagerank_iterations
// (Pallas body _pagerank_kernel), the Neo4j-library iteration:
//
//     x = teleport * onehot + damping * x @ W,   x0 = teleport * onehot
//
// (teleport = 1 - damping), un-normalized; the caller sum-normalizes.
//
// Design. One block of 256 threads owns a tile of kRowTile source rows.
// Thread t owns output columns t, t + 256, ... (CPT of them), and keeps its
// columns' state (K1: p and r; K2: x) for all kRowTile rows in registers
// for the whole run. Each K1 round:
//   1. every thread updates p, writes x = r - r_d for its columns into
//      shared memory (kRowTile * n floats, at most 32 KB), and reduces its
//      share of sum(r_d); a warp shuffle and one shared array finish the
//      block reduction (every thread sums the warp partials in the same
//      order, so all threads agree bit for bit);
//   2. tile_product: every thread accumulates sum_i x[b, i] * W[i, col] for
//      its columns;
//   3. r is rebuilt in registers.
// A K2 round has no reduction: each thread writes its x into shared memory,
// runs tile_product, and sets x = teleport * onehot + damping * acc for its
// own columns. Its x staging is double-buffered (2 * 32 KB at n = 1024), so
// a round needs one barrier where K1 needs two: the buffer a round writes
// was last read two rounds earlier, before the previous round's barrier.
// The state is written to global memory once, at the end.
//
// What bounds both on an H100: reads of W. Every block streams all of W
// once per round, so a launch reads iters * n^2 * 4 bytes per block (4 MB
// per round at n = 1024). W stays in L2 (50 MB), so this is L2 bandwidth,
// not HBM. Later work can cut it: share W across a thread block cluster
// (distributed shared memory), or run the product on wgmma with an
// error-compensated bf16/tf32 split that keeps f32 accuracy.

#include <cuda_runtime.h>

namespace {

constexpr int kRowTile = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;

// acc[b][c] = sum_i x_s[b * n + i] * W[i, tid + c * kThreads] for the
// block's kRowTile rows, in order i = 0..n-1, with FP32 FMA (no TF32, no
// tensor cores: the TPU kernels run at Precision.HIGHEST). x is read as
// float4 broadcasts from shared memory; W row segments from global memory
// (L2), coalesced across the warp.
template <int CPT>
__device__ __forceinline__ void tile_product(const float* __restrict__ W,
                                             const float* x_s, int n, int tid,
                                             float (&acc)[kRowTile][CPT]) {
#pragma unroll
  for (int b = 0; b < kRowTile; ++b)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[b][c] = 0.0f;

  for (int i = 0; i < n; i += 4) {
    float4 xv[kRowTile];
#pragma unroll
    for (int b = 0; b < kRowTile; ++b)
      xv[b] = *reinterpret_cast<const float4*>(&x_s[b * n + i]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float w[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tid + c * kThreads;
        w[c] = col < n ? __ldg(&W[(size_t)(i + k) * n + col]) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < kRowTile; ++b) {
        const float xb = k == 0 ? xv[b].x : k == 1 ? xv[b].y
                       : k == 2 ? xv[b].z : xv[b].w;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[b][c] = fmaf(xb, w[c], acc[b][c]);
      }
    }
  }
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
ppr_dense_kernel(const float* __restrict__ W, const float* __restrict__ onehot,
                 const float* __restrict__ dang, float* __restrict__ out,
                 int B, int n, int iters, float alpha, float keep,
                 int dangling_to_source) {
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // [kRowTile][n]
  float* red_s = x_s + kRowTile * n;             // [kWarps][kRowTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRowTile;

  float p[kRowTile][CPT];
  float r[kRowTile][CPT];
  float dg[CPT];

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = tid + c * kThreads;
    dg[c] = col < n ? dang[col] : 0.0f;
#pragma unroll
    for (int b = 0; b < kRowTile; ++b) {
      const int row = row0 + b;
      p[b][c] = 0.0f;
      r[b][c] = (col < n && row < B) ? onehot[(size_t)row * n + col] : 0.0f;
    }
  }

  for (int it = 0; it < iters; ++it) {
    // --- phase 1: p update, x = r - r_d into shared, dangling partials ---
    float part[kRowTile];
#pragma unroll
    for (int b = 0; b < kRowTile; ++b) {
      part[b] = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tid + c * kThreads;
        if (col < n) {
          const float rv = r[b][c];
          p[b][c] = p[b][c] + alpha * rv;
          const float rd = rv * dg[c];
          part[b] += rd;
          x_s[b * n + col] = rv - rd;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[b] += __shfl_xor_sync(0xffffffffu, part[b], off);
      if (lane == 0) red_s[warp * kRowTile + b] = part[b];
    }
    __syncthreads();

    float dm[kRowTile];
#pragma unroll
    for (int b = 0; b < kRowTile; ++b) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red_s[w * kRowTile + b];
      dm[b] = s;
    }

    // --- phase 2: acc[b][c] = sum_i x[b, i] * W[i, col] ---
    float acc[kRowTile][CPT];
    tile_product<CPT>(W, x_s, n, tid, acc);

    // --- phase 3: new residue ---
#pragma unroll
    for (int b = 0; b < kRowTile; ++b) {
      const int row = row0 + b;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tid + c * kThreads;
        float pushed = acc[b][c];
        if (dangling_to_source && col < n && row < B)
          pushed = pushed + dm[b] * onehot[(size_t)row * n + col];
        r[b][c] = keep * pushed;
      }
    }
    __syncthreads();  // x_s and red_s are rewritten next round
  }

#pragma unroll
  for (int b = 0; b < kRowTile; ++b) {
    const int row = row0 + b;
    if (row >= B) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + c * kThreads;
      if (col < n) out[(size_t)row * n + col] = p[b][c];
    }
  }
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
ppr_pagerank_kernel(const float* __restrict__ W,
                    const float* __restrict__ onehot, float* __restrict__ out,
                    int B, int n, int iters, float damping, float teleport) {
  extern __shared__ float4 smem4[];
  float* x_buf = reinterpret_cast<float*>(smem4);  // [2][kRowTile][n]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowTile;

  float x[kRowTile][CPT];
#pragma unroll
  for (int b = 0; b < kRowTile; ++b) {
    const int row = row0 + b;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + c * kThreads;
      x[b][c] = (col < n && row < B)
                    ? teleport * onehot[(size_t)row * n + col] : 0.0f;
    }
  }

  for (int it = 0; it < iters; ++it) {
    float* x_s = x_buf + (it & 1) * kRowTile * n;
#pragma unroll
    for (int b = 0; b < kRowTile; ++b)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tid + c * kThreads;
        if (col < n) x_s[b * n + col] = x[b][c];
      }
    __syncthreads();

    float acc[kRowTile][CPT];
    tile_product<CPT>(W, x_s, n, tid, acc);

#pragma unroll
    for (int b = 0; b < kRowTile; ++b) {
      const int row = row0 + b;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tid + c * kThreads;
        const float base = (col < n && row < B)
            ? teleport * __ldg(&onehot[(size_t)row * n + col]) : 0.0f;
        x[b][c] = base + damping * acc[b][c];
      }
    }
  }

#pragma unroll
  for (int b = 0; b < kRowTile; ++b) {
    const int row = row0 + b;
    if (row >= B) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + c * kThreads;
      if (col < n) out[(size_t)row * n + col] = x[b][c];
    }
  }
}

template <int CPT>
void launch(const float* W, const float* onehot, const float* dang, float* out,
            int B, int n, int iters, float alpha, float keep, int dts,
            cudaStream_t stream) {
  const size_t smem = (size_t)(kRowTile * n + kWarps * kRowTile) * sizeof(float);
  const dim3 grid((B + kRowTile - 1) / kRowTile);
  ppr_dense_kernel<CPT><<<grid, kThreads, smem, stream>>>(
      W, onehot, dang, out, B, n, iters, alpha, keep, dts);
}

template <int CPT>
cudaError_t launch_pagerank(const float* W, const float* onehot, float* out,
                            int B, int n, int iters, float damping,
                            float teleport, cudaStream_t stream) {
  const int smem = 2 * kRowTile * n * (int)sizeof(float);
  // above 48 KB a block's dynamic shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      ppr_pagerank_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kRowTile - 1) / kRowTile);
  ppr_pagerank_kernel<CPT><<<grid, kThreads, smem, stream>>>(
      W, onehot, out, B, n, iters, damping, teleport);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
int ppr_dense_power_iterations(const float* W, const float* onehot,
                               const float* dang, float* out, int B, int n,
                               int iters, float alpha, float keep,
                               int dangling_to_source, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN || n % 4 != 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch ((n + kThreads - 1) / kThreads) {
    case 1: launch<1>(W, onehot, dang, out, B, n, iters, alpha, keep,
                      dangling_to_source, s); break;
    case 2: launch<2>(W, onehot, dang, out, B, n, iters, alpha, keep,
                      dangling_to_source, s); break;
    case 3: launch<3>(W, onehot, dang, out, B, n, iters, alpha, keep,
                      dangling_to_source, s); break;
    default: launch<4>(W, onehot, dang, out, B, n, iters, alpha, keep,
                       dangling_to_source, s); break;
  }
  return (int)cudaGetLastError();
}

// Launches K2 on `stream`; returns a CUDA error code (0 on success).
int ppr_dense_pagerank_iterations(const float* W, const float* onehot,
                                  float* out, int B, int n, int iters,
                                  float damping, float teleport,
                                  void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN || n % 4 != 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch ((n + kThreads - 1) / kThreads) {
    case 1: return (int)launch_pagerank<1>(W, onehot, out, B, n, iters,
                                           damping, teleport, s);
    case 2: return (int)launch_pagerank<2>(W, onehot, out, B, n, iters,
                                           damping, teleport, s);
    case 3: return (int)launch_pagerank<3>(W, onehot, out, B, n, iters,
                                           damping, teleport, s);
    default: return (int)launch_pagerank<4>(W, onehot, out, B, n, iters,
                                            damping, teleport, s);
  }
}

const char* ppr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
