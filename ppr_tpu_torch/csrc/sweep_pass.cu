// The annealed top-k loop's passes over its node-major state [n_rows, cols]
// (models/fora.py::annealed_topk_propagate), fused into the two passes that
// sit around the push, and the loop's scalar bookkeeping.
//
// Replaces no Pallas kernel: on the TPU, XLA fused these elementwise passes
// and column reductions into the sweep's while-loop body. In eager PyTorch
// they were some sixteen separate kernels a sweep (addcmul, r * keep,
// times 1/d, the cast to bf16, the source add over a [n_rows, cols] one-hot,
// where, the column sums, the stopping count), each a full pass over the
// state, and about twenty launches on 0-dimensional tensors.
//
// ppr_sweep_pre, one pass, reads p and r and writes, per element,
//
//     p      = p + r * c                 c = alpha while the loop is live, else 0
//     scaled = (r * keep) * inv_deg[v]   (r * keep where the push scales nothing)
//     bf16   = scaled rounded to bf16    (only with a bf16 hub product)
//
// each rounded as the plain sequence of PyTorch operators rounds it on the
// card: p as one fma, which is what torch.addcmul computes there (torch
// 2.11, H100: equal on 2^22 draws, where p + r * c rounded twice differs in
// 9%), the products each rounded (__fmul_rn, so that nvcc contracts nothing);
// and per block and column the count of p >= (1 + eps') * delta, the
// stopping rule's count, on the updated p with this sweep's delta.
//
// ppr_sweep_post, one pass over the push's output, adds each column's
// dangling mass at its source row (cols elements) and writes per block and
// column the sums of the new residue. On a frozen sweep (after `finished`,
// at most 7 a call) it copies the old residue into the push's output
// instead, which the caller then keeps: the state is unchanged bit for bit.
//
// ppr_sweep_finalize, one small launch, adds up the partial sums and counts
// and updates the loop's device scalars: settled, done, finished, delta and
// the sweep count, as the plain sequence does.
//
// What bounds them on an H100: bytes. One pass over the state at the
// flickr cell (80,640 x 2,048 f32) is 660.6 MB, 0.197 ms at 3.35 TB/s; the
// pre pass moves 4.5 of them (read p and r, write p and scaled, half a pass
// of bf16), the post pass 1. The design streams each element once:
//
// * Layout. A thread takes `vec` consecutive columns of one row (16-byte
//   loads where the columns are a multiple of 4 and the bases aligned, else
//   one float), tx threads span the columns of a tile (tx * vec up to 1,024
//   columns), and the 256 // tx rows of a block lie next to each other, so
//   a warp reads whole lines at every batch width. Blocks walk the rows
//   with a stride; the grid is the card's SMs times 8 blocks, cut to the
//   rows there are.
// * Reductions without atomics on floats. Each thread adds its rows in
//   order in registers, the block adds its rows of threads in order in
//   shared memory and writes one partial a column; the finalize adds the
//   partials in a fixed order. The grid depends only on the shape and the
//   card, so two launches give the same bits. The column sums differ from
//   torch.sum's only in the order of the f32 additions; counts are exact.
//   Across the finalize's blocks only exact operations meet (an unsigned
//   max of non-negative floats, an OR), and its last block updates the
//   scalars.
// * The source add touches cols elements: the source row of each column
//   comes as an int32 [cols], in place of a [n_rows, cols] one-hot.
//
// At the flickr state the pre pass takes 1.07-1.08 ms (82% of its bound) and
// the post pass 0.23-0.24 ms (81-85%) at B 2,048; 0.14 and 0.035 ms (77% and
// 68%) at B 256. Measured and not kept: two or four rows loaded before the
// arithmetic (56 and 80 registers in the pre pass), 4 or 16 blocks an SM in
// place of 8: all within 3% of this layout. (NVIDIA H100 80GB HBM3 at 700 W,
// 20 launches between CUDA events.)
//
// The C functions keep no state between launches, do not synchronise and
// allocate nothing; each returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;           // threads a pass block
constexpr int kFinCols = 32;            // columns a finalize block
constexpr int kFinSlices = 8;           // partial rows a finalize column splits into

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using F = float;
  __device__ static float get(const float& v, int) { return v; }
  __device__ static void set(float& v, int, float x) { v = x; }
};
template <>
struct Vec<4> {
  using F = float4;
  __device__ static float get(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  __device__ static void set(float4& v, int j, float x) {
    if (j == 0) v.x = x; else if (j == 1) v.y = x; else if (j == 2) v.z = x;
    else v.w = x;
  }
};

// V floats rounded to bf16 (to nearest even, as torch's cast) and stored
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst,
                                           const float (&x)[V]);
template <>
__device__ __forceinline__ void store_bf16<1>(__nv_bfloat16* dst,
                                              const float (&x)[1]) {
  dst[0] = __float2bfloat16_rn(x[0]);
}
template <>
__device__ __forceinline__ void store_bf16<4>(__nv_bfloat16* dst,
                                              const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// The block's partial of each of its columns: the rows of threads added in
// order (row of threads 0 first), written by row 0 into out[blockIdx.y, :].
template <int V, typename T>
__device__ __forceinline__ void block_partial(const T (&acc)[V], T* shared,
                                              T* out, int cols, int col0,
                                              bool active) {
  const int tx = threadIdx.x, ty = threadIdx.y, nx = blockDim.x;
#pragma unroll
  for (int j = 0; j < V; ++j) shared[(ty * nx + tx) * V + j] = acc[j];
  __syncthreads();
  if (ty != 0 || !active) return;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    T total = shared[tx * V + j];
    for (int y = 1; y < (int)blockDim.y; ++y) total += shared[(y * nx + tx) * V + j];
    out[(size_t)blockIdx.y * cols + col0 + j] = total;
  }
}

template <int V, bool kScale, bool kBf16>
__global__ void __launch_bounds__(kThreads) ppr_sweep_pre_kernel(
    float* __restrict__ p, const float* __restrict__ r,
    const bool* __restrict__ finished, const float* __restrict__ delta,
    const float* __restrict__ inv_deg, float* __restrict__ scaled,
    __nv_bfloat16* __restrict__ scaled_bf16, int* __restrict__ counts,
    int n_rows, int cols, float alpha, float keep, float thresh_scale) {
  using F = typename Vec<V>::F;
  __shared__ int red[kThreads * V];
  const int col0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool active = col0 < cols;
  const float c = *finished ? 0.0f : alpha;
  const float thresh = __fmul_rn(*delta, thresh_scale);
  int cnt[V];
#pragma unroll
  for (int j = 0; j < V; ++j) cnt[j] = 0;
  if (active) {
    const int step = gridDim.y * blockDim.y;
    for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < n_rows;
         row += step) {
      const size_t at = (size_t)row * cols + col0;
      F pv = *reinterpret_cast<const F*>(p + at);
      const F rv = *reinterpret_cast<const F*>(r + at);
      const float inv = kScale ? inv_deg[row] : 1.0f;
      F sv;
      float sb[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float rj = Vec<V>::get(rv, j);
        const float pj = __fmaf_rn(rj, c, Vec<V>::get(pv, j));
        Vec<V>::set(pv, j, pj);
        float s = __fmul_rn(rj, keep);
        if (kScale) s = __fmul_rn(s, inv);
        Vec<V>::set(sv, j, s);
        sb[j] = s;
        cnt[j] += pj >= thresh;
      }
      *reinterpret_cast<F*>(p + at) = pv;
      *reinterpret_cast<F*>(scaled + at) = sv;
      if (kBf16) store_bf16<V>(scaled_bf16 + at, sb);
    }
  }
  block_partial<V, int>(cnt, red, counts, cols, col0, active);
}

template <int V>
__global__ void __launch_bounds__(kThreads) ppr_sweep_post_kernel(
    float* __restrict__ pushed, const float* __restrict__ r_old,
    const int* __restrict__ src, const float* __restrict__ dang,
    const bool* __restrict__ finished, float* __restrict__ sums, int n_rows,
    int cols) {
  using F = typename Vec<V>::F;
  __shared__ float red[kThreads * V];
  const int col0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool active = col0 < cols;
  const int step = gridDim.y * blockDim.y;
  const int row0 = blockIdx.y * blockDim.y + threadIdx.y;
  if (*finished) {
    // frozen: the state stays as it was; the finalize reads no partial
    if (active)
      for (int row = row0; row < n_rows; row += step) {
        const size_t at = (size_t)row * cols + col0;
        *reinterpret_cast<F*>(pushed + at) =
            *reinterpret_cast<const F*>(r_old + at);
      }
    return;
  }
  int s[V];
  float d[V], acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] = (active && dang != nullptr) ? src[col0 + j] : -1;
    d[j] = (active && dang != nullptr) ? dang[col0 + j] : 0.0f;
    acc[j] = 0.0f;
  }
  if (active) {
    for (int row = row0; row < n_rows; row += step) {
      const size_t at = (size_t)row * cols + col0;
      F v = *reinterpret_cast<const F*>(pushed + at);
      bool hit = false;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float x = Vec<V>::get(v, j);
        if (row == s[j]) {
          x = __fadd_rn(x, d[j]);
          Vec<V>::set(v, j, x);
          hit = true;
        }
        acc[j] = __fadd_rn(acc[j], x);
      }
      if (hit) *reinterpret_cast<F*>(pushed + at) = v;
    }
  }
  block_partial<V, float>(acc, red, sums, cols, col0, active);
}

// scratch (uint32 [3], zero between launches): the largest column sum's
// bits, whether a column's count fell short of k, and the blocks done.
__global__ void __launch_bounds__(kFinCols * kFinSlices) ppr_sweep_finalize_kernel(
    const int* __restrict__ counts, int count_rows,
    const float* __restrict__ sums, int sum_rows, int cols, int k,
    const bool* __restrict__ stable, bool* finished, float* delta, int* it,
    unsigned int* scratch, float eps, float min_delta) {
  // every block reads `finished` before the last one writes it
  if (*finished) return;      // frozen: nothing changes
  __shared__ float ssum[kFinSlices][kFinCols];
  __shared__ long long scnt[kFinSlices][kFinCols];
  __shared__ bool last;
  const int lane = threadIdx.x % kFinCols, slice = threadIdx.x / kFinCols;
  const int col = blockIdx.x * kFinCols + lane;
  float s = 0.0f;
  long long n = 0;
  if (col < cols) {
    for (int i = slice; i < sum_rows; i += kFinSlices)
      s = __fadd_rn(s, sums[(size_t)i * cols + col]);
    for (int i = slice; i < count_rows; i += kFinSlices)
      n += counts[(size_t)i * cols + col];
  }
  ssum[slice][lane] = s;
  scnt[slice][lane] = n;
  __syncthreads();
  if (slice == 0) {
    float total = 0.0f;
    long long cnt = 0;
    for (int y = 0; y < kFinSlices; ++y) {
      total = __fadd_rn(total, ssum[y][lane]);
      cnt += scnt[y][lane];
    }
    // column sums are >= +0, so their bits order as unsigned integers
    unsigned int bits = col < cols ? __float_as_uint(total) : 0u;
    bool short_of_k = col < cols && cnt < k;
    for (int off = 16; off > 0; off >>= 1) {
      bits = max(bits, __shfl_xor_sync(0xffffffffu, bits, off));
      short_of_k |= __shfl_xor_sync(0xffffffffu, (int)short_of_k, off);
    }
    if (lane == 0) {
      atomicMax(&scratch[0], bits);
      if (short_of_k) atomicOr(&scratch[1], 1u);
      __threadfence();
      last = atomicAdd(&scratch[2], 1u) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const float largest = __uint_as_float(atomicExch(&scratch[0], 0u));
  const bool any_short = atomicExch(&scratch[1], 0u) != 0u;
  atomicExch(&scratch[2], 0u);
  const float d = *delta;
  const bool settled = largest <= __fmul_rn(eps, d);
  bool done = settled && !any_short;
  if (stable != nullptr && *stable) done = true;
  const bool fin = done || (settled && d <= min_delta);
  if (settled && !fin) {
    const float q = __fdiv_rn(d, 4.0f);
    *delta = (q != q) ? q : fmaxf(q, min_delta);   // torch.clamp_min
  }
  *finished = fin;
  *it += 1;
}

template <int V, bool kScale, bool kBf16>
void pre(float* p, const float* r, const bool* finished, const float* delta,
         const float* inv_deg, float* scaled, __nv_bfloat16* scaled_bf16,
         int* counts, int n_rows, int cols, dim3 grid, dim3 block,
         float alpha, float keep, float thresh_scale, cudaStream_t stream) {
  ppr_sweep_pre_kernel<V, kScale, kBf16><<<grid, block, 0, stream>>>(
      p, r, finished, delta, inv_deg, scaled, scaled_bf16, counts, n_rows,
      cols, alpha, keep, thresh_scale);
}

template <int V>
void pre_vec(bool scale, bool bf16, float* p, const float* r,
             const bool* finished, const float* delta, const float* inv_deg,
             float* scaled, __nv_bfloat16* scaled_bf16, int* counts,
             int n_rows, int cols, dim3 grid, dim3 block, float alpha,
             float keep, float thresh_scale, cudaStream_t stream) {
  auto f = scale ? (bf16 ? &pre<V, true, true> : &pre<V, true, false>)
                 : (bf16 ? &pre<V, false, true> : &pre<V, false, false>);
  f(p, r, finished, delta, inv_deg, scaled, scaled_bf16, counts, n_rows,
    cols, grid, block, alpha, keep, thresh_scale, stream);
}

bool bad_layout(int n_rows, int cols, int vec, int tx, int gx, int gy) {
  return n_rows <= 0 || cols <= 0 || (vec != 1 && vec != 4) ||
         cols % vec != 0 || tx <= 0 || kThreads % tx != 0 || gx <= 0 ||
         gy <= 0 || gy > 65535 || (long long)gx * tx * vec < cols;
}

}  // namespace

extern "C" {

// The pre pass on `stream`, in place on p [n_rows, cols]; scaled (f32) and,
// unless null, scaled_bf16 [n_rows, cols]; counts int32 [gy, cols]. inv_deg
// f32 [n_rows], or null where the push scales nothing. The layout: vec
// columns a thread, tx threads a row (256 / tx rows a block), a grid of
// gx x gy blocks.
int ppr_sweep_pre(float* p, const float* r, const bool* finished,
                  const float* delta, const float* inv_deg, float* scaled,
                  void* scaled_bf16, int* counts, int n_rows, int cols,
                  int vec, int tx, int gx, int gy, float alpha, float keep,
                  float thresh_scale, void* stream) {
  if (bad_layout(n_rows, cols, vec, tx, gx, gy))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy), block(tx, kThreads / tx);
  auto* bf = static_cast<__nv_bfloat16*>(scaled_bf16);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  if (vec == 4)
    pre_vec<4>(inv_deg != nullptr, bf != nullptr, p, r, finished, delta,
               inv_deg, scaled, bf, counts, n_rows, cols, grid, block, alpha,
               keep, thresh_scale, s);
  else
    pre_vec<1>(inv_deg != nullptr, bf != nullptr, p, r, finished, delta,
               inv_deg, scaled, bf, counts, n_rows, cols, grid, block, alpha,
               keep, thresh_scale, s);
  return (int)cudaGetLastError();
}

// The post pass on `stream`, in place on pushed [n_rows, cols]; r_old the
// residue before the push; src int32 [cols] each column's source row; dang
// f32 [cols] each column's dangling mass, or null where the graph has no
// dangling node; sums f32 [gy, cols]. The layout as ppr_sweep_pre's.
int ppr_sweep_post(float* pushed, const float* r_old, const int* src,
                   const float* dang, const bool* finished, float* sums,
                   int n_rows, int cols, int vec, int tx, int gx, int gy,
                   void* stream) {
  if (bad_layout(n_rows, cols, vec, tx, gx, gy))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy), block(tx, kThreads / tx);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  if (vec == 4)
    ppr_sweep_post_kernel<4><<<grid, block, 0, s>>>(
        pushed, r_old, src, dang, finished, sums, n_rows, cols);
  else
    ppr_sweep_post_kernel<1><<<grid, block, 0, s>>>(
        pushed, r_old, src, dang, finished, sums, n_rows, cols);
  return (int)cudaGetLastError();
}

// The finalize on `stream`: counts int32 [count_rows, cols] and sums f32
// [sum_rows, cols] from the passes; stable a bool, or null; the loop's
// scalars finished (bool), delta (f32) and it (int32) updated in place;
// scratch uint32 [3], zero, left zero.
int ppr_sweep_finalize(const int* counts, int count_rows, const float* sums,
                       int sum_rows, int cols, int k, const bool* stable,
                       bool* finished, float* delta, int* it,
                       unsigned int* scratch, float eps, float min_delta,
                       void* stream) {
  if (cols <= 0 || count_rows <= 0 || sum_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (cols + kFinCols - 1) / kFinCols;
  ppr_sweep_finalize_kernel<<<blocks, kFinCols * kFinSlices, 0,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      counts, count_rows, sums, sum_rows, cols, k, stable, finished, delta,
      it, scratch, eps, min_delta);
  return (int)cudaGetLastError();
}

const char* ppr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
