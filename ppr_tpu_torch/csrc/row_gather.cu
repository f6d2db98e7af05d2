// K3 and the row-gather probes P1-P4: row gathers from a node-major table
// f32 [n_rows, cols] with int32 row indices, as one device template.
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
// ppr_gather_segment_sum_coef is K3's coefficient mode, the push of a
// weighted graph (the TPU ran it as XLA's gather, multiply and segment_sum,
// ppr_tpu/ops/spmv.py:66-67,110-112,236-237): with one f32 coefficient an
// edge (w_e / W_src; 0 on padding edges, which name the zero sentinel row),
//
//     out[d, :] = sum over e in [ptr[d], ptr[d+1]) of coef[e] * table[src[e], :]
//
// The product is rounded to f32 before it is added (__fmul_rn, then
// __fadd_rn, per component of a float4), so nvcc does not contract the two
// into an fma: the sum has the plain version's bits (index_select, times
// coef, segment_reduce), as the unweighted mode has. A coefficient is loaded
// once an edge with the policy of src, by every lane of the destination:
// 4 bytes an edge more than the unweighted mode reads; the layouts, the
// slabs and the rounds are the same. A weighted graph has no hub split, so
// its push walks the hubs' segments too, and the longest segment bounds a
// launch: at the weighted bench graph's whole push (1.04M edges, B 2048,
// one segment of 11,861 edges) 4.51 ms by CUDA-graph replays, against
// 4.42 ms for the same edges in the unweighted mode (the coefficient costs
// 2%) and 0.53 ms at the hub split's tail (NVIDIA H100 80GB HBM3 at 700 W;
// chip_smoke.py [weighted:k3]).
//
// ppr_row_gather replaces P1, P2 and P3 (scripts/probe_mosaic_gather.py:
// vmem_axis0_gather, vmem_dynamic_row_loop, hbm_indexed_row_dma) and the
// gather mode of P4: out[i, :] = table[idx[i], :]. It is K3 with unit
// segments: the same template with the row pointer compiled out (segment i
// is edge i, and the one row is copied, not added to zero).
//
// What bounds both on an H100: bytes, and for K3 the bytes L2 can deliver.
// The bound counts each table row once, but a pull gather reads a row once
// per edge that names it (4.9 times on average at the benchmark's tail:
// 2.65 GB of row reads for 0.54 GB of table), and nothing ties an edge's
// source to the SM that needs it, so every one of those reads comes from
// L2. What the design can do is make them all hit there, and keep enough
// of them in flight:
//
// * Column slabs. The caller (ops/row_gather.py::make_plan) cuts the columns
//   into tiles so that the rows a tile can read, n_rows x tile x 4 bytes,
//   take about a third of the 50 MB L2 (64 columns at the benchmark's
//   65,664 rows; 128, a warp's 32 loads, where the table is small), and the
//   grid is tile-major (blockIdx.y, the slow dimension, is the tile): the
//   blocks that run together read one slab, so a re-read finds its row in
//   L2. At the benchmark's tail: 64 columns 0.531 ms, 32 0.558, 128 0.603.
// * Tiles and lanes. A tile is L lanes x one load each (L = 8, 16 or 32; a
//   load is 16 bytes when cols % 4 == 0 and both bases are 16-byte aligned,
//   else one float). A warp takes 32 / L consecutive destinations of one
//   tile, so at a 64-column tile it reads two rows' 256-byte slices: whole
//   128-byte lines. A segment is never split across warps, and its rows
//   are added in edge order: no shared memory, no atomics, the same bits
//   every launch and the plain version's bits.
// * Few registers, small blocks. The card delivers the most when the most
//   warps are resident and a block does not wait long for its longest
//   segment: rounds of 2 rows of 16-byte loads (28 registers, 64 warps an
//   SM) and 4 warps a block. More rows in flight a lane lost: rounds of 4
//   0.568 ms, of 8 0.733 (38 and 64 registers); 8 warps a block 0.548, 16
//   0.595. Where a load is one float a row costs one register, and those
//   shapes (the protocol's B 50, with unsplit segments of hundreds of
//   edges) wait for their longest segment: rounds of 8 there (0.0135 ms
//   against 0.0281 with rounds of 2 at the ca-GrQc-scale graph).
// * Cache policy. Table rows, indices and row pointers are loaded with an
//   L2 evict_last policy (createpolicy + ld.global.nc.L2::cache_hint), the
//   output is stored streaming (st.global.cs), so the written slab does not
//   push the read slab out: 0.531 against 0.543 ms without.
//
// Measured slower and not kept, and no longer in this source: one wave of
// persistent blocks walking (tile, group) items with a stride, with or
// without loading the next item's bounds ahead (0.853 ms: the hardware's
// block scheduler balances the power-law segments better and costs no
// registers); rows through the copy engine (cp.async.bulk of each 256-byte
// slice into a ring in shared memory, completion on an mbarrier: 1.084 ms,
// ten million small copies a launch). With every row read hitting L2 the
// kernel runs at the rate it has on a table that lies in L2 whole (B 64:
// 0.0162 ms x 32 slabs = 0.52 ms), 6.0 TB/s of row reads and output: L2's
// delivery is the ceiling, not device memory.
// (NVIDIA H100 80GB HBM3 at 700 W; row_gather_ablation.py, CUDA-graph
// replays with L2 flushed between launches; the parent's kernel, a warp a
// destination and 128 columns, 8 warps a block, rounds of 4: 0.634 ms.)
//
// Row offsets are 64-bit (src * cols passes 2^31 at a million nodes and cols
// 2048); edge and segment counts are below 2^31. The C functions keep no
// state between launches, do not synchronise and allocate nothing.
//
// Build switches, for row_gather_ablation.py only (each times what a part
// costs; the package never sets one): PPR_K3_NO_POLICY (plain __ldg loads
// and stores), PPR_K3_NO_STORE (no output written: a wrong answer),
// PPR_K3_SRC_IS_DST (every edge reads its own destination's row: a pure
// stream, a wrong answer), PPR_K3_UNROLL, PPR_K3_UNROLL_SCALAR and
// PPR_K3_WARPS (rows a round for 16-byte and 4-byte loads, warps a block).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

#ifndef PPR_K3_WARPS
#define PPR_K3_WARPS 4            // warps a block
#endif
constexpr int kWarpsPerBlock = PPR_K3_WARPS;
constexpr int kThreads = kWarpsPerBlock * 32;
#ifndef PPR_K3_UNROLL
#define PPR_K3_UNROLL 2           // rows a round (row loads in flight a lane)
#endif
#ifndef PPR_K3_UNROLL_SCALAR
#define PPR_K3_UNROLL_SCALAR 8    // the same where a load is one float
#endif
// Rows a round: a 16-byte row costs four registers, and at the wide shapes
// that take those loads residency wins; a 4-byte row costs one, and the
// narrow shapes that take those (the protocol's B 50, unsplit power-law
// segments of hundreds of edges) are bound by their longest segment.
template <typename T>
constexpr int kUnrollOf =
    sizeof(T) == sizeof(float) ? PPR_K3_UNROLL_SCALAR : PPR_K3_UNROLL;
constexpr long long kMaxColTiles = 65535;   // gridDim.y limit

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }

__device__ __forceinline__ void add_to(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// acc += c * v with the product rounded first: no fma contraction
__device__ __forceinline__ void add_scaled(float& acc, float c, float v) {
  acc = __fadd_rn(acc, __fmul_rn(c, v));
}

__device__ __forceinline__ void add_scaled(float4& acc, float c,
                                           const float4& v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(c, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(c, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(c, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(c, v.w));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

#ifdef PPR_K3_NO_STORE
__device__ __forceinline__ float first_of(float v) { return v; }
__device__ __forceinline__ float first_of(const float4& v) { return v.x; }
#endif

// The L2 policy of everything that is read again: keep it.
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t policy = 0;
#ifndef PPR_K3_NO_POLICY
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
#endif
  return policy;
}

#ifdef PPR_K3_NO_POLICY
template <typename V>
__device__ __forceinline__ V ld_keep(const V* p, uint64_t) { return __ldg(p); }
template <typename V>
__device__ __forceinline__ void st_stream(V* p, const V& v) { *p = v; }
#else
__device__ __forceinline__ float ld_keep(const float* p, uint64_t policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ float4 ld_keep(const float4* p, uint64_t policy) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ int ld_keep(const int* p, uint64_t policy) {
  int v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ long long ld_keep(const long long* p,
                                             uint64_t policy) {
  long long v;
  asm("ld.global.nc.L2::cache_hint.s64 %0, [%1], %2;"
      : "=l"(v) : "l"(p), "l"(policy));
  return v;
}
template <typename V>
__device__ __forceinline__ void st_stream(V* p, const V& v) { __stcs(p, v); }
#endif

// One destination's share of one tile: the rows of segment [lo, hi) of
// `src`, columns [col, col + width) of each, added in edge order (each times
// coef[e] when kCoef) and stored to out[d]. Full rounds of kUnroll rows,
// then one round that holds what is left, so every row of a round is in
// flight before the first is added.
template <typename T, bool kSegments, bool kCoef>
__device__ __forceinline__ void gather_one(
    const float* __restrict__ table, const int* __restrict__ src,
    const float* __restrict__ coef, const long long* __restrict__ ptr,
    float* __restrict__ out, unsigned d, int col, int cols, uint64_t keep) {
  constexpr int kUnroll = kUnrollOf<T>;
  const float* base = table + col;
  T acc;
  if constexpr (kSegments) {
    int e = static_cast<int>(ld_keep(ptr + d, keep));
    const int hi = static_cast<int>(ld_keep(ptr + d + 1, keep));
    acc = zero<T>();
    auto row = [&](int at) {
#ifdef PPR_K3_SRC_IS_DST
      const int s = static_cast<int>(d);
#else
      const int s = ld_keep(src + at, keep);
#endif
      return reinterpret_cast<const T*>(base + static_cast<size_t>(s) * cols);
    };
    // the coefficient of edge `at` (kCoef only)
    auto weight = [&](int at) {
      if constexpr (kCoef) {
        return ld_keep(coef + at, keep);
      } else {
        return 1.0f;
      }
    };
    for (; e + kUnroll <= hi; e += kUnroll) {
      const T* rows[kUnroll];
      float c[kUnroll];
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rows[u] = row(e + u);
        c[u] = weight(e + u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = ld_keep(rows[u], keep);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if constexpr (kCoef) {
          add_scaled(acc, c[u], v[u]);
        } else {
          add_to(acc, v[u]);
        }
      }
    }
    if constexpr (kUnroll > 1) {
      if (e < hi) {
        const int n = hi - e;
        const T* rows[kUnroll - 1];
        float c[kUnroll - 1];
        T v[kUnroll - 1];
#pragma unroll
        for (int u = 0; u < kUnroll - 1; ++u) {
          if (u < n) {
            rows[u] = row(e + u);
            c[u] = weight(e + u);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll - 1; ++u) {
          if (u < n) v[u] = ld_keep(rows[u], keep);
        }
#pragma unroll
        for (int u = 0; u < kUnroll - 1; ++u) {
          if (u < n) {
            if constexpr (kCoef) {
              add_scaled(acc, c[u], v[u]);
            } else {
              add_to(acc, v[u]);
            }
          }
        }
      }
    }
  } else {
    // the one row is copied, not added to zero: -0.0 stays -0.0
    acc = ld_keep(reinterpret_cast<const T*>(
                      base + static_cast<size_t>(ld_keep(src + d, keep)) * cols),
                  keep);
  }
  T* dst = reinterpret_cast<T*>(out + static_cast<size_t>(d) * cols + col);
#ifdef PPR_K3_NO_STORE
  if (first_of(acc) == -1.0f) st_stream(dst, acc);
#else
  st_stream(dst, acc);
#endif
}

// T is float (one column a lane) or float4 (four); L lanes share a
// destination, so a warp takes 32 / L consecutive destinations (a group) of
// one tile of L loads; kSegments false compiles ptr out (unit segments),
// kCoef false compiles coef out. blockIdx.y, the slow dimension, is the
// tile: the grid is tile-major.
template <typename T, int L, bool kSegments, bool kCoef>
__global__ void __launch_bounds__(kThreads)
ppr_gather_kernel(const float* __restrict__ table, const int* __restrict__ src,
                  const float* __restrict__ coef,
                  const long long* __restrict__ ptr, float* __restrict__ out,
                  int n_out, int cols) {
  constexpr int kWidth = sizeof(T) / sizeof(float);
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const unsigned group = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const unsigned d = group * G + lane / L;
  const int col = static_cast<int>(blockIdx.y) * (L * kWidth) +
                  (lane % L) * kWidth;
  if (d < static_cast<unsigned>(n_out) && col < cols) {
    gather_one<T, kSegments, kCoef>(table, src, coef, ptr, out, d, col,
                                    cols, keep_policy());
  }
}

using Kernel = void (*)(const float*, const int*, const float*,
                        const long long*, float*, int, int);

// The kernel of a layout: `width` floats a load, `lanes` lanes a destination.
template <bool kSegments, bool kCoef>
Kernel kernel_for(int width, int lanes) {
  if (width == 4) {
    switch (lanes) {
      case 8: return ppr_gather_kernel<float4, 8, kSegments, kCoef>;
      case 16: return ppr_gather_kernel<float4, 16, kSegments, kCoef>;
      case 32: return ppr_gather_kernel<float4, 32, kSegments, kCoef>;
    }
  } else if (width == 1) {
    switch (lanes) {
      case 8: return ppr_gather_kernel<float, 8, kSegments, kCoef>;
      case 16: return ppr_gather_kernel<float, 16, kSegments, kCoef>;
      case 32: return ppr_gather_kernel<float, 32, kSegments, kCoef>;
    }
  }
  return nullptr;
}

// The three functions' kernels.
enum class Mode { kGather, kSegments, kSegmentsCoef };

// One launch of any function: `width` floats a load (4 needs cols % 4
// == 0 and 16-byte-aligned bases), `lanes` lanes a destination, so a tile
// is width * lanes columns.
int launch(Mode mode, const float* table, const int* src, const float* coef,
           const long long* ptr, float* out, int n_out, int cols, int width,
           int lanes, void* stream) {
  const Kernel kernel =
      mode == Mode::kSegmentsCoef ? kernel_for<true, true>(width, lanes)
      : mode == Mode::kSegments   ? kernel_for<true, false>(width, lanes)
                                  : kernel_for<false, false>(width, lanes);
  if (n_out <= 0 || cols <= 0 || kernel == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (width == 4 && (cols % 4 != 0 ||
                     reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
                     reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tile_cols = width * lanes;
  const long long tiles = (static_cast<long long>(cols) + tile_cols - 1) /
                          tile_cols;
  const long long groups = (static_cast<long long>(n_out) + 32 / lanes - 1) /
                           (32 / lanes);
  if (tiles > kMaxColTiles) return (int)cudaErrorInvalidValue;
  const dim3 grid(
      static_cast<unsigned>((groups + kWarpsPerBlock - 1) / kWarpsPerBlock),
      static_cast<unsigned>(tiles));
  kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      table, src, coef, ptr, out, n_out, cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 on `stream`: out [n_out, cols] from table [*, cols], src [ptr[n_out]],
// ptr [n_out + 1], in the layout of `launch`. Returns cudaGetLastError()
// (0 on success).
int ppr_gather_segment_sum(const float* table, const int* src,
                           const long long* ptr, float* out, int n_out,
                           int cols, int width, int lanes, void* stream) {
  return launch(Mode::kSegments, table, src, nullptr, ptr, out, n_out, cols,
                width, lanes, stream);
}

// K3's coefficient mode on `stream`: as ppr_gather_segment_sum, each row
// times coef[e] (f32 [ptr[n_out]]).
int ppr_gather_segment_sum_coef(const float* table, const int* src,
                                const float* coef, const long long* ptr,
                                float* out, int n_out, int cols, int width,
                                int lanes, void* stream) {
  if (coef == nullptr) return (int)cudaErrorInvalidValue;
  return launch(Mode::kSegmentsCoef, table, src, coef, ptr, out, n_out, cols,
                width, lanes, stream);
}

// P1-P4 gather on `stream`: out [rows, cols] = table[idx[0..rows), :], in
// the layout of `launch`. Returns cudaGetLastError() (0 on success).
int ppr_row_gather(const float* table, const int* idx, float* out, int rows,
                   int cols, int width, int lanes, void* stream) {
  return launch(Mode::kGather, table, idx, nullptr, nullptr, out, rows, cols,
                width, lanes, stream);
}

const char* ppr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
