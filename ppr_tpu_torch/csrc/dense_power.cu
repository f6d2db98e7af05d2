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
// (The TPU kernels held W whole in VMEM, n <= 1024, _VMEM_OPERATOR_LIMIT in
// pallas_dense.py. A Hopper block has 227 KB of shared memory and W is 4 MB
// at n = 1024, so W cannot sit on chip; the design below is built around
// that.) Every product is FP32 FMA (no TF32, no tensor cores: the TPU
// kernels run at Precision.HIGHEST, and TF32 loses ~1e-3 of mass a pass).
// Each output's sum runs in a fixed order, so two launches on the same
// inputs give the same bits.
//
// Design: cluster tiles, W's columns split across a thread block cluster.
// What bounds it: at B 1000, FP32 FLOP (2 * B * n^2 a round: 9.4 ms for
// 300 rounds at n = 1024 on 67 TFLOP/s); at B 50-128 (the protocol's
// batches), the L2 reads of W (every cluster reads all of W each round)
// and the latency of each chunk's steps.
// - Grid: (C, row tiles), a thread block cluster of C = ceil(n / 128)
//   blocks (8 at n = 1024, the portable maximum; 1 at n = 128) per tile of
//   R source rows. Block j owns columns [128 j, 128 j + 128) and streams
//   only its slice of W (512 KB at n = 1024, not 4 MB) each round, in
//   chunks of kChunk = 32 rows through a ring of kStages = 8 shared
//   buffers filled by cp.async, 6 chunks ahead of the FMAs; the ring runs
//   on across rounds (W is the same every round), so no round starts with
//   an empty pipeline.
// - Register blocking, 8 warps a block; each thread keeps RT rows x 4
//   columns of state (K1: p, r; K2: x) in registers for the run. Two
//   layouts, by tile height (Tile<RT> below):
//   - short tiles (R = 8 RT = 8, 16, 32): WK = 8 / RT warps split each
//     chunk's k; a warp computes 8 rows x the slice's 128 columns, lane l
//     columns 4 l ..: per 4 k a thread reads 4 float4 of W and 8 of x (a
//     broadcast) for 128 FMAs. The WK partial blocks are summed through
//     shared memory in a fixed order;
//   - tall tiles (R = 64, 72): a warp computes all R rows x 16 columns
//     over the whole chunk, lane l rows l / 4 + 8 i and columns 4 (l % 4)
//     ..: per 4 k a thread reads 4 float4 of W and RT of x for 16 RT FMAs,
//     about half the shared-memory wavefronts per FMA of the short layout
//     (x rows padded to 36 floats, so no bank conflicts), and no split-k
//     sums.
//   At R 8-32 the short layout is faster (each W float4 serves 8 rows,
//   not RT); at R 72 the tall one (K2 at B 1000: 20.8 vs 26.7 ms).
// - x: each block writes its slice of the round's x ([R, 128]) into its
//   own shared memory, double-buffered. The product reads chunk c of x
//   from the block that owns it (distributed shared memory,
//   cluster.map_shared_rank), one chunk ahead through registers into a
//   local stage. One cluster.sync() a round suffices: a buffer written in
//   round t + 2 was last read in round t, before every block arrived at
//   round t + 1's barrier.
// - K1's dangling mass: each block sums its rows' r_d over its columns
//   (lanes, then warps, in a fixed order); after the barrier every block
//   adds the C partials in block order, so all blocks agree bit for bit.
//   The dm * onehot term uses the one-hot entries each thread read once,
//   at the start.
// - The tile: the fewest rows R = 8, 16, 32, 64, 72 whose ceil(B / R)
//   clusters are all resident at once (cudaOccupancyMaxActiveClusters: 15
//   clusters of 8 on an H100 SXM, not 16.5), so the launch is one wave. At
//   n = 1024: B 50 -> R 8 (7 clusters, 56 SMs); B 128 -> R 16 (8
//   clusters, 64 SMs); B 1000 -> R 72 (14 clusters, 112 SMs). At n = 128,
//   B 50: R 8, 7 single-block clusters. Rows >= B and columns >= n are
//   masked: their state is 0 and W's rows and columns beyond n are
//   zero-filled.
// - Shared memory: 128 KB of W ring, 2 R 36 floats of x stage, 2 R 128
//   floats of own slice, 32 KB of split-k partials (short tiles), 8 R
//   floats of warp partials (tall tiles) and 2 R of dangling partials:
//   170-223 KB, one block an SM.
// What is left (H100, dense_power_ablation.py, which times builds with
// parts switched off): at B 1000 the product loop alone, without the W
// stream, the x stage or the chunk barriers, already takes about as long
// as a cuBLAS FP32 product per round (K2: ~16 of 20.8 ms, cuBLAS 16.6);
// the W stream, the x stage and the barriers add the rest rather than
// hiding under it. So the lever at B 1000 is the product itself: tensor
// cores through an error-compensated 3xTF32 split (wgmma), and more SMs
// than the 112 of 14 clusters. At B 50-128 every cluster re-reads all of
// W from L2 each round (7-8 x 4 MB): TMA multicast of each W chunk to the
// blocks that share a column slice is the lever there.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 1024;

constexpr int kSlice = 128;               // columns a block owns
constexpr int kChunk = 32;                // W rows a ring stage holds
constexpr int kStages = 8;                // ring depth
constexpr int kAhead = kStages - 2;       // chunks in flight
constexpr int kWarps = 8;                 // warps a block
constexpr int kXStride = kChunk + 4;      // x-stage row, padded: no conflicts

enum Mode { kPower = 1, kPagerank = 2 };

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  // 16 bytes global -> shared, zero-filled when !valid (nothing is read)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A cluster-tile block of R = 8 RT source rows by the slice's 128 columns:
// its threads' layout and its shared memory, in floats. Each thread keeps
// RT state rows x 4 columns.
// - Short tiles (RT < 8): WK = 8 / RT warps split each chunk's k; a warp
//   computes 8 rows x 128 columns (lane l: columns 4 l ..), and the WK
//   partial blocks are summed through shared memory (`red`).
// - Tall tiles (RT >= 8): a warp computes all R rows x 16 columns over the
//   whole chunk; lane l takes rows l / 4 + 8 i and columns 4 (l % 4) ..
template <int RT>
struct Tile {
  static constexpr bool tall = RT >= 8;
  static constexpr int threads = 32 * kWarps;
  static constexpr int R = 8 * RT;
  static constexpr int WK = tall ? 1 : 8 / RT;  // warps splitting k
  static constexpr int AR = tall ? RT : 8;      // rows a thread computes
  static constexpr int SS = tall ? 8 : 1;       // their stride in the tile
  static constexpr int KW = kChunk / WK;        // k a thread takes a chunk
  static constexpr int RL = tall ? 4 : 32;      // lanes sharing a row
  static constexpr int ring = kStages * kChunk * kSlice;
  static constexpr int x_stage = 2 * R * kXStride;
  static constexpr int slice = 2 * R * kSlice;
  static constexpr int red = tall ? 0 : WK * R * kSlice;
  static constexpr int wpart = tall ? kWarps * R : 0;
  static constexpr int dpart = 2 * R;
  static constexpr size_t bytes =
      (size_t)(ring + x_stage + slice + red + wpart + dpart) * sizeof(float);
};

// MODE kPower (K1): a = alpha, b = keep = 1 - alpha; returns p.
// MODE kPagerank (K2): a = damping, b = teleport; returns x.
template <int RT, int MODE>
__global__ void __launch_bounds__(32 * kWarps, 1)
ppr_cluster_kernel(const float* __restrict__ W,
                   const float* __restrict__ onehot,
                   const float* __restrict__ dang, float* __restrict__ out,
                   int B, int n, int iters, float a, float b,
                   int dangling_to_source) {
  using S = Tile<RT>;
  constexpr int R = S::R, T = S::threads, AR = S::AR, SS = S::SS;
  constexpr int XV = R * kChunk / 4;          // float4s of an x chunk
  constexpr int XPT = (XV + T - 1) / T;
  constexpr int kChunksPerSlice = kSlice / kChunk;

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kChunk][kSlice]
  float* x_stage = ring + S::ring;                // [2][R][kXStride]
  float* slice = x_stage + S::x_stage;            // [2][R][kSlice]
  float* red = slice + S::slice;                  // [WK][R][kSlice]
  float* wpart = red + S::red;                    // [kWarps][R]
  float* dpart = wpart + S::wpart;                // [2][R]

  cg::cluster_group cluster = cg::this_cluster();
  const int nblocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = S::tall ? 0 : warp % S::WK;  // its k range of a chunk
  // the first row the thread computes, and its first state row (of RT,
  // SS apart), in the tile; its first column, in the slice
  const int prow = S::tall ? lane >> 2 : (warp / S::WK) * 8;
  const int srow = S::tall ? prow : prow + split * RT;
  const int lcol = S::tall ? 16 * warp + 4 * (lane & 3) : 4 * lane;
  const int col0 = rank * kSlice;       // the block's first column
  const int col = col0 + lcol;
  const int row0 = blockIdx.y * R + srow;
  const int nchunks = nblocks * kChunksPerSlice;

  // the thread's state: RT rows x 4 columns, in registers for the run
  float oh[RT][4], st[RT][4], p[RT][4], dg[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    dg[c] = (MODE == kPower && col + c < n) ? dang[col + c] : 0.0f;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = row0 + SS * i;
      oh[i][c] = (row < B && col + c < n)
                     ? onehot[(size_t)row * n + col + c] : 0.0f;
      st[i][c] = MODE == kPower ? oh[i][c] : b * oh[i][c];
      p[i][c] = 0.0f;
    }

  // W chunk `chunk` (rows chunk * kChunk ..) into ring stage `stage`
  auto issue_w = [&](int chunk, int stage, bool live) {
    if (live) {
      const int k0 = chunk * kChunk;
      float* dst = ring + stage * kChunk * kSlice;
      for (int i = tid; i < kChunk * kSlice / 4; i += T) {
        const int kr = i / (kSlice / 4);
        const int c4 = (i % (kSlice / 4)) * 4;
        const int k = k0 + kr;
        const int cc = col0 + c4;
        const bool ok = k < n && cc < n;
        cp_async16(dst + kr * kSlice + c4, ok ? W + (size_t)k * n + cc : W,
                   ok);
      }
    }
    cp_async_commit();  // one group a chunk, empty or not
  };

  // x chunk c (columns c * kChunk ..) of the round: from the block that
  // owns those columns, into registers
  float4 xr[XPT];
  auto load_x = [&](float* own, int c) {
    const float* src = cluster.map_shared_rank(own, c / kChunksPerSlice) +
                       (c % kChunksPerSlice) * kChunk;
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * T;
      if (i < XV)
        xr[j] = *reinterpret_cast<const float4*>(
            src + (i / (kChunk / 4)) * kSlice + (i % (kChunk / 4)) * 4);
    }
  };
  auto store_x = [&](int parity) {
    float* dst = x_stage + parity * R * kXStride;
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = tid + j * T;
      if (i < XV)
        *reinterpret_cast<float4*>(dst + (i / (kChunk / 4)) * kXStride +
                                   (i % (kChunk / 4)) * 4) = xr[j];
    }
  };

  // the ring runs on across rounds: W is the same every round
  for (int s = 0; s < kAhead; ++s)
    issue_w(s % nchunks, s, s / nchunks < iters);

  int stage = 0;   // the ring stage of the chunk being read
  int parity = 0;  // the x stage of the chunk being read
  for (int it = 0; it < iters; ++it) {
    float* own = slice + (it & 1) * R * kSlice;
    float* dp = dpart + (it & 1) * R;

    // --- phase 1: this block's slice of the round's x (K1: r - r_d) ---
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = srow + SS * i;
      float x[4];
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (MODE == kPower) {
          const float rv = st[i][c];
          p[i][c] = p[i][c] + a * rv;
          const float rd = rv * dg[c];
          part += rd;
          x[c] = rv - rd;
        } else {
          x[c] = st[i][c];
        }
      }
      *reinterpret_cast<float4*>(&own[row * kSlice + lcol]) =
          make_float4(x[0], x[1], x[2], x[3]);
      if (MODE == kPower && dangling_to_source) {
        // the row's columns in this warp: its RL lanes
#pragma unroll
        for (int off = 1; off < S::RL; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane % S::RL == 0) {
          if (S::tall)
            wpart[warp * R + row] = part;
          else
            dp[row] = part;
        }
      }
    }
    if (S::tall && MODE == kPower && dangling_to_source) {
      // the block's partial of each row: its warps', in warp order
      __syncthreads();
      if (tid < R) {
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s += wpart[w * R + tid];
        dp[tid] = s;
      }
    }
    cluster.sync();

    // --- phase 2: acc[r][c] = sum over the thread's k of
    //     x[row prow + SS r, k] * W[k, col + c] ---
    float acc[AR][4];
#pragma unroll
    for (int r = 0; r < AR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    load_x(own, 0);
    for (int c = 0; c < nchunks; ++c) {
      store_x(parity);     // its stage was last read two chunks ago
      if (c + 1 < nchunks) load_x(own, c + 1);
      // kAhead chunks on, into the stage read two chunks ago: every warp
      // has passed the barrier after that read
      const int wc = c + kAhead;  // may run into later rounds
      int wst = stage + kAhead;
      if (wst >= kStages) wst -= kStages;
      issue_w(wc % nchunks, wst, it + wc / nchunks < iters);
      cp_async_wait<kAhead>();
      __syncthreads();
      const float* ws = ring + stage * kChunk * kSlice +
                        split * S::KW * kSlice + lcol;
      const float* xs = x_stage + parity * R * kXStride + prow * kXStride +
                        split * S::KW;
      stage = stage + 1 == kStages ? 0 : stage + 1;
      parity ^= 1;
#pragma unroll
      for (int k = 0; k < S::KW; k += 4) {
        float4 w[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w[kk] = *reinterpret_cast<const float4*>(ws + (k + kk) * kSlice);
#pragma unroll
        for (int r = 0; r < AR; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(
              xs + SS * r * kXStride + k);
          const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[r][0] = fmaf(xk[kk], w[kk].x, acc[r][0]);
            acc[r][1] = fmaf(xk[kk], w[kk].y, acc[r][1]);
            acc[r][2] = fmaf(xk[kk], w[kk].z, acc[r][2]);
            acc[r][3] = fmaf(xk[kk], w[kk].w, acc[r][3]);
          }
        }
      }
    }

    // --- the state rows' sums (short tiles: the WK partial blocks, in
    //     split order) ---
    float res[RT][4];
    if constexpr (S::tall) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) res[i][c] = acc[i][c];
    } else {
      float* mine = red + split * R * kSlice + prow * kSlice + lcol;
#pragma unroll
      for (int r = 0; r < AR; ++r)
        *reinterpret_cast<float4*>(mine + r * kSlice) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < S::WK; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              red + j * R * kSlice + (srow + i) * kSlice + lcol);
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        res[i][0] = s.x; res[i][1] = s.y; res[i][2] = s.z; res[i][3] = s.w;
      }
    }

    // --- phase 3: the new state ---
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (MODE == kPower) {
        float dm = 0.0f;
        if (dangling_to_source)
          for (int blk = 0; blk < nblocks; ++blk)  // in block order
            dm += cluster.map_shared_rank(dp, blk)[srow + SS * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float pushed = dangling_to_source
                                   ? res[i][c] + dm * oh[i][c] : res[i][c];
          st[i][c] = b * pushed;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) st[i][c] = b * oh[i][c] + a * res[i][c];
      }
    }
  }
  cp_async_wait<0>();
  // no block leaves while a peer may still read its shared memory
  cluster.sync();

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + SS * i;
    if (row < B) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < n)
          out[(size_t)row * n + col + c] =
              MODE == kPower ? p[i][c] : st[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// Launching the cluster tiles.

using ClusterKernel = void (*)(const float*, const float*, const float*,
                               float*, int, int, int, float, float, int);

// One tile shape: its kernel, threads, rows and shared memory, and the
// count of its clusters of C blocks resident at once (queried once).
struct TileShape {
  ClusterKernel kernel;
  int threads;
  int rows;
  size_t smem;
  int resident[kMaxN / kSlice + 1];
};

template <int RT, int MODE>
TileShape tile() {
  using S = Tile<RT>;
  return {ppr_cluster_kernel<RT, MODE>, S::threads, S::R, S::bytes, {}};
}

cudaLaunchConfig_t tile_config(const TileShape& t, int C, int tiles,
                               cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, tiles, 1);
  cfg.blockDim = dim3(t.threads, 1, 1);
  cfg.dynamicSmemBytes = t.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C blocks of shape t resident at once (15 of 8 blocks on an
// H100 SXM); 0 when the query fails (the launch then reports why).
int resident_clusters(TileShape& t, int C) {
  if (t.resident[C] == 0) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = tile_config(t, C, 1, nullptr, attr);
    int count = 0;
    if (cudaFuncSetAttribute(t.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)t.smem) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&count, t.kernel, &cfg) !=
            cudaSuccess)
      return 0;
    t.resident[C] = count;
  }
  return t.resident[C];
}

// The tile: the fewest rows R (8, 16, 32, 64, 72) whose ceil(B / R)
// clusters are all resident at once, so the launch is one wave; past
// that, 72.
template <int MODE>
cudaError_t launch_cluster(const float* W, const float* onehot,
                           const float* dang, float* out, int B, int n,
                           int iters, float a, float b, int dts,
                           cudaStream_t stream) {
  static TileShape shapes[] = {
      tile<1, MODE>(), tile<2, MODE>(), tile<4, MODE>(), tile<8, MODE>(),
      tile<9, MODE>()};
  constexpr int kShapes = sizeof(shapes) / sizeof(shapes[0]);
  const int C = (n + kSlice - 1) / kSlice;
  int pick = kShapes - 1;
  for (int i = 0; i < kShapes; ++i)
    if ((B + shapes[i].rows - 1) / shapes[i].rows <=
        resident_clusters(shapes[i], C)) {
      pick = i;
      break;
    }
  TileShape& t = shapes[pick];
  cudaError_t err = cudaFuncSetAttribute(
      t.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      tile_config(t, C, (B + t.rows - 1) / t.rows, stream, attr);
  err = cudaLaunchKernelEx(&cfg, t.kernel, W, onehot, dang, out, B, n,
                           iters, a, b, dts);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream`; returns a CUDA error code (0 on success).
int ppr_dense_power_iterations(const float* W, const float* onehot,
                               const float* dang, float* out, int B, int n,
                               int iters, float alpha, float keep,
                               int dangling_to_source, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN || n % 4 != 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_cluster<kPower>(W, onehot, dang, out, B, n, iters,
                                     alpha, keep, dangling_to_source,
                                     reinterpret_cast<cudaStream_t>(stream));
}

// Launches K2 on `stream`; returns a CUDA error code (0 on success).
int ppr_dense_pagerank_iterations(const float* W, const float* onehot,
                                  float* out, int B, int n, int iters,
                                  float damping, float teleport,
                                  void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN || n % 4 != 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_cluster<kPagerank>(
      W, onehot, nullptr, out, B, n, iters, damping, teleport, 0,
      reinterpret_cast<cudaStream_t>(stream));
}

const char* ppr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
