// Gram products in f32 on the tensor cores: for x (n, da) and the column
// blocks y1 (n, d1) and y2 (n, d2), out1 = x^T y1 (da, d1) and out2 = x^T y2
// (da, d2), in one launch.  The Step-4 analytic inversion (paper eq. 9)
// forms A0 = O^T O and A1 = O^T Z for every server layer: y1 = x = O and
// y2 = Z.  A single Gram x^T y is y1 = y with d2 = 0.
//
// Replaces the Pallas TPU kernel repro/kernels/ridge_gram/ridge_gram.py
// (_gram_kernel / gram_pallas), which accumulates into its output block over
// the sequential innermost grid axis k.  Blocks on Hopper run in no order on
// 132 SMs, so nothing carries between them; and the output here is small
// (at most 257 x 385 on the main path, 35 tiles of 64 x 64) while n is long
// (4800).  So:
// - The output tiles cover the columns of [y1 | y2] without building the
//   concatenation: a column below d1 reads y1, one above reads y2.
// - The contraction over n is split across gridDim.z.  Each block computes
//   one 64 x 64 tile over its share of rows, staging 32-row chunks of x and
//   [y1 | y2] through two stages of shared memory, the next chunk's loads in
//   flight in registers while this one is multiplied (4-byte loads: the
//   main path's widths 257, 129, 65, ... are odd, and 4-byte cp.async
//   copies of them proved slower than loads through registers).
// - Eight warps in two groups of four: in each group a warp owns 32 x 32 of
//   the tile, as 2 x 4 m16n8k8 products in 3xTF32 (tf32x3.cuh), and the two
//   groups take the two halves of a chunk's k8 steps; their sums meet in
//   shared memory at the end, group 0's plus group 1's.  A = x^T, read from
//   the staged [n][da] chunk transposed by the indexing, B = [y1 | y2].
//   Warps skip the m16 and n8 tiles that lie wholly past da or d1 + d2.
//   Each k8 step's products are summed from zero and added with rounded
//   FP32 adds (mma_tf32_zero): O^T O sums terms of one sign (its diagonal,
//   and every entry of ReLU activations), where the tensor core's
//   truncating sum would drift by ~1e-6 of the result over n.
// - With y1 == x (every gram_pair), x^T y1 = O^T O is symmetric: the tiles
//   below its diagonal are not computed, and those above it write their
//   transposes too (25 tiles of 35 for the largest pair).
// - With more than one split, each block writes its whole partial tile to a
//   scratch of shape (splits, tiles, 64, 64) and counts itself in a per-tile
//   counter; the last block of a tile sums the partials z = 0, 1, ... in
//   that order (16-byte loads, 4 splits in flight), writes the tile and
//   resets the counter to 0.  The result is deterministic (no atomics on the
//   values) in one launch.
//
// Bound on an H100 SXM: the operations.  The 8 pairs of one DNN10 evaluation
// at n = 4800 need 1.16e9 f32 operations (n d1 (d1 + 1) for the symmetric
// O^T O, 2 n d1 d2 for O^T Z), 7.0 us at 495 / 3 TFLOP/s (the TF32
// tensor-core rate over the three products of 3xTF32); their inputs, O
// read once per pair, and outputs are 23.6 MB, 7.1 us at 3.35 TB/s.
//
// Ragged da, d1, d2 and n are masked in the kernel (zeroed loads, guarded
// stores); nothing is padded on the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kTile = 64;                // output tile edge
constexpr int kChunk = 32;               // rows of n a stage holds
constexpr int kThreads = 256;            // 8 warps: 2 groups of 4 warps
                                         // of 32 x 32, each group half of
                                         // a chunk's k8 steps
constexpr int kRow = kTile + 8;          // floats of a staged row: 72 = 8
                                         // mod 32, so a fragment's 4 rows
                                         // t and 8 columns g hit 32 banks
constexpr int kStage = kChunk * kRow;    // floats of one stage

// One thread's share of a chunk (kChunk rows of the tile's 64 columns of x
// and of [y1 | y2]), carried in registers from device memory to shared
// memory: one float at column col of rows row + kStep i.  Rows past k_end
// and columns past the widths are zeros.
struct Staging {
  static constexpr int kStep = kThreads / kTile;  // rows a pass covers
  static constexpr int kLoads = kChunk / kStep;
  float sx[kLoads], sy[kLoads];
  int row, col;
  // x (or y1 / y2) at this thread's column of row 0, and the row stride; a
  // column past the widths reads row 0 of x again with stride 0, and is
  // zeroed: the loads are branch-free and always in bounds
  const float* xp;
  const float* yp;
  int xstride, ystride;
  bool x_in, y_in;

  __device__ __forceinline__ Staging(const float* x, const float* y1,
                                     const float* y2, int da, int d1, int d2,
                                     int i0, int j0, int tid) {
    row = tid / kTile;
    col = tid % kTile;
    x_in = i0 + col < da;
    xp = x_in ? x + i0 + col : x;
    xstride = x_in ? da : 0;
    const int j = j0 + col;
    y_in = j < d1 + d2;
    yp = j < d1 ? y1 + j : y_in ? y2 + (j - d1) : x;
    ystride = j < d1 ? d1 : y_in ? d2 : 0;
  }

  __device__ __forceinline__ void load(int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int kr = k0 + row + kStep * i;
      const bool in = kr < k_end;
      const size_t r = in ? kr : 0;  // rows past k_end read row 0, zeroed
      sx[i] = __ldg(xp + r * xstride);
      sy[i] = __ldg(yp + r * ystride);
      if (!(in && x_in)) sx[i] = 0.0f;
      if (!(in && y_in)) sy[i] = 0.0f;
    }
  }

  __device__ __forceinline__ void store(float* xs, float* ys) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int at = (row + kStep * i) * kRow + col;
      xs[at] = sx[i];
      ys[at] = sy[i];
    }
  }
};

// element (row i, column j) of the result: out1 for j < d1, else out2;
// with mirror, an element of out1 is written at (j, i) too
__device__ __forceinline__ void store_out(float* out1, float* out2, int i,
                                          int j, int d1, int d2, float v,
                                          bool mirror) {
  if (j < d1) {
    out1[static_cast<size_t>(i) * d1 + j] = v;
    if (mirror) out1[static_cast<size_t>(j) * d1 + i] = v;
  } else {
    out2[static_cast<size_t>(i) * d2 + (j - d1)] = v;
  }
}

// 2 blocks an SM (at most 128 registers a thread; split_plan's
// BLOCKS_PER_SM)
__global__ void __launch_bounds__(kThreads, 2)
gram_tf32_kernel(const float* __restrict__ x, const float* __restrict__ y1,
                 const float* __restrict__ y2, float* __restrict__ out1,
                 float* __restrict__ out2, float* __restrict__ part,
                 int* __restrict__ counters, int n, int da, int d1, int d2,
                 int rows_per_split, bool sym) {
  // with y1 == x (sym), x^T y1 is symmetric: the tiles below its diagonal
  // are left out, and the tiles above it write their transposes too.  Such
  // a tile lies wholly in x^T y1 (its columns end before its rows begin,
  // and da == d1)
  if (sym && blockIdx.y > blockIdx.x) return;
  const bool mirror = sym && blockIdx.y < blockIdx.x;
  // two stages of x and of [y1 | y2], [2][kChunk][kRow] each
  __shared__ __align__(16) float xs[2 * kStage];
  __shared__ __align__(16) float ys[2 * kStage];
  __shared__ bool last_block;

  const int dc = d1 + d2;             // columns of the result
  const int i0 = blockIdx.y * kTile;  // rows of the result = columns of x
  const int j0 = blockIdx.x * kTile;  // columns of the result
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(n, k_begin + rows_per_split);
  const int chunks = (k_end - k_begin + kChunk - 1) / kChunk;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int group = warp / 4;  // the k8 steps 2 group, 2 group + 1 of a chunk
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = 32 * ((warp % 4) / 2);  // this warp's rows and columns
  const int wn = 32 * (warp % 2);
  bool m_in[2], n_in[4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) m_in[mi] = i0 + wm + 16 * mi < da;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) n_in[ni] = j0 + wn + 8 * ni < dc;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    }
  }

  // two stages in shared memory; the next chunk's loads are in flight in
  // registers while this chunk is multiplied
  Staging stage(x, y1, y2, da, d1, d2, i0, j0, tid);
  stage.load(k_begin, k_end);
  stage.store(xs, ys);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    if (more) stage.load(k_begin + (c + 1) * kChunk, k_end);
    const float* xc = xs + (c & 1) * kStage;
    const float* yc = ys + (c & 1) * kStage;
#pragma unroll
    for (int s2 = 0; s2 < kChunk / 16; ++s2) {
      const int ks = kChunk / 16 * group + s2;
      const float* xk = xc + (8 * ks + t) * kRow + wm + g;
      const float* yk = yc + (8 * ks + t) * kRow + wn + g;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A = x^T: a0 = (m g, k t), a1 = (m g + 8, k t), a2 = (m g, k t + 4),
        // a3 = (m g + 8, k t + 4), read from the [k][m] chunk
        const float* p = xk + 16 * mi;
        split_tf32(p[0], ah[mi][0], al[mi][0]);
        split_tf32(p[8], ah[mi][1], al[mi][1]);
        split_tf32(p[4 * kRow], ah[mi][2], al[mi][2]);
        split_tf32(p[4 * kRow + 8], ah[mi][3], al[mi][3]);
      }
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // b0 = (k t, n g), b1 = (k t + 4, n g)
        split_tf32(yk[8 * ni], bh[ni][0], bl[ni][0]);
        split_tf32(yk[4 * kRow + 8 * ni], bh[ni][1], bl[ni][1]);
      }
      // this k8 step's three products summed from zero (one truncation
      // relative to 8 products), in three passes over the independent n8
      // tiles, then added to acc with rounded FP32 adds
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (!m_in[mi]) continue;
        float d[4][4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (n_in[ni]) mma_tf32_zero(d[ni], al[mi], bh[ni][0], bh[ni][1]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (n_in[ni]) mma_tf32(d[ni], ah[mi], bl[ni][0], bl[ni][1]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (n_in[ni]) mma_tf32(d[ni], ah[mi], bh[ni][0], bh[ni][1]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (n_in[ni]) acc[mi][ni][e] += d[ni][e];
          }
        }
      }
    }
    // the other stage was last read before the previous barrier
    if (more) stage.store(xs + ((c + 1) & 1) * kStage,
                          ys + ((c + 1) & 1) * kStage);
    __syncthreads();
  }

  // group 1's sums through shared memory into group 0's, in that order
  float* red = xs;  // 64 x 64 of its 4608 floats; the stages are consumed
  if (group == 1) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wm + 16 * mi + g + 8 * r;
          const int col = wn + 8 * ni + 2 * t;
          *reinterpret_cast<float2*>(red + row * kTile + col) = make_float2(
              acc[mi][ni][2 * r], acc[mi][ni][2 * r + 1]);
        }
      }
    }
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wm + 16 * mi + g + 8 * r;
          const int col = wn + 8 * ni + 2 * t;
          const float2 o =
              *reinterpret_cast<const float2*>(red + row * kTile + col);
          acc[mi][ni][2 * r] += o.x;
          acc[mi][ni][2 * r + 1] += o.y;
        }
      }
    }
  }

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t plane = static_cast<size_t>(gridDim.x) * gridDim.y * kTile *
                       kTile;  // floats of one split's partials
  if (group == 0) {
    if (gridDim.z == 1) {  // one split: the tile is the result
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + wm + 16 * mi + g + 8 * (e >> 1);
            const int j = j0 + wn + 8 * ni + 2 * t + (e & 1);
            if (i < da && j < dc) {
              store_out(out1, out2, i, j, d1, d2, acc[mi][ni][e], mirror);
            }
          }
        }
      }
    } else {  // this split's partial tile, whole and contiguous
      float* pt = part + blockIdx.z * plane +
                  static_cast<size_t>(tile) * kTile * kTile;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = wm + 16 * mi + g + 8 * r;
            const int col = wn + 8 * ni + 2 * t;
            *reinterpret_cast<float2*>(pt + row * kTile + col) = make_float2(
                acc[mi][ni][2 * r], acc[mi][ni][2 * r + 1]);
          }
        }
      }
    }
  }
  if (gridDim.z == 1) return;
  __threadfence();  // the partial is visible card-wide before it is counted
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(counters + tile, 1) == static_cast<int>(
                                                      gridDim.z) - 1;
  }
  __syncthreads();
  if (!last_block) return;

  // the last block of the tile: sum the partials in the order z = 0, 1, ...
  // Each thread owns float4 f = tid + 256 v (v < 4) of the tile (row f /
  // 16), and kUnroll splits' loads of them are in flight at once
  __threadfence();
  const int rows = min(kTile, da - i0);
  const int cols = min(kTile, dc - j0);
  const int splits = static_cast<int>(gridDim.z);
  const float4* p4 = reinterpret_cast<const float4*>(
      part + static_cast<size_t>(tile) * kTile * kTile);
  const size_t plane4 = plane / 4;
  constexpr int kQuads = kTile / 4;                  // float4 of a tile row
  constexpr int kVecs = kTile * kQuads / kThreads;   // float4 a thread sums
  constexpr int kUnroll = 4;                         // splits loaded at once
  const int c4 = 4 * (tid % kQuads);  // the same column for every v
  if (tid / kQuads < rows && c4 < cols) {
    float4 sum[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < splits; z0 += kUnroll) {
      float4 ld[kUnroll][kVecs];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          const int f = tid + kThreads * v;
          ld[u][v] = z0 + u < splits && f / kQuads < rows
                         ? __ldcg(p4 + (z0 + u) * plane4 + f)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          sum[v].x += ld[u][v].x;
          sum[v].y += ld[u][v].y;
          sum[v].z += ld[u][v].z;
          sum[v].w += ld[u][v].w;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int r = (tid + kThreads * v) / kQuads;
      if (r >= rows) break;
      const float e[4] = {sum[v].x, sum[v].y, sum[v].z, sum[v].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (c4 + q < cols) {
          store_out(out1, out2, i0 + r, j0 + c4 + q, d1, d2, e[q], mirror);
        }
      }
    }
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x: (n, da), y1: (n, d1), y2: (n, d2) row-major f32 on the device (y2 may
// be null when d2 is 0); out1: (da, d1), out2: (da, d2).  With splits > 1,
// part is a 16-byte-aligned scratch of splits * tiles * 64 * 64 floats, with
// tiles = ceil(da / 64) * ceil((d1 + d2) / 64), and counters holds at least
// tiles zeros, which the launch leaves at zero.  splits * rows_per_split
// must cover n, rows_per_split a multiple of 32.  Returns the cudaError_t of
// the launch.
extern "C" int ridge_gram_pair_f32(const float* x, const float* y1,
                                   const float* y2, float* out1, float* out2,
                                   float* part, int* counters, int n, int da,
                                   int d1, int d2, int splits,
                                   int rows_per_split, void* stream) {
  if (n < 1 || da < 1 || d1 < 1 || d2 < 0 || splits < 1 || splits > 65535 ||
      rows_per_split < 1 || rows_per_split % kChunk != 0 ||
      static_cast<long long>(splits) * rows_per_split < n ||
      (d2 > 0 && y2 == nullptr) ||
      (splits > 1 && (!aligned16(part) || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((d1 + d2 + kTile - 1) / kTile, (da + kTile - 1) / kTile,
                  splits);
  gram_tf32_kernel<<<grid, kThreads, 0, s>>>(
      x, y1, y2, out1, out2, part, counters, n, da, d1, d2, rows_per_split,
      x == y1 && da == d1);
  return static_cast<int>(cudaGetLastError());
}
