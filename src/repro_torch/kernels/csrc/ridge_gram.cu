// Gram product G = X^T Y with f32 accumulation, x: (n, d1), y: (n, d2) -> (d1, d2).
// The Step-4 analytic inversion (paper eq. 9) forms A0 = O^T O and A1 = O^T Z
// with it for every server layer.
//
// Replaces the Pallas TPU kernel repro/kernels/ridge_gram/ridge_gram.py
// (_gram_kernel / gram_pallas), which accumulates into its output block over
// the sequential innermost grid axis k.  Blocks on Hopper run in no order on
// 132 SMs, so nothing carries between them; and the output here is small
// (at most 257 x 257, so at most 81 tiles of 32 x 32) while n is long (4800 on
// the main path).  The design therefore splits the contraction over n
// across gridDim.z: each block computes one 32 x 32 output tile over its
// share of rows, staging 32-row chunks of X and Y through shared memory and
// accumulating with f32 FFMA, and writes its partial tile to a scratch of
// shape (splits, d1, d2).  A second kernel sums the partials in a fixed
// order, so the result is deterministic: no atomics.
//
// Bound on an H100 SXM: FP32 operations.  The 16 Grams of one DNN10
// evaluation at n = 4800 are 1.7 GFLOP, about 26 us at the 67 TFLOP/s
// non-tensor FP32 peak; their inputs are about 51 MB, 15 us at 3.35 TB/s.
// Tensor cores (TF32) are not used: the Gram feeds a ridge solve
// with gamma = 1e-3 that is ill-conditioned and held at 1e-5.
//
// Ragged d1, d2 and n are masked in the kernel (zero-filled loads, guarded
// stores); nothing is padded on the host.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // output tile edge
constexpr int kChunk = 32;    // rows of n staged per shared-memory step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ part, int n, int d1, int d2,
                    int rows_per_split) {
  __shared__ float xs[kChunk][kTile];
  __shared__ float ys[kChunk][kTile];

  const int i0 = blockIdx.y * kTile;  // rows of G = columns of x
  const int j0 = blockIdx.x * kTile;  // cols of G = columns of y
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(n, k_begin + rows_per_split);

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;   // compute layout: 16 x 16 threads
  const int lc = t & 31, lr = t >> 5;   // load layout: 8 rows x 32 columns
  const bool x_col = i0 + lc < d1;
  const bool y_col = j0 + lc < d2;

  float acc00 = 0.0f, acc01 = 0.0f, acc10 = 0.0f, acc11 = 0.0f;
  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
#pragma unroll
    for (int q = 0; q < kChunk / 8; ++q) {
      const int r = lr + 8 * q;
      const int kr = k0 + r;
      const bool in = kr < k_end;
      xs[r][lc] = (in && x_col) ? x[static_cast<size_t>(kr) * d1 + i0 + lc]
                                : 0.0f;
      ys[r][lc] = (in && y_col) ? y[static_cast<size_t>(kr) * d2 + j0 + lc]
                                : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float a0 = xs[kk][ty], a1 = xs[kk][ty + 16];
      const float b0 = ys[kk][tx], b1 = ys[kk][tx + 16];
      acc00 = fmaf(a0, b0, acc00);
      acc01 = fmaf(a0, b1, acc01);
      acc10 = fmaf(a1, b0, acc10);
      acc11 = fmaf(a1, b1, acc11);
    }
    __syncthreads();
  }

  float* p = part + static_cast<size_t>(blockIdx.z) * d1 * d2;
  const int ia = i0 + ty, ib = i0 + ty + 16;
  const int ja = j0 + tx, jb = j0 + tx + 16;
  if (ia < d1 && ja < d2) p[static_cast<size_t>(ia) * d2 + ja] = acc00;
  if (ia < d1 && jb < d2) p[static_cast<size_t>(ia) * d2 + jb] = acc01;
  if (ib < d1 && ja < d2) p[static_cast<size_t>(ib) * d2 + ja] = acc10;
  if (ib < d1 && jb < d2) p[static_cast<size_t>(ib) * d2 + jb] = acc11;
}

// out[e] = sum over z of part[z][e], in order z = 0, 1, ...
__global__ void gram_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int splits,
                                   long long elems) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= elems) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[z * elems + e];
  out[e] = s;
}

}  // namespace

// x: (n, d1), y: (n, d2) row-major f32 on the device; part: (splits, d1, d2)
// scratch; out: (d1, d2).  splits * rows_per_split must cover n.
extern "C" int ridge_gram_f32(const float* x, const float* y, float* part,
                              float* out, int n, int d1, int d2, int splits,
                              int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((d2 + kTile - 1) / kTile, (d1 + kTile - 1) / kTile, splits);
  gram_partial_kernel<<<grid, kThreads, 0, s>>>(x, y, part, n, d1, d2,
                                                rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(d1) * d2;
  const int blocks = static_cast<int>((elems + kThreads - 1) / kThreads);
  gram_reduce_kernel<<<blocks, kThreads, 0, s>>>(part, out, splits, elems);
  return static_cast<int>(cudaGetLastError());
}
