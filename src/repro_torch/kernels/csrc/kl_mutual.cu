// Per-row mutual-learning KL divergence, D_KL(x || y) = sum p_y (log p_y - log p_x)
// with p = softmax(logits / T), f32 (paper eq. 5).
//
// Replaces the Pallas TPU kernel repro/kernels/kl_mutual/kl_mutual.py
// (_kl_kernel / kl_rows_pallas), which the JAX wrapper vmaps once per client
// over (32, 256) blocks.  Here one launch covers the whole cohort: the rows of
// all clients form one (R, d) array and one warp owns one row.
//
// Bound on an H100 SXM: memory.  At the main-path shape (1600, 256) the kernel
// must read 3.3 MB and write 6.4 KB, about 1 us at 3.35 TB/s, while its
// arithmetic (two exps and a few FMAs per element) is far below the FP32
// peak.  At that size launch overhead dominates; the design keeps each row's
// data to two reads (the second from L1) and one 4-byte write, and does all
// reductions with warp shuffles, no shared memory and no atomics.
//
// Pass 1: online max and sum of exp for both rows at once (a running max with
// rescaled sum per lane, then merged across the warp).
// Pass 2: the KL contraction from the two log-sum-exps, summed across the warp.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// add one value v to a running (max m, sum s of exp(. - m)) pair
__device__ __forceinline__ void online_add(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.0f;  // m = -inf on the first value: s = 0
    m = v;
  } else {
    s += expf(v - m);
  }
}

// merge the pair (m2, s2) of another lane into (m, s)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;  // the other lane saw no column
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

__global__ void kl_rows_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               float* __restrict__ out, int rows, int d,
                               float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // row is uniform across the warp
  const float* xr = x + static_cast<size_t>(row) * d;
  const float* yr = y + static_cast<size_t>(row) * d;

  float mx = -INFINITY, sx = 0.0f, my = -INFINITY, sy = 0.0f;
  for (int c = lane; c < d; c += 32) {
    online_add(mx, sx, xr[c] * inv_t);
    online_add(my, sy, yr[c] * inv_t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mx2 = __shfl_xor_sync(kFullMask, mx, off);
    const float sx2 = __shfl_xor_sync(kFullMask, sx, off);
    const float my2 = __shfl_xor_sync(kFullMask, my, off);
    const float sy2 = __shfl_xor_sync(kFullMask, sy, off);
    merge(mx, sx, mx2, sx2);
    merge(my, sy, my2, sy2);
  }
  const float lsx = logf(sx), lsy = logf(sy);

  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float lpx = (xr[c] * inv_t - mx) - lsx;
    const float lpy = (yr[c] * inv_t - my) - lsy;
    acc += expf(lpy) * (lpy - lpx);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFullMask, acc, off);
  }
  if (lane == 0) out[row] = acc;
}

}  // namespace

// x, y: (rows, d) row-major f32 on the device; out: (rows,) f32.
extern "C" int kl_mutual_rows_f32(const float* x, const float* y, float* out,
                                  int rows, int d, float inv_t, void* stream) {
  if (rows > 0 && d > 0) {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    kl_rows_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, out, rows, d,
                                                          inv_t);
  }
  return static_cast<int>(cudaGetLastError());
}
