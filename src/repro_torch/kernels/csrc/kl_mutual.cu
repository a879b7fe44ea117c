// Per-row mutual-learning KL divergence and its gradient in x, f32 (paper
// eq. 5), with p = softmax(row / T):
//   kl[r] = D_KL(x_r || y_r) = sum_c p_y (log p_y - log p_x)
//   gx[r, c] = g[r] (p_x - p_y)[c] / T
//
// Replaces the Pallas TPU kernel repro/kernels/kl_mutual/kl_mutual.py
// (_kl_kernel / kl_rows_pallas), which the JAX wrapper vmaps once per client
// over (32, 256) blocks, and the closed-form backward of
// repro/kernels/kl_mutual/ops.py (_kl_bwd, plain jnp that XLA fuses into one
// pass).  Here one launch covers the whole cohort: the rows of all clients
// form one (R, d) array and one warp owns one row.
//
// Bound on an H100 SXM: memory.  At the main-path shape (1600, 256) the
// forward reads x and y and writes one float a row, (2 R d + R) 4 bytes =
// 3.28 MB, 0.98 us at 3.35 TB/s; the backward reads x, y and g and writes
// gx, (3 R d + R) 4 bytes = 4.92 MB, 1.47 us.  Their arithmetic (two exps
// and a few FMAs an element) is far below the FP32 peak.
//
// Design: one warp per row, 8 rows a block, all reductions by warp
// shuffles (no shared memory, no atomics).  Up to d = 1024 each lane holds
// its share of both rows in registers, N values each (N = ceil(d / 32)
// rounded up to a power of two, a template parameter): every load of the
// row is issued before any arithmetic, as float4 where d % 4 == 0 and the
// rows are 16-byte aligned (VEC), else one float at a time; then the max,
// the exps and their sum, and the contraction or the gradient, all in
// registers, so the row is read once and no running rescale is needed.
// Above d = 1024 a lane would hold more than 64 values, so the row is
// streamed instead: an online max with a rescaled sum in one pass, the
// contraction or the gradient in a second pass that reads the row again.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxPerLane = 32;  // values a lane holds in registers, per row
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

// the column of a lane's i-th value: float4 pieces lane, lane + 32, ...
// (VEC) or columns lane, lane + 32, ...
template <bool VEC>
__device__ __forceinline__ int column(int lane, int i) {
  return VEC ? 4 * (lane + 32 * (i / 4)) + i % 4 : lane + 32 * i;
}

// the lane's N values of a row of d floats; 0 beyond d
template <int N, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int d, int lane, float (&v)[N]) {
  if constexpr (VEC) {
    static_assert(N % 4 == 0, "whole float4 pieces");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int c = lane + 32 * i;
      const float4 a = 4 * c < d ? reinterpret_cast<const float4*>(src)[c]
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < d ? src[c] : 0.0f;
    }
  }
}

// x <- exp(x / T - mx) and y <- exp(y / T - my), 0 beyond d, with mx, my
// the row maxima of x / T and y / T and sx, sy the row sums of the exps
template <int N, bool VEC>
__device__ __forceinline__ void softmax_terms(float (&x)[N], float (&y)[N],
                                              int d, int lane, float inv_t,
                                              float& mx, float& sx,
                                              float& my, float& sy) {
  mx = -INFINITY;
  my = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] *= inv_t;
    y[i] *= inv_t;
    if (column<VEC>(lane, i) < d) {
      mx = fmaxf(mx, x[i]);
      my = fmaxf(my, y[i]);
    }
  }
  mx = warp_max(mx);
  my = warp_max(my);
  sx = 0.0f;
  sy = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool in = column<VEC>(lane, i) < d;
    x[i] = in ? expf(x[i] - mx) : 0.0f;
    y[i] = in ? expf(y[i] - my) : 0.0f;
    sx += x[i];
    sy += y[i];
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
}

template <int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
kl_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int rows, int d, float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // row is uniform across the warp
  float xv[N], yv[N];
  load_row<N, VEC>(x + static_cast<size_t>(row) * d, d, lane, xv);
  load_row<N, VEC>(y + static_cast<size_t>(row) * d, d, lane, yv);
  // log p_y - log p_x = (y - x) / T + (mx + log sx) - (my + log sy)
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = (yv[i] - xv[i]) * inv_t;
  float mx, sx, my, sy;
  softmax_terms<N, VEC>(xv, yv, d, lane, inv_t, mx, sx, my, sy);
  const float c = (mx + logf(sx)) - (my + logf(sy));
  float acc = 0.0f;  // sum of exp(y / T - my) (log p_y - log p_x)
#pragma unroll
  for (int i = 0; i < N; ++i) acc += yv[i] * (t[i] + c);
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc / sy;
}

template <int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
kl_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ g, int64_t g_stride,
               float* __restrict__ gx, int rows, int d, float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  float xv[N], yv[N];
  load_row<N, VEC>(x + static_cast<size_t>(row) * d, d, lane, xv);
  load_row<N, VEC>(y + static_cast<size_t>(row) * d, d, lane, yv);
  const float gr = g[row * g_stride];
  float mx, sx, my, sy;
  softmax_terms<N, VEC>(xv, yv, d, lane, inv_t, mx, sx, my, sy);
  float* gxr = gx + static_cast<size_t>(row) * d;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = gr * (xv[i] / sx - yv[i] / sy) * inv_t;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int c = lane + 32 * i;
      if (4 * c < d) {
        reinterpret_cast<float4*>(gxr)[c] =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (c < d) gxr[c] = v[i];
    }
  }
}

// --- rows of more than 32 kMaxPerLane floats: streamed ------------------

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

// the row maxima of x / T and y / T and the sums of exp(. - max), in one
// pass over the row
__device__ __forceinline__ void online_stats(const float* __restrict__ xr,
                                             const float* __restrict__ yr,
                                             int d, int lane, float inv_t,
                                             float& mx, float& sx, float& my,
                                             float& sy) {
  mx = -INFINITY;
  sx = 0.0f;
  my = -INFINITY;
  sy = 0.0f;
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
}

__global__ void __launch_bounds__(kThreads)
kl_rows_online_kernel(const float* __restrict__ x,
                      const float* __restrict__ y, float* __restrict__ out,
                      int rows, int d, float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  const float* yr = y + static_cast<size_t>(row) * d;
  float mx, sx, my, sy;
  online_stats(xr, yr, d, lane, inv_t, mx, sx, my, sy);
  const float lsx = logf(sx), lsy = logf(sy);
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float lpx = (xr[c] * inv_t - mx) - lsx;
    const float lpy = (yr[c] * inv_t - my) - lsy;
    acc += expf(lpy) * (lpy - lpx);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

__global__ void __launch_bounds__(kThreads)
kl_grad_online_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      const float* __restrict__ g, int64_t g_stride,
                      float* __restrict__ gx, int rows, int d, float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  const float* yr = y + static_cast<size_t>(row) * d;
  float mx, sx, my, sy;
  online_stats(xr, yr, d, lane, inv_t, mx, sx, my, sy);
  const float gr = g[row * g_stride];
  float* gxr = gx + static_cast<size_t>(row) * d;
  for (int c = lane; c < d; c += 32) {
    const float px = expf(xr[c] * inv_t - mx) / sx;
    const float py = expf(yr[c] * inv_t - my) / sy;
    gxr[c] = gr * (px - py) * inv_t;
  }
}

// N of a row of d floats: the lane's values rounded up to a power of two
// (at least 4 with float4 pieces), or 0 when the row is streamed
int per_lane(int d, bool vec) {
  if (d > 32 * kMaxPerLane) return 0;
  const int need = vec ? 4 * ((d / 4 + 31) / 32) : (d + 31) / 32;
  int n = vec ? 4 : 1;
  while (n < need) n *= 2;
  return n;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x, y: (rows, d) row-major f32 on the device; out: (rows,) f32.
extern "C" int kl_mutual_rows_f32(const float* x, const float* y, float* out,
                                  int rows, int d, float inv_t, void* stream) {
  if (rows > 0 && d > 0) {
    const bool vec = d % 4 == 0 && aligned16(x) && aligned16(y);
    const int n = per_lane(d, vec);
    const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n == 0) {
      kl_rows_online_kernel<<<grid, kThreads, 0, s>>>(x, y, out, rows, d,
                                                      inv_t);
    } else {
#define REPRO_KL_FWD(N, VEC)                                             \
  kl_rows_kernel<N, VEC><<<grid, kThreads, 0, s>>>(x, y, out, rows, d, inv_t)
      switch (vec ? -n : n) {
        case -4: REPRO_KL_FWD(4, true); break;
        case -8: REPRO_KL_FWD(8, true); break;
        case -16: REPRO_KL_FWD(16, true); break;
        case -32: REPRO_KL_FWD(32, true); break;
        case 1: REPRO_KL_FWD(1, false); break;
        case 2: REPRO_KL_FWD(2, false); break;
        case 4: REPRO_KL_FWD(4, false); break;
        case 8: REPRO_KL_FWD(8, false); break;
        case 16: REPRO_KL_FWD(16, false); break;
        default: REPRO_KL_FWD(32, false); break;
#undef REPRO_KL_FWD
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y, gx: (rows, d) row-major f32 on the device; g: rows f32 values at a
// stride of g_stride floats (0: one value for every row).  gx = g (p_x -
// p_y) / T per row, T = 1 / inv_t.
extern "C" int kl_mutual_grad_f32(const float* x, const float* y,
                                  const float* g, int64_t g_stride,
                                  float* gx, int rows, int d, float inv_t,
                                  void* stream) {
  if (rows > 0 && d > 0) {
    const bool vec =
        d % 4 == 0 && aligned16(x) && aligned16(y) && aligned16(gx);
    const int n = per_lane(d, vec);
    const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n == 0) {
      kl_grad_online_kernel<<<grid, kThreads, 0, s>>>(x, y, g, g_stride, gx,
                                                      rows, d, inv_t);
    } else {
#define REPRO_KL_BWD(N, VEC)                                            \
  kl_grad_kernel<N, VEC><<<grid, kThreads, 0, s>>>(x, y, g, g_stride, gx, \
                                                   rows, d, inv_t)
      switch (vec ? -n : n) {
        case -4: REPRO_KL_BWD(4, true); break;
        case -8: REPRO_KL_BWD(8, true); break;
        case -16: REPRO_KL_BWD(16, true); break;
        case -32: REPRO_KL_BWD(32, true); break;
        case 1: REPRO_KL_BWD(1, false); break;
        case 2: REPRO_KL_BWD(2, false); break;
        case 4: REPRO_KL_BWD(4, false); break;
        case 8: REPRO_KL_BWD(8, false); break;
        case 16: REPRO_KL_BWD(16, false); break;
        default: REPRO_KL_BWD(32, false); break;
#undef REPRO_KL_BWD
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
