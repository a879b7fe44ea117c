// Per-row mutual-learning KL divergence and its gradient in x (paper eq. 5),
// with p = softmax(row / T):
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
//
// Operand types: x and y are each f32 or bf16 (the Pallas kernel widens
// each operand in its body; under the bf16 policy the client phase gives
// bf16 x against f32 y, the server phase f32 x against bf16 y).  The kernels
// are templated on both element types and read bf16 rows themselves, with
// no widened copy before the launch; all arithmetic is f32, and gx is
// stored in x's type (bf16 by __float2bfloat16_rn, round to nearest even
// like XLA's convert).  A row loads in pieces of W elements: W = 4 (one
// float4) for the f32 pair, whose entries kl_mutual_rows_f32 /
// kl_mutual_grad_f32 are unchanged; W = 8 for every pair with a bf16
// operand (16 bytes of bf16, two float4 of f32), where d % 8 == 0 and the
// rows are 16-byte aligned; else one element at a time.  The bytes bound
// of the forward is R d (s_x + s_y) + 4 R, of the backward R d (2 s_x +
// s_y) + 4 R, s the element sizes: a bf16 operand halves its share.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxPerLane = 32;  // values a lane holds in registers, per row
constexpr unsigned kFullMask = 0xffffffffu;

using bf16 = __nv_bfloat16;

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

// one element of a row, as f32, and its store from f32
__device__ __forceinline__ float load1(const float* p, int c) { return p[c]; }
__device__ __forceinline__ float load1(const bf16* p, int c) {
  return __bfloat162float(p[c]);
}
__device__ __forceinline__ void store1(float* p, int c, float v) { p[c] = v; }
__device__ __forceinline__ void store1(bf16* p, int c, float v) {
  p[c] = __float2bfloat16_rn(v);
}

// the two bf16 of a 32-bit word, low half first, widened exactly
__device__ __forceinline__ void unpack2(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

// piece c of W elements of a row (elements W c ... W c + W - 1) into v:
// f32 as W / 4 float4, bf16 as W / 8 pieces of 16 bytes
template <int W>
__device__ __forceinline__ void load_piece(const float* __restrict__ src,
                                           int c, float* v) {
  static_assert(W % 4 == 0, "whole float4 pieces");
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const float4 a = reinterpret_cast<const float4*>(src)[(W / 4) * c + j];
    v[4 * j] = a.x;
    v[4 * j + 1] = a.y;
    v[4 * j + 2] = a.z;
    v[4 * j + 3] = a.w;
  }
}

template <int W>
__device__ __forceinline__ void load_piece(const bf16* __restrict__ src,
                                           int c, float* v) {
  static_assert(W % 8 == 0, "whole 16-byte pieces");
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const uint4 a = reinterpret_cast<const uint4*>(src)[(W / 8) * c + j];
    unpack2(a.x, v + 8 * j);
    unpack2(a.y, v + 8 * j + 2);
    unpack2(a.z, v + 8 * j + 4);
    unpack2(a.w, v + 8 * j + 6);
  }
}

template <int W>
__device__ __forceinline__ void store_piece(float* __restrict__ dst, int c,
                                            const float* v) {
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    reinterpret_cast<float4*>(dst)[(W / 4) * c + j] =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

template <int W>
__device__ __forceinline__ void store_piece(bf16* __restrict__ dst, int c,
                                            const float* v) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float* u = v + 8 * j;
    reinterpret_cast<uint4*>(dst)[(W / 8) * c + j] =
        make_uint4(pack2(u[0], u[1]), pack2(u[2], u[3]), pack2(u[4], u[5]),
                   pack2(u[6], u[7]));
  }
}

// the column of a lane's i-th value: pieces of W elements lane, lane + 32,
// ... (W > 1) or columns lane, lane + 32, ... (W = 1)
template <int W>
__device__ __forceinline__ int column(int lane, int i) {
  return W > 1 ? W * (lane + 32 * (i / W)) + i % W : lane + 32 * i;
}

// the lane's N values of a row of d elements, as f32; 0 beyond d
template <int N, int W, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int d,
                                         int lane, float (&v)[N]) {
  if constexpr (W > 1) {
    static_assert(N % W == 0, "whole pieces");
#pragma unroll
    for (int i = 0; i < N / W; ++i) {
      const int c = lane + 32 * i;
      if (W * c < d) {
        load_piece<W>(src, c, v + W * i);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) v[W * i + j] = 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < d ? load1(src, c) : 0.0f;
    }
  }
}

// x <- exp(x / T - mx) and y <- exp(y / T - my), 0 beyond d, with mx, my
// the row maxima of x / T and y / T and sx, sy the row sums of the exps
template <int N, int W>
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
    if (column<W>(lane, i) < d) {
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
    const bool in = column<W>(lane, i) < d;
    x[i] = in ? expf(x[i] - mx) : 0.0f;
    y[i] = in ? expf(y[i] - my) : 0.0f;
    sx += x[i];
    sy += y[i];
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
}

template <int N, int W, typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
kl_rows_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
               float* __restrict__ out, int rows, int d, float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // row is uniform across the warp
  float xv[N], yv[N];
  load_row<N, W>(x + static_cast<size_t>(row) * d, d, lane, xv);
  load_row<N, W>(y + static_cast<size_t>(row) * d, d, lane, yv);
  // log p_y - log p_x = (y - x) / T + (mx + log sx) - (my + log sy)
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = (yv[i] - xv[i]) * inv_t;
  float mx, sx, my, sy;
  softmax_terms<N, W>(xv, yv, d, lane, inv_t, mx, sx, my, sy);
  const float c = (mx + logf(sx)) - (my + logf(sy));
  float acc = 0.0f;  // sum of exp(y / T - my) (log p_y - log p_x)
#pragma unroll
  for (int i = 0; i < N; ++i) acc += yv[i] * (t[i] + c);
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc / sy;
}

template <int N, int W, typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
kl_grad_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
               const float* __restrict__ g, int64_t g_stride,
               TX* __restrict__ gx, int rows, int d, float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  float xv[N], yv[N];
  load_row<N, W>(x + static_cast<size_t>(row) * d, d, lane, xv);
  load_row<N, W>(y + static_cast<size_t>(row) * d, d, lane, yv);
  const float gr = g[row * g_stride];
  float mx, sx, my, sy;
  softmax_terms<N, W>(xv, yv, d, lane, inv_t, mx, sx, my, sy);
  TX* gxr = gx + static_cast<size_t>(row) * d;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = gr * (xv[i] / sx - yv[i] / sy) * inv_t;
  if constexpr (W > 1) {
#pragma unroll
    for (int i = 0; i < N / W; ++i) {
      const int c = lane + 32 * i;
      if (W * c < d) store_piece<W>(gxr, c, v + W * i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (c < d) store1(gxr, c, v[i]);
    }
  }
}

// --- rows of more than 32 kMaxPerLane values: streamed ------------------

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
template <typename TX, typename TY>
__device__ __forceinline__ void online_stats(const TX* __restrict__ xr,
                                             const TY* __restrict__ yr,
                                             int d, int lane, float inv_t,
                                             float& mx, float& sx, float& my,
                                             float& sy) {
  mx = -INFINITY;
  sx = 0.0f;
  my = -INFINITY;
  sy = 0.0f;
  for (int c = lane; c < d; c += 32) {
    online_add(mx, sx, load1(xr, c) * inv_t);
    online_add(my, sy, load1(yr, c) * inv_t);
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

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
kl_rows_online_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
                      float* __restrict__ out, int rows, int d,
                      float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + static_cast<size_t>(row) * d;
  const TY* yr = y + static_cast<size_t>(row) * d;
  float mx, sx, my, sy;
  online_stats(xr, yr, d, lane, inv_t, mx, sx, my, sy);
  const float lsx = logf(sx), lsy = logf(sy);
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float lpx = (load1(xr, c) * inv_t - mx) - lsx;
    const float lpy = (load1(yr, c) * inv_t - my) - lsy;
    acc += expf(lpy) * (lpy - lpx);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
kl_grad_online_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
                      const float* __restrict__ g, int64_t g_stride,
                      TX* __restrict__ gx, int rows, int d, float inv_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + static_cast<size_t>(row) * d;
  const TY* yr = y + static_cast<size_t>(row) * d;
  float mx, sx, my, sy;
  online_stats(xr, yr, d, lane, inv_t, mx, sx, my, sy);
  const float gr = g[row * g_stride];
  TX* gxr = gx + static_cast<size_t>(row) * d;
  for (int c = lane; c < d; c += 32) {
    const float px = expf(load1(xr, c) * inv_t - mx) / sx;
    const float py = expf(load1(yr, c) * inv_t - my) / sy;
    store1(gxr, c, gr * (px - py) * inv_t);
  }
}

// N of a row of d elements loaded in pieces of w: the lane's values rounded
// up to a power of two (at least w), or 0 when the row is streamed
int per_lane(int d, int w) {
  if (d > 32 * kMaxPerLane) return 0;
  const int need = w > 1 ? w * ((d / w + 31) / 32) : (d + 31) / 32;
  int n = w;
  while (n < need) n *= 2;
  return n;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the piece width of a pair: float4 for two f32 rows, 16 bytes of bf16 (two
// float4 of f32) for every pair with a bf16 row
template <typename TX, typename TY>
constexpr int piece_width() {
  return std::is_same<TX, float>::value && std::is_same<TY, float>::value
             ? 4
             : 8;
}

// one launch of kernel<N, W> for the lane count n (a power of two, at least
// W; 32 for larger)
template <int N, int W, typename TX, typename TY>
void rows_at(dim3 grid, cudaStream_t s, const TX* x, const TY* y, float* out,
             int rows, int d, float inv_t) {
  kl_rows_kernel<N, W, TX, TY><<<grid, kThreads, 0, s>>>(x, y, out, rows, d,
                                                         inv_t);
}

template <int W, typename TX, typename TY>
void rows_by_lanes(int n, dim3 grid, cudaStream_t s, const TX* x,
                   const TY* y, float* out, int rows, int d, float inv_t) {
  switch (n) {
    case 1:
      if constexpr (W == 1) rows_at<1, W>(grid, s, x, y, out, rows, d, inv_t);
      break;
    case 2:
      if constexpr (W == 1) rows_at<2, W>(grid, s, x, y, out, rows, d, inv_t);
      break;
    case 4:
      if constexpr (W <= 4) rows_at<4, W>(grid, s, x, y, out, rows, d, inv_t);
      break;
    case 8: rows_at<8, W>(grid, s, x, y, out, rows, d, inv_t); break;
    case 16: rows_at<16, W>(grid, s, x, y, out, rows, d, inv_t); break;
    default: rows_at<32, W>(grid, s, x, y, out, rows, d, inv_t); break;
  }
}

template <int N, int W, typename TX, typename TY>
void grad_at(dim3 grid, cudaStream_t s, const TX* x, const TY* y,
             const float* g, int64_t g_stride, TX* gx, int rows, int d,
             float inv_t) {
  kl_grad_kernel<N, W, TX, TY><<<grid, kThreads, 0, s>>>(x, y, g, g_stride,
                                                         gx, rows, d, inv_t);
}

template <int W, typename TX, typename TY>
void grad_by_lanes(int n, dim3 grid, cudaStream_t s, const TX* x,
                   const TY* y, const float* g, int64_t g_stride, TX* gx,
                   int rows, int d, float inv_t) {
  switch (n) {
    case 1:
      if constexpr (W == 1) {
        grad_at<1, W>(grid, s, x, y, g, g_stride, gx, rows, d, inv_t);
      }
      break;
    case 2:
      if constexpr (W == 1) {
        grad_at<2, W>(grid, s, x, y, g, g_stride, gx, rows, d, inv_t);
      }
      break;
    case 4:
      if constexpr (W <= 4) {
        grad_at<4, W>(grid, s, x, y, g, g_stride, gx, rows, d, inv_t);
      }
      break;
    case 8:
      grad_at<8, W>(grid, s, x, y, g, g_stride, gx, rows, d, inv_t);
      break;
    case 16:
      grad_at<16, W>(grid, s, x, y, g, g_stride, gx, rows, d, inv_t);
      break;
    default:
      grad_at<32, W>(grid, s, x, y, g, g_stride, gx, rows, d, inv_t);
      break;
  }
}

template <typename TX, typename TY>
int launch_rows(const void* xp, const void* yp, float* out, int rows, int d,
                float inv_t, void* stream) {
  if (rows > 0 && d > 0) {
    constexpr int W = piece_width<TX, TY>();
    const TX* x = static_cast<const TX*>(xp);
    const TY* y = static_cast<const TY*>(yp);
    const bool vec = d % W == 0 && aligned16(x) && aligned16(y);
    const int n = per_lane(d, vec ? W : 1);
    const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n == 0) {
      kl_rows_online_kernel<TX, TY><<<grid, kThreads, 0, s>>>(x, y, out, rows,
                                                              d, inv_t);
    } else if (vec) {
      rows_by_lanes<W>(n, grid, s, x, y, out, rows, d, inv_t);
    } else {
      rows_by_lanes<1>(n, grid, s, x, y, out, rows, d, inv_t);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY>
int launch_grad(const void* xp, const void* yp, const float* g,
                int64_t g_stride, void* gxp, int rows, int d, float inv_t,
                void* stream) {
  if (rows > 0 && d > 0) {
    constexpr int W = piece_width<TX, TY>();
    const TX* x = static_cast<const TX*>(xp);
    const TY* y = static_cast<const TY*>(yp);
    TX* gx = static_cast<TX*>(gxp);
    const bool vec =
        d % W == 0 && aligned16(x) && aligned16(y) && aligned16(gx);
    const int n = per_lane(d, vec ? W : 1);
    const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n == 0) {
      kl_grad_online_kernel<TX, TY><<<grid, kThreads, 0, s>>>(
          x, y, g, g_stride, gx, rows, d, inv_t);
    } else if (vec) {
      grad_by_lanes<W>(n, grid, s, x, y, g, g_stride, gx, rows, d, inv_t);
    } else {
      grad_by_lanes<1>(n, grid, s, x, y, g, g_stride, gx, rows, d, inv_t);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, d) row-major on the device (f32 here, f32 or bf16 each in
// the entries below); out: (rows,) f32.
extern "C" int kl_mutual_rows_f32(const float* x, const float* y, float* out,
                                  int rows, int d, float inv_t, void* stream) {
  return launch_rows<float, float>(x, y, out, rows, d, inv_t, stream);
}

extern "C" int kl_mutual_rows_bf16_f32(const void* x, const void* y,
                                       float* out, int rows, int d,
                                       float inv_t, void* stream) {
  return launch_rows<bf16, float>(x, y, out, rows, d, inv_t, stream);
}

extern "C" int kl_mutual_rows_f32_bf16(const void* x, const void* y,
                                       float* out, int rows, int d,
                                       float inv_t, void* stream) {
  return launch_rows<float, bf16>(x, y, out, rows, d, inv_t, stream);
}

extern "C" int kl_mutual_rows_bf16_bf16(const void* x, const void* y,
                                        float* out, int rows, int d,
                                        float inv_t, void* stream) {
  return launch_rows<bf16, bf16>(x, y, out, rows, d, inv_t, stream);
}

// x, y, gx: (rows, d) row-major on the device, gx in x's type; g: rows f32
// values at a stride of g_stride floats (0: one value for every row).  gx =
// g (p_x - p_y) / T per row, T = 1 / inv_t.
extern "C" int kl_mutual_grad_f32(const float* x, const float* y,
                                  const float* g, int64_t g_stride,
                                  float* gx, int rows, int d, float inv_t,
                                  void* stream) {
  return launch_grad<float, float>(x, y, g, g_stride, gx, rows, d, inv_t,
                                   stream);
}

extern "C" int kl_mutual_grad_bf16_f32(const void* x, const void* y,
                                       const float* g, int64_t g_stride,
                                       void* gx, int rows, int d,
                                       float inv_t, void* stream) {
  return launch_grad<bf16, float>(x, y, g, g_stride, gx, rows, d, inv_t,
                                  stream);
}

extern "C" int kl_mutual_grad_f32_bf16(const void* x, const void* y,
                                       const float* g, int64_t g_stride,
                                       void* gx, int rows, int d,
                                       float inv_t, void* stream) {
  return launch_grad<float, bf16>(x, y, g, g_stride, gx, rows, d, inv_t,
                                  stream);
}

extern "C" int kl_mutual_grad_bf16_bf16(const void* x, const void* y,
                                        const float* g, int64_t g_stride,
                                        void* gx, int rows, int d,
                                        float inv_t, void* stream) {
  return launch_grad<bf16, bf16>(x, y, g, g_stride, gx, rows, d, inv_t,
                                 stream);
}
