// Mamba2 SSD scan in its plain sequential form, f32:
//   h_t = a_t h_{t-1} + dt_t B_t (x) x_t   (an (N, P) state per head)
//   y_t = C_t h_t
// per (batch, head), from h = 0.  decay (a) and dt are (b, L, nh); B and C are
// (b, L, N), shared by all heads of a batch row; x and y are (b, L, nh, P);
// all row-major.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba2_scan/mamba2_scan.py
// (_ssd_kernel / mamba2_scan_pallas).  That kernel computes the chunked SSD
// form with MXU matmuls over Q-token chunks in a sequential grid axis.  This
// kernel computes the same function in the recurrence's own order, which
// also agrees more tightly with the JAX model's scan path than the chunked
// form does.
//
// Layout: one block per (batch, head); P threads (rounded up to a warp);
// thread p keeps column p of the state, h[:, p], in MAXN registers.  Per
// chunk of Q steps the block stages a_t and dt_t of its head, the (Q, N)
// tiles of B and C (broadcast reads in the step loop) and the (Q, P) tile of
// x, all with coalesced loads; then each thread runs the Q steps inside its
// own registers: h[n] = a h[n] + B[n] (dt x[p]), y[p] = sum_n C[n] h[n] (four
// partial sums), with no cross-thread reduction.  State rows n >= N see
// B = C = 0 and stay 0.
//
// Bound on an H100 SXM at Zamba2-2.7B (nh 80, N 64, P 64), b 4, L 2048: FP32
// operations, 13.4 GFLOP (200 us at 67 TFLOP/s) against 345 MB moved (103
// us).  The grid is 320 blocks of 64 threads and each block is a chain of L
// dependent steps: latency-bound.  The chunked form on tensor cores is later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 128;

template <int MAXN>
__global__ void __launch_bounds__(kMaxP)
ssd_kernel(const float* __restrict__ decay, const float* __restrict__ dt,
           const float* __restrict__ B, const float* __restrict__ C,
           const float* __restrict__ x, float* __restrict__ y, int L, int nh,
           int N, int P) {
  constexpr int Q = MAXN >= 128 ? 16 : 32;  // steps per staged chunk
  __shared__ float a_s[Q];
  __shared__ float dt_s[Q];
  __shared__ float B_s[Q][MAXN];
  __shared__ float C_s[Q][MAXN];
  __shared__ float x_s[Q][kMaxP];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p = threadIdx.x;
  const int threads = blockDim.x;
  const bool live = p < P;
  const size_t row0 = static_cast<size_t>(b) * L;  // (b, 0) in (b, L, .)

  float hs[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) hs[n] = 0.0f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int nq = min(Q, L - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int q = p; q < nq; q += threads) {
      const size_t at = (row0 + t0 + q) * nh + h;
      a_s[q] = decay[at];
      dt_s[q] = dt[at];
    }
    for (int e = p; e < nq * MAXN; e += threads) {
      const int q = e / MAXN, n = e % MAXN;
      const size_t at = (row0 + t0 + q) * N + n;
      B_s[q][n] = n < N ? B[at] : 0.0f;
      C_s[q][n] = n < N ? C[at] : 0.0f;
    }
    if (live) {
      for (int q = 0; q < nq; ++q) {
        x_s[q][p] = x[((row0 + t0 + q) * nh + h) * P + p];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int q = 0; q < nq; ++q) {
      const float a = a_s[q];
      const float ux = dt_s[q] * x_s[q][p];
      float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll
      for (int n = 0; n < MAXN; n += 4) {
        hs[n] = fmaf(a, hs[n], B_s[q][n] * ux);
        hs[n + 1] = fmaf(a, hs[n + 1], B_s[q][n + 1] * ux);
        hs[n + 2] = fmaf(a, hs[n + 2], B_s[q][n + 2] * ux);
        hs[n + 3] = fmaf(a, hs[n + 3], B_s[q][n + 3] * ux);
        y0 = fmaf(C_s[q][n], hs[n], y0);
        y1 = fmaf(C_s[q][n + 1], hs[n + 1], y1);
        y2 = fmaf(C_s[q][n + 2], hs[n + 2], y2);
        y3 = fmaf(C_s[q][n + 3], hs[n + 3], y3);
      }
      y[((row0 + t0 + q) * nh + h) * P + p] = (y0 + y1) + (y2 + y3);
    }
  }
}

template <int MAXN>
void launch(const float* decay, const float* dt, const float* B,
            const float* C, const float* x, float* y, int b, int L, int nh,
            int N, int P, cudaStream_t stream) {
  const int threads = (P + 31) / 32 * 32;
  ssd_kernel<MAXN><<<dim3(nh, b), threads, 0, stream>>>(decay, dt, B, C, x, y,
                                                        L, nh, N, P);
}

}  // namespace

// decay, dt: (b, L, nh); B, C: (b, L, N); x, y: (b, L, nh, P); row-major f32
// on the device.  N and P must lie in [1, 128]; returns the cudaError_t of
// the launch.
extern "C" int mamba2_scan_f32(const float* decay, const float* dt,
                               const float* B, const float* C, const float* x,
                               float* y, int b, int L, int nh, int N, int P,
                               void* stream) {
  if (N < 1 || N > 128 || P < 1 || P > kMaxP || b < 0 || L < 0 || nh < 0 ||
      b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b > 0 && L > 0 && nh > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (N <= 32) {
      launch<32>(decay, dt, B, C, x, y, b, L, nh, N, P, s);
    } else if (N <= 64) {
      launch<64>(decay, dt, B, C, x, y, b, L, nh, N, P, s);
    } else {
      launch<128>(decay, dt, B, C, x, y, b, L, nh, N, P, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
