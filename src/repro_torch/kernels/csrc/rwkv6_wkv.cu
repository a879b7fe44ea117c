// RWKV6 WKV recurrence with a per-key-channel, time-varying decay, f32:
//   y_t = r_t^T S + (r_t . (u o k_t)) v_t,   S <- diag(w_t) S + k_t v_t^T
// per (batch, head), from S = 0.  r, k, v, w, y are (b, L, nh, P) row-major,
// u is (nh, P).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_wkv/rwkv6_wkv.py
// (_wkv_kernel / rwkv6_wkv_pallas), which steps a (Q, P) chunk held in VMEM
// through a fori_loop and carries the (P, P) state in VMEM scratch along a
// sequential grid axis.  Blocks on Hopper run in no order, so here one block
// owns one (batch, head) and walks the whole sequence itself.
//
// Layout: MAXP threads (P rounded up to 32, 64 or 128); thread j keeps column
// j of the state, S[:, j], in MAXP registers.  Per chunk of Q steps the block
// stages the (Q, P) tiles of r, k, v and w in shared memory with coalesced
// loads (one row of P floats per step), then one thread per step computes
// r_t . (u o k_t); then every thread runs the Q steps: y[j] from the OLD
// state (four partial sums to shorten the dependent chain), then the update
// S[i][j] = S[i][j] w[i] + k[i] v[j].  Reads of r, k and w in the step loop
// are shared-memory broadcasts.  Columns j >= P are zero-filled, so the
// padded state stays 0 and adds nothing.
//
// Bound on an H100 SXM at RWKV6-1.6B (nh 32, P 64), b 4, L 2048: bytes, 336
// MB moved (100 us at 3.35 TB/s) against 5.4 GFLOP (80 us at 67 TFLOP/s).
// With one block per (batch, head) the grid is 128 blocks of 64 threads: the
// kernel is a chain of L dependent steps and latency-bound, far from that
// bound.  Splitting the state over more threads, tensor cores and double
// buffering are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kTileFloats = 2048;  // floats of one staged (Q, MAXP) tile

template <int MAXP>
__global__ void __launch_bounds__(MAXP)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y, int L, int nh,
           int P) {
  constexpr int Q = kTileFloats / MAXP;  // steps per staged chunk
  __shared__ float r_s[Q][MAXP];
  __shared__ float k_s[Q][MAXP];
  __shared__ float v_s[Q][MAXP];
  __shared__ float w_s[Q][MAXP];
  __shared__ float ruk_s[Q];
  __shared__ float u_s[MAXP];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const bool live = j < P;
  const size_t step = static_cast<size_t>(nh) * P;  // stride of t
  const size_t base = (static_cast<size_t>(b) * L * nh + h) * P;

  u_s[j] = live ? u[static_cast<size_t>(h) * P + j] : 0.0f;
  float S[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) S[i] = 0.0f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int n = min(Q, L - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int q = 0; q < n; ++q) {
      const size_t at = base + static_cast<size_t>(t0 + q) * step + j;
      r_s[q][j] = live ? r[at] : 0.0f;
      k_s[q][j] = live ? k[at] : 0.0f;
      v_s[q][j] = live ? v[at] : 0.0f;
      w_s[q][j] = live ? w[at] : 0.0f;
    }
    __syncthreads();
    for (int q = j; q < n; q += MAXP) {
      float acc = 0.0f;
      for (int i = 0; i < P; ++i) acc += r_s[q][i] * u_s[i] * k_s[q][i];
      ruk_s[q] = acc;
    }
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      const float vj = v_s[q][j];
      float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXP; i += 4) {
        y0 = fmaf(r_s[q][i], S[i], y0);
        y1 = fmaf(r_s[q][i + 1], S[i + 1], y1);
        y2 = fmaf(r_s[q][i + 2], S[i + 2], y2);
        y3 = fmaf(r_s[q][i + 3], S[i + 3], y3);
      }
      if (live) {
        y[base + static_cast<size_t>(t0 + q) * step + j] =
            ((y0 + y1) + (y2 + y3)) + ruk_s[q] * vj;
      }
#pragma unroll
      for (int i = 0; i < MAXP; ++i) S[i] = fmaf(S[i], w_s[q][i], k_s[q][i] * vj);
    }
  }
}

template <int MAXP>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, float* y, int b, int L, int nh, int P,
            cudaStream_t stream) {
  wkv_kernel<MAXP><<<dim3(nh, b), MAXP, 0, stream>>>(r, k, v, w, u, y, L, nh,
                                                     P);
}

}  // namespace

// r, k, v, w, y: (b, L, nh, P) row-major f32 on the device; u: (nh, P) f32.
// P must lie in [1, 128]; returns the cudaError_t of the launch.
extern "C" int rwkv6_wkv_f32(const float* r, const float* k, const float* v,
                             const float* w, const float* u, float* y, int b,
                             int L, int nh, int P, void* stream) {
  if (P < 1 || P > 128 || b < 0 || L < 0 || nh < 0 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b > 0 && L > 0 && nh > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (P <= 32) {
      launch<32>(r, k, v, w, u, y, b, L, nh, P, s);
    } else if (P <= 64) {
      launch<64>(r, k, v, w, u, y, b, L, nh, P, s);
    } else {
      launch<128>(r, k, v, w, u, y, b, L, nh, P, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
