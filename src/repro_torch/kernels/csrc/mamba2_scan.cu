// Mamba2 SSD scan in its chunked form on the tensor cores, f32 in and out:
//   h_t = a_t h_{t-1} + dt_t B_t (x) x_t   (an (N, P) state per head)
//   y_t = C_t h_t
// per (batch, head), from h = 0.  decay (a) and dt are (b, L, nh); B and C are
// (b, L, N), shared by all heads of a batch row; x and y are (b, L, nh, P);
// all row-major.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba2_scan/mamba2_scan.py
// (_ssd_kernel / mamba2_scan_pallas), which computes the SSD block
// decomposition with MXU matmuls over chunks of Q tokens in a sequential
// grid axis.  This kernel computes the same decomposition, with dt folded
// into the decay weights (the reference's (C B^T o W) U, U = dt x):
//   cum_t  = prod_{r <= t} a_r,   W[t][s] = prod_{r = s+1..t} a_r dt_s (s <= t)
//   y      = cum (C h) + ((C B^T) o W) x
//   h     <- cum_{Q-1} h + (B o W[Q-1, :]^T)^T x
// The decay weights are running products (column s of W is a chain of
// multiplies from 1), never exp of differences of a log cumsum: l_t - l_s
// is a difference of two large sums (5-10x the error at Q = 64) and NaN at
// a decay of exactly 0.  The order is mamba2_scan/ref.py's
// mamba2_scan_chunked_ref in f32; tests/test_torch_scan_order.py emulates
// the arithmetic below on the CPU.
//
// Bound on an H100 SXM at Zamba2-2.7B (nh 80, N 64, P 64), b 4, L 2048:
// bytes, 345 MB moved (103 us at 3.35 TB/s), against the chunked form's
// 12.1 GFLOP of matrix work at Q = 32 (74 us at 165 TFLOP/s in 3xTF32) and
// 0.36 GFLOP of FP32 beside it (5 us); the sequential form's 13.4 GFLOP
// would take 200 us at 67 TFLOP/s.  What holds the kernel above that is
// latency: one block alone on an SM takes 0.26-0.29 ms, and the SMs that
// hold three of Zamba2's 320 blocks set the time (PERF.md).
//
// Design:
// - One block of 4 warps per (batch, head) walks the chunks of Q = 32
//   tokens in order, the state h (NP x PP floats) in shared memory.  Warp
//   (rt, ph) = (w / 2, w % 2) owns tokens 16 rt .. 16 rt + 15 and half ph
//   of the P columns for y and C h, and state rows 32 rt .. 32 rt + 31 (at
//   N = 64) of the same columns for the update.  75 KB of shared memory at
//   N = P = 64 and 168 registers: three blocks an SM, so Zamba2's 320
//   blocks are all resident at once.
// - Staging: a chunk's a, dt (4-byte copies, stride nh), B, C and x
//   (16-byte copies where N, P are multiples of 4 and the pointers aligned,
//   else 4-byte ones) go by cp.async into one of two stages while the other
//   stage's chunk computes.  Copies past L, N or P are zero-filled, so the
//   padded rows and columns add nothing, and a short last chunk needs no
//   other care (its rows past L are never stored).
// - Per chunk: warps 2 and 3 run the chains (W's 32 columns, and cum) while
//   all warps form C B^T and C h from shared A fragments of C (mma.sync
//   .m16n8k8 TF32 in 3xTF32, tf32x3.cuh); the 6 tiles of C B^T on and below
//   the diagonal are shared so that every warp takes 264 mma a chunk.  A
//   barrier; M = (C B^T) o W into W's place; a barrier; then M x, and the
//   update (B o W[Q-1, :])^T x and h = cum_{Q-1} h + that, each state
//   element owned by one lane (C h has read h before the barriers).
// - The tensor core truncates the sums it forms (tf32x3.cuh): every product
//   is summed in runs of k8 steps from zero (two steps over the state, four
//   over a chunk's tokens), each run added to its f32 accumulator with a
//   rounded add.  Operands are split by split_tf32_fast (lo unrounded).
// - Row strides: 4 mod 32 floats for B, C and W (fragments read by rows
//   8 apart), 8 mod 32 for x and h (read by rows 4 apart), so that a
//   fragment load falls in 32 banks, but for the update's A fragments of B
//   (2-way).  cum and W[Q-1, :] sit in W's pad columns.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kQ = 32;          // tokens of a chunk
constexpr int kThreads = 128;   // 4 warps
// floats of a row of W: its 32 columns, then cum[t] at column 32 and
// W[kQ - 1][s] at column 33 of row s
constexpr int kWRow = kQ + 4;
constexpr unsigned kSmemCap = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy (L2 only); src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte global -> shared copy; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared-memory layout at padded state sizes NP, PP (64 or 128)
template <int NP, int PP>
struct Layout {
  static constexpr int kBRow = NP + 4;  // floats of a row of B, C
  static constexpr int kXRow = PP + 8;  // floats of a row of x and h
  // one stage: a[kQ], dt[kQ], B[kQ][kBRow], C[kQ][kBRow], x[kQ][kXRow]
  static constexpr int kStage = 2 * kQ + 2 * kQ * kBRow + kQ * kXRow;
  // two stages, W[kQ][kWRow] (with cum and W[kQ - 1]), h[NP][kXRow]
  static constexpr int kFloats = 2 * kStage + kQ * kWRow + NP * kXRow;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// the chunk of tokens [t0, t0 + kQ) into stage st, zeros past L, N and P
template <int NP, int PP>
__device__ __forceinline__ void load_stage(
    float* st, const float* decay, const float* dt, const float* B,
    const float* C, const float* x, size_t row0, int t0, int L, int nh,
    int h, int N, int P, bool vec_bc, bool vec_x, int tid) {
  using Lay = Layout<NP, PP>;
  float* B_s = st + 2 * kQ;
  float* C_s = B_s + kQ * Lay::kBRow;
  float* x_s = C_s + kQ * Lay::kBRow;
  if (tid < 2 * kQ) {  // a and dt: one float a token, nh apart
    const int q = tid % kQ;
    const bool in = t0 + q < L;
    const float* src = tid < kQ ? decay : dt;
    cp_async4(smem_u32(st + tid), in ? src + (row0 + t0 + q) * nh + h : src,
              in ? 4 : 0);
  }
  if (vec_bc) {
    constexpr int kChunks = NP / 4;
    for (int e = tid; e < kQ * kChunks; e += kThreads) {
      const int q = e / kChunks;
      const int c = e % kChunks;
      const bool in = t0 + q < L && 4 * c < N;
      const size_t at = in ? (row0 + t0 + q) * N + 4 * c : 0;
      cp_async16(smem_u32(B_s + q * Lay::kBRow + 4 * c), B + at,
                 in ? 16 : 0);
      cp_async16(smem_u32(C_s + q * Lay::kBRow + 4 * c), C + at,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kQ * NP; e += kThreads) {
      const int q = e / NP;
      const int n = e % NP;
      const bool in = t0 + q < L && n < N;
      const size_t at = in ? (row0 + t0 + q) * N + n : 0;
      cp_async4(smem_u32(B_s + q * Lay::kBRow + n), B + at, in ? 4 : 0);
      cp_async4(smem_u32(C_s + q * Lay::kBRow + n), C + at, in ? 4 : 0);
    }
  }
  if (vec_x) {
    constexpr int kChunks = PP / 4;
    for (int e = tid; e < kQ * kChunks; e += kThreads) {
      const int q = e / kChunks;
      const int c = e % kChunks;
      const bool in = t0 + q < L && 4 * c < P;
      const size_t at = in ? ((row0 + t0 + q) * nh + h) * P + 4 * c : 0;
      cp_async16(smem_u32(x_s + q * Lay::kXRow + 4 * c), x + at,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kQ * PP; e += kThreads) {
      const int q = e / PP;
      const int p = e % PP;
      const bool in = t0 + q < L && p < P;
      const size_t at = in ? ((row0 + t0 + q) * nh + h) * P + p : 0;
      cp_async4(smem_u32(x_s + q * Lay::kXRow + p), x + at, in ? 4 : 0);
    }
  }
}

// blocks an SM should hold (launch bounds): three at N, P <= 64
__host__ __device__ constexpr int min_blocks(int np, int pp) {
  return np <= 64 && pp <= 64 ? 3 : 1;
}

// k8 steps of a product summed from zero (3 mma a step) before the sum is
// added to its f32 accumulator: kRunN for the products over the state
// (C B^T, C h: 8 steps at N = 64), kRunT for those over a chunk's tokens
// ((C B^T o W) x and the update: 4 steps).  The CPU emulation of the
// truncation puts the main path's error at 3.1e-7 of max|y| for runs of
// 1 or 2 over the state and 5.5e-7 for runs of 4, and finds no change from
// the run over the tokens
constexpr int kRunN = 2;
constexpr int kRunT = 4;

template <int NP, int PP>
__global__ void __launch_bounds__(kThreads, min_blocks(NP, PP))
ssd_kernel(const float* __restrict__ decay, const float* __restrict__ dt,
           const float* __restrict__ B, const float* __restrict__ C,
           const float* __restrict__ x, float* __restrict__ y, int L, int nh,
           int N, int P, int vec_bc, int vec_x) {
  using Lay = Layout<NP, PP>;
  const bool even_p = P % 2 == 0;  // y's rows are 8-byte aligned
  constexpr int kBRow = Lay::kBRow;
  constexpr int kXRow = Lay::kXRow;
  constexpr int kNK = NP / 8;    // k8 steps over the state rows
  constexpr int kPT = PP / 16;   // n8 tiles of half of the P columns
  constexpr int kSK = kQ / 8;    // k8 steps over a chunk's tokens
  constexpr int kMT = NP / 32;   // m16 state tiles of a warp's update
  constexpr int kMG = 2;         // ... taken two at a time
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* W_s = smem + 2 * Lay::kStage;  // [kQ][kWRow]: W, then M = S o W
  float* cum_s = W_s + kQ;              // cum[t] at cum_s[t * kWRow]
  float* wl_s = W_s + kQ + 1;           // W[kQ - 1][s] at wl_s[s * kWRow]
  float* h_s = W_s + kQ * kWRow;        // [NP][kXRow]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row (A, C) or column (B)
  const int t4 = lane % 4;  // fragment k-index (A, B) or column pair (C)
  const int rt = warp >> 1;       // tokens 16 rt .. 16 rt + 15 of a chunk
  const int ph = warp & 1;        // P columns 8 kPT ph .. 8 kPT ph + 8 kPT - 1
  const int nj = 2 * rt + 2;      // n8 tiles of keys s <= 16 rt + 15
  // this warp's tiles of S = C B^T: keys 8 kt .. 8 kt + 7 of row tiles rt
  // .. rt + ngt - 1
  const int ngt = 2 - rt;
  const int kt = rt == 0 ? ph : 2 + ph;
  const size_t row0 = static_cast<size_t>(b) * L;  // (b, 0) in (b, L, .)

  for (int e = tid; e < NP * kXRow; e += kThreads) h_s[e] = 0.0f;

  const int nchunks = (L + kQ - 1) / kQ;
  load_stage<NP, PP>(smem, decay, dt, B, C, x, row0, 0, L, nh, h, N, P,
                     vec_bc, vec_x, tid);
  cp_async_commit();

  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * kQ;
    const int nq = min(kQ, L - t0);
    float* st = smem + (ci & 1) * Lay::kStage;
    const float* a_s = st;
    const float* dt_s = st + kQ;
    const float* B_s = st + 2 * kQ;
    const float* C_s = B_s + kQ * kBRow;
    const float* X_s = st + 2 * kQ + 2 * kQ * kBRow;
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; the last one is done with the
                      // other stage, W, cum and h
    if (ci + 1 < nchunks) {
      load_stage<NP, PP>(smem + ((ci + 1) & 1) * Lay::kStage, decay, dt, B,
                         C, x, row0, t0 + kQ, L, nh, h, N, P, vec_bc, vec_x,
                         tid);
      cp_async_commit();
    }

    // the decay weights as running products, while the other warps start
    // on S and C h: column s of W by lane s of warp 0 (W[s][s] = 1, W[t][s]
    // = W[t-1][s] a_t), cum by one lane of warp 1
    // (a is read into registers first: the compiler cannot move a shared
    // load past a shared store that might alias it)
    if (warp == 2 || tid == 96) {
      float av[kQ];
#pragma unroll
      for (int t = 0; t < kQ; ++t) av[t] = a_s[t];
      if (warp == 2) {
        // dt_s of the key is folded in: W'[t][s] = W[t][s] dt_s, so that
        // the products take x where the reference takes U = dt x
        const int s = lane;
        const float dts = dt_s[s];
        float wv = 1.0f;
#pragma unroll
        for (int t = 0; t < kQ; ++t) {
          if (t > s) wv *= av[t];
          W_s[t * kWRow + s] = t >= s ? wv * dts : 0.0f;
        }
        wl_s[s * kWRow] = wv * dts;
      } else {
        float cv = 1.0f;
#pragma unroll
        for (int t = 0; t < kQ; ++t) {
          cv *= av[t];
          cum_s[t * kWRow] = cv;
        }
      }
    }

    // S = C B^T on this warp's tiles and C h on its columns, from the same
    // A fragments of C: a0 = C[16 rt + g][8 kk + t4], a1 = row + 8, a2 =
    // column + 4, a3 = both.  The 6 tiles of S on and below the diagonal
    // are shared so that every warp takes 264 mma a chunk: warp (0, ph)
    // takes keys 8 ph .. 8 ph + 7 of both row tiles (the second from A
    // fragments of C's rows 16 .. 31, a1f), warp (1, ph) keys 16 + 8 ph ..
    float sc[2][4];
    float yh[kPT][4];
    float ds[2][4], dh[kPT][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) yh[i][e] = 0.0f;
    }
    const float* cr = C_s + (16 * rt + g) * kBRow + t4;
    const float* cr1 = C_s + (16 + g) * kBRow + t4;
    const float* br = B_s + (8 * kt + g) * kBRow + t4;
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk) {
      const bool first = kk % kRunN == 0;
      const bool last = kk % kRunN == kRunN - 1 || kk == kNK - 1;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_tf32_fast(cr[8 * (e & 1) * kBRow + 8 * kk + 4 * (e >> 1)],
                        ah[0][e], al[0][e]);
      }
      if (rt == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32_fast(cr1[8 * (e & 1) * kBRow + 8 * kk + 4 * (e >> 1)],
                          ah[1][e], al[1][e]);
        }
      }
      // S: b0 = B[s = 8 kt + g][n = 8 kk + t4], b1 = B[8 kt + g][8 kk + t4 +
      // 4]; tile j takes row tile rt + j
      uint32_t bh[2], bl[2];
      split_tf32_fast(br[8 * kk], bh[0], bl[0]);
      split_tf32_fast(br[8 * kk + 4], bh[1], bl[1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < ngt) {
          if (first) {
            mma_tf32_zero(ds[j], al[j], bh[0], bh[1]);
          } else {
            mma_tf32(ds[j], al[j], bh[0], bh[1]);
          }
        }
      }
      // C h: b0 = h[n = 8 kk + t4][p = 8 np + g], b1 = h[8 kk + t4 + 4][p]
      uint32_t hh[kPT][2], hl[kPT][2];
#pragma unroll
      for (int i = 0; i < kPT; ++i) {
        const float* hr = h_s + (8 * kk + t4) * kXRow + 8 * (ph * kPT + i) + g;
        split_tf32_fast(hr[0], hh[i][0], hl[i][0]);
        split_tf32_fast(hr[4 * kXRow], hh[i][1], hl[i][1]);
        if (first) {
          mma_tf32_zero(dh[i], al[0], hh[i][0], hh[i][1]);
        } else {
          mma_tf32(dh[i], al[0], hh[i][0], hh[i][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < ngt) mma_tf32(ds[j], ah[j], bl[0], bl[1]);
      }
#pragma unroll
      for (int i = 0; i < kPT; ++i) mma_tf32(dh[i], ah[0], hl[i][0], hl[i][1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < ngt) {
          mma_tf32(ds[j], ah[j], bh[0], bh[1]);
          if (last) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] += ds[j][e];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kPT; ++i) {
        mma_tf32(dh[i], ah[0], hh[i][0], hh[i][1]);
        if (last) {
#pragma unroll
          for (int e = 0; e < 4; ++e) yh[i][e] += dh[i][e];
        }
      }
    }

    __syncthreads();  // W and cum are ready; every warp has read h

    // M = S o W, into W's place at this lane's positions of tile j: tokens
    // 16 (rt + j) + g (+ 8), keys 8 kt + 2 t4 (+ 1); W is 0 above the
    // diagonal
    float2 wv2[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < ngt) {
        const float* wr = W_s + (16 * (rt + j) + g) * kWRow + 8 * kt + 2 * t4;
        wv2[j][0] = *reinterpret_cast<const float2*>(wr);
        wv2[j][1] = *reinterpret_cast<const float2*>(wr + 8 * kWRow);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < ngt) {
        float* wr = W_s + (16 * (rt + j) + g) * kWRow + 8 * kt + 2 * t4;
        *reinterpret_cast<float2*>(wr) =
            make_float2(wv2[j][0].x * sc[j][0], wv2[j][0].y * sc[j][1]);
        *reinterpret_cast<float2*>(wr + 8 * kWRow) =
            make_float2(wv2[j][1].x * sc[j][2], wv2[j][1].y * sc[j][3]);
      }
    }
    __syncthreads();  // M is complete

    // M x over keys s < 8 nj: a0 = M[16 rt + g][8 j + t4], a1 = row + 8, a2 =
    // column + 4, a3 = both; b0 = x[8 j + t4][8 np + g], b1 = x[8 j + t4 +
    // 4][8 np + g]
    float yu[kPT][4];
    float du[kPT][4];
#pragma unroll
    for (int i = 0; i < kPT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) yu[i][e] = 0.0f;
    }
    const float* mr = W_s + (16 * rt + g) * kWRow + t4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nj) {
        const bool first = j % kRunT == 0;
        const bool last = j % kRunT == kRunT - 1 || j == nj - 1;
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32_fast(mr[8 * (e & 1) * kWRow + 8 * j + 4 * (e >> 1)], mh[e],
                     ml[e]);
        }
        uint32_t uh[kPT][2], ul[kPT][2];
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const float* ur = X_s + (8 * j + t4) * kXRow + 8 * (ph * kPT + i) + g;
          split_tf32_fast(ur[0], uh[i][0], ul[i][0]);
          split_tf32_fast(ur[4 * kXRow], uh[i][1], ul[i][1]);
          if (first) {
            mma_tf32_zero(du[i], ml, uh[i][0], uh[i][1]);
          } else {
            mma_tf32(du[i], ml, uh[i][0], uh[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < kPT; ++i) mma_tf32(du[i], mh, ul[i][0], ul[i][1]);
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          mma_tf32(du[i], mh, uh[i][0], uh[i][1]);
          if (last) {
#pragma unroll
            for (int e = 0; e < 4; ++e) yu[i][e] += du[i][e];
          }
        }
      }
    }

    // y = cum (C h) + M x at tokens 16 rt + g (+ 8), columns 8 np + 2 t4 (+ 1):
    // a float2 a lane (a row's 8 columns of an n8 tile in one 32-byte
    // sector) where P is even
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 16 * rt + g + 8 * r;
      if (t < nq) {
        const float cv = cum_s[t * kWRow];
        float* yr = y + ((row0 + t0 + t) * nh + h) * P;
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const int p = 8 * (ph * kPT + i) + 2 * t4;
          const float y0 = fmaf(cv, yh[i][2 * r], yu[i][2 * r]);
          const float y1 = fmaf(cv, yh[i][2 * r + 1], yu[i][2 * r + 1]);
          if (even_p && p < P) {
            *reinterpret_cast<float2*>(yr + p) = make_float2(y0, y1);
          } else {
            if (p < P) yr[p] = y0;
            if (p + 1 < P) yr[p + 1] = y1;
          }
        }
      }
    }

    // h = cum_{Q-1} h + (B o W[Q-1, :])^T x (C h has read h before the
    // barrier above): this warp's kMT m16 tiles of state rows, kMG at a
    // time, and half of the columns.  a0 = B[s = 8 kk + t4][n = 16 mt + g]
    // W[Q-1][s], a1 = n + 8, a2 = s + 4, a3 = both; b0 = x[8 kk + t4][8 np +
    // g], b1 = x[8 kk + t4 + 4][8 np + g]
    const float cl = cum_s[(kQ - 1) * kWRow];
#pragma unroll
    for (int m0 = 0; m0 < kMT; m0 += kMG) {
      float acc[kMG][kPT][4];
      float da[kMG][kPT][4];
#pragma unroll
      for (int m = 0; m < kMG; ++m) {
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kSK; ++kk) {
        const bool first = kk % kRunT == 0;
        const bool last = kk % kRunT == kRunT - 1 || kk == kSK - 1;
        const int s0 = 8 * kk + t4;
        const float w0 = wl_s[s0 * kWRow];
        const float w1 = wl_s[(s0 + 4) * kWRow];
        uint32_t ah[kMG][4], al[kMG][4];
#pragma unroll
        for (int m = 0; m < kMG; ++m) {
          const int mt = (warp >> 1) * kMT + m0 + m;
          const float* bt = B_s + s0 * kBRow + 16 * mt + g;
          split_tf32_fast(bt[0] * w0, ah[m][0], al[m][0]);
          split_tf32_fast(bt[8] * w0, ah[m][1], al[m][1]);
          split_tf32_fast(bt[4 * kBRow] * w1, ah[m][2], al[m][2]);
          split_tf32_fast(bt[4 * kBRow + 8] * w1, ah[m][3], al[m][3]);
        }
        uint32_t uh[kPT][2], ul[kPT][2];
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const float* ur = X_s + s0 * kXRow + 8 * (ph * kPT + i) + g;
          split_tf32_fast(ur[0], uh[i][0], ul[i][0]);
          split_tf32_fast(ur[4 * kXRow], uh[i][1], ul[i][1]);
#pragma unroll
          for (int m = 0; m < kMG; ++m) {
            if (first) {
              mma_tf32_zero(da[m][i], al[m], uh[i][0], uh[i][1]);
            } else {
              mma_tf32(da[m][i], al[m], uh[i][0], uh[i][1]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
#pragma unroll
          for (int m = 0; m < kMG; ++m) {
            mma_tf32(da[m][i], ah[m], ul[i][0], ul[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
#pragma unroll
          for (int m = 0; m < kMG; ++m) {
            mma_tf32(da[m][i], ah[m], uh[i][0], uh[i][1]);
            if (last) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][i][e] += da[m][i][e];
            }
          }
        }
      }
      // h = cum_{Q-1} h + acc: all loads of h first, then the stores
      float2 hv[kMG][kPT][2];
#pragma unroll
      for (int m = 0; m < kMG; ++m) {
        const int mt = (warp >> 1) * kMT + m0 + m;
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const int p = 8 * (ph * kPT + i) + 2 * t4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            hv[m][i][r] = *reinterpret_cast<const float2*>(
                h_s + (16 * mt + g + 8 * r) * kXRow + p);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMG; ++m) {
        const int mt = (warp >> 1) * kMT + m0 + m;
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const int p = 8 * (ph * kPT + i) + 2 * t4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2 v = hv[m][i][r];
            v.x = fmaf(cl, v.x, acc[m][i][2 * r]);
            v.y = fmaf(cl, v.y, acc[m][i][2 * r + 1]);
            *reinterpret_cast<float2*>(h_s + (16 * mt + g + 8 * r) * kXRow +
                                       p) = v;
          }
        }
      }
    }
  }
}

template <int NP, int PP>
int launch(const float* decay, const float* dt, const float* B,
           const float* C, const float* x, float* y, int b, int L, int nh,
           int N, int P, cudaStream_t stream) {
  using Lay = Layout<NP, PP>;
  static_assert(Lay::kBytes <= kSmemCap, "shared memory");
  auto kernel = ssd_kernel<NP, PP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Lay::kBytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_bc = N % 4 == 0 && aligned(B) && aligned(C);
  const int vec_x = P % 4 == 0 && aligned(x);
  kernel<<<dim3(nh, b), kThreads, Lay::kBytes, stream>>>(
      decay, dt, B, C, x, y, L, nh, N, P, vec_bc, vec_x);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch_p(const float* decay, const float* dt, const float* B,
             const float* C, const float* x, float* y, int b, int L, int nh,
             int N, int P, cudaStream_t stream) {
  if (P <= 64) return launch<NP, 64>(decay, dt, B, C, x, y, b, L, nh, N, P,
                                     stream);
  return launch<NP, 128>(decay, dt, B, C, x, y, b, L, nh, N, P, stream);
}

}  // namespace

// decay, dt: (b, L, nh); B, C: (b, L, N); x, y: (b, L, nh, P); row-major f32
// on the device.  N and P must lie in [1, 128]; returns the cudaError_t of
// the launch.
extern "C" int mamba2_scan_f32(const float* decay, const float* dt,
                               const float* B, const float* C, const float* x,
                               float* y, int b, int L, int nh, int N, int P,
                               void* stream) {
  if (N < 1 || N > 128 || P < 1 || P > 128 || b < 0 || L < 0 || nh < 0 ||
      b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || L == 0 || nh == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // N and P are padded to 64 or 128 (zeros past them add nothing)
  if (N <= 64) return launch_p<64>(decay, dt, B, C, x, y, b, L, nh, N, P, s);
  return launch_p<128>(decay, dt, B, C, x, y, b, L, nh, N, P, s);
}
