// Causal GQA attention on the tensor cores in 3xTF32, forward only, float32
// in and out, with an optional sliding window:
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j]
// over the keys j visible to query i (i - window < j <= i), g = h / (H / KV).
// q, o are (B, H, S, D) and k, v (B, KV, S, D), row-major float32, any D
// from 1 to 128, any element-aligned pointers.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (_flash_kernel / flash_attention_pallas) for float32
// inputs.  The wrapper (flash_attention/ops.py, _route) sends every float32
// call here and every bfloat16 call to flash_attention_mma.cu.
//
// Bound on an H100 SXM at Zamba2-2.7B's shared attention (B 4, H = KV = 32,
// S 2048, D 80): 4 D operations per visible (query, key) pair, 8.6e10 in
// all, are 0.52 ms at 495 / 3 TFLOP/s (the TF32 tensor-core rate over the
// three products of 3xTF32), against 336 MB of f32 q, k, v and o (0.100
// ms): the operations bound it.
//
// Design (the shape of flash_attention_mma.cu, in 3xTF32, tf32x3.cuh):
// - One block of 4 warps per (query tile of 64 rows, head, batch); warp w
//   owns rows 16 w .. 16 w + 15.  Tiles are issued longest first, and a
//   block visits only the KV tiles that hold a key some row of it can see
//   (from q0 - window + 1, or 0, up to its last row), so the window case is
//   sub-quadratic.  The mask is applied only on tiles that cross the causal
//   diagonal or the window's edge.
// - Q goes once into shared memory (64 rows, f32) and its A fragments are
//   read and split into TF32 hi and lo at each use: in registers they
//   spilled at D = 80 and above.  K and V tiles of BK keys (64 up to DP =
//   32, else 32) go through a 2-stage cp.async ring, with Q in the first
//   group; copies are zero-filled for rows >= S and for the columns from D
//   up to DP (D rounded up to 16).  The copies of Q, K and V are W bytes
//   wide, a template parameter: 16 where q, k, v and a row of D floats are
//   16-byte aligned and o takes float2 stores (every model width on fresh
//   tensors; no run-time branch on alignment there: a run-time choice of
//   Q's width inside it moved the compiler's register allocation, to
//   spills at DP = 32 and 80), else 4 (any D and offset: a float is always
//   4-byte aligned, so the ring stays asynchronous).  A 4-byte tile is one
//   run of BK D floats in memory, walked flat with a run-time trip count
//   (unrolled, the pieces a thread kept their addresses in registers
//   across the tiles and spilled); its padding columns are zeroed once.
//   Rows of shared memory are DP + 4 floats: = 4 mod 16, so the 8 rows of
//   an A or B fragment and the 4 V row pairs of a P V fragment fall in
//   distinct banks.
// - S = Q K^T in 3xTF32, so the scores keep f32 accuracy; the three
//   products go in three passes over the independent n8 tiles (tf32x3.cuh).
//   scale multiplies the f32 scores, as in the JAX kernel, with log2(e)
//   folded in, so that p = exp2(s - m) is one ex2 per score.  The row max
//   and sum run over the quad of lanes that holds a row.  Masked keys get
//   p = 0 exactly, never exp(-1e30 - m), and m stays -inf until a row's
//   first visible key (alpha = 1 then).
// - P V in 3xTF32 with P kept in f32 and split into hi and lo.  The S
//   accumulators of an n8 tile hold keys (2t, 2t + 1) of a row, while an A
//   fragment wants k-indices (t, t + 4); the order of the keys in the
//   contraction is free, so k-index t stands for key 2t and t + 4 for key
//   2t + 1, and the B fragment reads the V rows in the same order: b0 =
//   V[key 2t][col g], b1 = V[key 2t + 1][col g].  P never leaves registers.
// - The tensor core truncates the sums it forms (tf32x3.cuh).  O sums the
//   keys of one tile after another, 256 tiles in Qwen3-14B's window of
//   8192, and its terms p v all have one sign where V does: fed straight
//   into O's accumulator, the truncations drift one way by ~2e-4 there
//   (measured at |o| ~ 2).  So each tile's P V is summed from zero, 3
//   kKeys8 (12 or 24) mma, and added to O with a rounded FMA that also
//   applies the online-softmax rescale alpha: O's error stays relative to
//   each tile's share.  S spans at most 16 k8 steps (D <= 128) and is
//   formed in its accumulator.
// - Epilogue: O / l (l == 0 -> 1, as in the JAX kernel), stored as float2
//   with ragged rows guarded, or (4-byte kernels) one float at a time where
//   D is odd or o is not 8-byte aligned.
// - Occupancy: the launch bounds ask for 4 blocks an SM up to DP = 32 (at
//   most 128 registers a thread), 3 up to DP = 80 (170) and 2 above, where
//   the O accumulator alone takes 48-64 registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy (L2 only); src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte global -> shared copy (.cg takes 16 bytes only); src_bytes 0 writes
// 4 zero bytes
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

constexpr int kBQ = 64;                 // query rows of a block
constexpr int kThreads = 128;           // 4 warps of 16 query rows
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// keys of a K/V tile at a padded head size DP
__host__ __device__ constexpr int block_keys(int dp) {
  return dp <= 32 ? 64 : 32;
}
// blocks an SM should hold at DP (launch bounds)
__host__ __device__ constexpr int min_blocks(int dp) {
  return dp <= 32 ? 4 : dp <= 80 ? 3 : 2;
}

// rows [r0, r0 + ROWS) of src (S rows of D) into dst (ROWS rows of DP + 4
// floats, the first DP of them read): 16-byte chunks, zeros for rows >= S
// and for the chunks from D to DP (D % 4 == 0, src 16-byte aligned)
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int S, int D, int tid) {
  constexpr int kRow = DP + 4;
  constexpr int kChunks = DP / 4;
  constexpr int kPer = ROWS * kChunks / kThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kChunks;
    const int c = e % kChunks;
    const bool in = r0 + r < S && 4 * c < D;
    const float* from = in ? src + static_cast<size_t>(r0 + r) * D + 4 * c
                           : src;
    cp_async16(smem_u32(dst + r * kRow + 4 * c), from, in ? 16 : 0);
  }
}

// the same rows in 4-byte cp.async pieces (any D and float offset); only
// the first D columns are written (zero_pad clears the rest once), zeros
// for rows >= S.  The ROWS rows are one run of ROWS D floats at src + r0 D,
// walked flat: float f lies in row f / D, the quotient from a float
// reciprocal of D (exact: f < 2^13 and D <= 128 keep the rounding below
// 0.5 / D), and the trip count is left to run time, so that no piece's
// address is held across the tiles
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_narrow(float* dst, const float* src,
                                                 int r0, int S, int D,
                                                 float rcp_d, int tid) {
  constexpr int kRow = DP + 4;
  const int end = ROWS * D;                  // floats of the tile
  const int valid = min(S - r0, ROWS) * D;   // those of rows < S
  const float* base = src + static_cast<size_t>(r0) * D;
#pragma unroll 4
  for (int f = tid; f < end; f += kThreads) {
    const int r = static_cast<int>((f + 0.5f) * rcp_d);
    const bool in = f < valid;
    cp_async4(smem_u32(dst + r * kRow + (f - r * D)), in ? base + f : base,
              in ? 4 : 0);
  }
}

// columns [D, DP) of `rows` rows of DP + 4 floats set to zero, in the
// tiles that narrow copies fill
template <int DP>
__device__ __forceinline__ void zero_pad(float* dst, int rows, int D,
                                         int tid) {
  constexpr int kRow = DP + 4;
  for (int r = tid; r < rows; r += kThreads) {
    for (int c = D; c < DP; ++c) dst[r * kRow + c] = 0.0f;
  }
}

// a K or V tile of ROWS rows in pieces of W bytes
template <int DP, int ROWS, int W>
__device__ __forceinline__ void load_kv(float* dst, const float* src, int r0,
                                        int S, int D, float rcp_d, int tid) {
  static_assert(W == 16 || W == 4, "pieces of 16 or 4 bytes");
  if constexpr (W == 16) {
    load_tile<DP, ROWS>(dst, src, r0, S, D, tid);
  } else {
    load_tile_narrow<DP, ROWS>(dst, src, r0, S, D, rcp_d, tid);
  }
}

// W: the width in bytes of the Q, K and V copies (16 only where all three
// and o allow it)
template <int DP, int W>
__global__ void __launch_bounds__(kThreads, min_blocks(DP))
flash_attn_tf32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int H, int KV, int S, int D, float scale,
                       int window) {
  constexpr int kBK = block_keys(DP);
  constexpr int kSteps = DP / 8;   // k8 steps of Q K^T, n8 tiles of P V
  constexpr int kKeys8 = kBK / 8;  // n8 tiles of S, k8 steps of P V
  constexpr int kRow = DP + 4;     // floats of a shared-memory row
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);  // [kBQ][kRow]
  float* k_s = q_s + kBQ * kRow;                    // [2][kBK][kRow]
  float* v_s = k_s + 2 * kBK * kRow;                // [2][kBK][kRow]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // fragment row (A, C) or column (B)
  const int t = lane % 4;   // fragment k-index (A, B) or column pair (C)
  const int q0 = tile * kBQ;
  const float* qg = q + (static_cast<size_t>(b) * H + h) * S * D;
  const float* kg = k + (static_cast<size_t>(b) * KV + g) * S * D;
  const float* vg = v + (static_cast<size_t>(b) * KV + g) * S * D;
  float* og = o + (static_cast<size_t>(b) * H + h) * S * D;

  const int hi = min(S, q0 + kBQ);  // keys >= hi are above every row
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int ntiles = (hi - lo + kBK - 1) / kBK;  // >= 1: lo <= q0 < hi

  const float rcp_d = 1.0f / D;  // for the narrow copies
  if constexpr (W == 16) {
    load_tile<DP, kBQ>(q_s, qg, q0, S, D, tid);
  } else {
    zero_pad<DP>(q_s, kBQ + 4 * kBK, D, tid);  // the Q, K and V tiles
    load_tile_narrow<DP, kBQ>(q_s, qg, q0, S, D, rcp_d, tid);
  }
  load_kv<DP, kBK, W>(k_s, kg, lo, S, D, rcp_d, tid);
  load_kv<DP, kBK, W>(v_s, vg, lo, S, D, rcp_d, tid);
  cp_async_commit();

  // the rows of this lane: c0, c1 of an m16n8 tile hold row r, c2, c3 row
  // r + 8, at columns 2 t and 2 t + 1
  const int row0 = q0 + 16 * warp + gq;
  // Q A fragments in shared memory: a0 = (row0, 8 kk + t), a1 = (row0 + 8,
  // 8 kk + t), a2 = (row0, 8 kk + t + 4), a3 = (row0 + 8, 8 kk + t + 4)
  const float* qr = q_s + (16 * warp + gq) * kRow + t;

  float acc[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  const float scale2 = scale * kLog2e;  // scores in units of log2
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows r, r + 8
  float l[2] = {0.0f, 0.0f};            // this lane's share of the sums

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = lo + it * kBK;
    const int st = it & 1;
    if (it + 1 < ntiles) {  // the next tile into the other stage
      load_kv<DP, kBK, W>(k_s + (st ^ 1) * kBK * kRow, kg, k0 + kBK, S, D,
                          rcp_d, tid);
      load_kv<DP, kBK, W>(v_s + (st ^ 1) * kBK * kRow, vg, k0 + kBK, S, D,
                          rcp_d, tid);
    }
    cp_async_commit();  // possibly empty: one group per iteration
    cp_async_wait1();  // this tile's group has landed
    __syncthreads();   // (and the zeroed padding is seen)
    const float* ks = k_s + st * kBK * kRow;
    const float* vs = v_s + st * kBK * kRow;

    // S = Q K^T: kKeys8 n8 tiles of keys; b0 = K[key gq][8 kk + t], b1 =
    // K[key gq][8 kk + t + 4]
    float s[kKeys8][4];
#pragma unroll
    for (int j = 0; j < kKeys8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_tf32(qr[8 * (e & 1) * kRow + 8 * kk + 4 * (e >> 1)], ah[e],
                   al[e]);
      }
      const float* kr = ks + gq * kRow + 8 * kk + t;
      uint32_t bh[kKeys8][2], bl[kKeys8][2];
#pragma unroll
      for (int j = 0; j < kKeys8; ++j) {
        split_tf32(kr[8 * j * kRow], bh[j][0], bl[j][0]);
        split_tf32(kr[8 * j * kRow + 4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kKeys8; ++j) mma_tf32(s[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < kKeys8; ++j) mma_tf32(s[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < kKeys8; ++j) mma_tf32(s[j], ah, bh[j][0], bh[j][1]);
    }

    // scale, mask, online softmax
    const bool edge = k0 + kBK - 1 > q0 ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key > row || (window > 0 && key <= row - window)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m_new == -INFINITY ? 1.0f : exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kKeys8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == -INFINITY ? 0.0f : exp2f(x - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
    // P's A fragments, split once: k-index t is key 2t of an n8 tile of S
    // and k-index t + 4 is key 2t + 1, so a = (c0, c2, c1, c3) of that tile
    uint32_t ph[kKeys8][4], pl[kKeys8][4];
#pragma unroll
    for (int j = 0; j < kKeys8; ++j) {
      split_tf32(s[j][0], ph[j][0], pl[j][0]);
      split_tf32(s[j][2], ph[j][1], pl[j][1]);
      split_tf32(s[j][1], ph[j][2], pl[j][2]);
      split_tf32(s[j][3], ph[j][3], pl[j][3]);
    }

    // O = alpha O + P V: this tile's P V for two n8 tiles of O's columns
    // at a time, summed over the tile's keys from zero (3 kKeys8 mma), then
    // added to O with one rounded FMA per element
#pragma unroll
    for (int dp0 = 0; dp0 < kSteps; dp0 += 2) {
      float d[2][4];
#pragma unroll
      for (int j = 0; j < kKeys8; ++j) {
        // b0 = V[key 8 j + 2 t][col g], b1 = V[key 8 j + 2 t + 1][col g]
        const float* vr = vs + (8 * j + 2 * t) * kRow + gq + 8 * dp0;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          split_tf32(vr[8 * u], bh[u][0], bl[u][0]);
          split_tf32(vr[kRow + 8 * u], bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (j == 0) {
            mma_tf32_zero(d[u], pl[j], bh[u][0], bh[u][1]);
          } else {
            mma_tf32(d[u], pl[j], bh[u][0], bh[u][1]);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) mma_tf32(d[u], ph[j], bl[u][0], bl[u][1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) mma_tf32(d[u], ph[j], bh[u][0], bh[u][1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[dp0 + u][e] = fmaf(acc[dp0 + u][e], alpha[e >> 1], d[u][e]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (l[r] == 0.0f) l[r] = 1.0f;
  }
  // float2 where D is even and o 8-byte aligned (then every pair (d, d + 1)
  // is; always at W = 16), else one float at a time
  if (W == 16 || (D % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 8 == 0)) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < D) {  // D even, so d + 1 < D too
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < S) {
            *reinterpret_cast<float2*>(og + static_cast<size_t>(row) * D +
                                       d) =
                make_float2(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int d = 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        float* to = og + static_cast<size_t>(row) * D + d;
        if (row < S && d < D) to[0] = acc[j][2 * r] / l[r];
        if (row < S && d + 1 < D) to[1] = acc[j][2 * r + 1] / l[r];
      }
    }
  }
}

template <int DP, int W>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int KV, int S, int D, float scale,
                   int window, cudaStream_t stream) {
  const int smem = (kBQ + 4 * block_keys(DP)) * (DP + 4) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_tf32_kernel<DP, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attn_tf32_kernel<DP, W><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, H, KV, S, D, scale, window);
  return cudaGetLastError();
}

// D rounded up to a multiple of 16, the kernel's padded head size
template <int W>
cudaError_t launch_d(const float* q, const float* k, const float* v, float* o,
                     int B, int H, int KV, int S, int D, float scale,
                     int window, cudaStream_t s) {
  switch ((D + 15) / 16) {
#define REPRO_LAUNCH(DP) \
  return launch<DP, W>(q, k, v, o, B, H, KV, S, D, scale, window, s)
    case 1: REPRO_LAUNCH(16);
    case 2: REPRO_LAUNCH(32);
    case 3: REPRO_LAUNCH(48);
    case 4: REPRO_LAUNCH(64);
    case 5: REPRO_LAUNCH(80);
    case 6: REPRO_LAUNCH(96);
    case 7: REPRO_LAUNCH(112);
    default: REPRO_LAUNCH(128);
#undef REPRO_LAUNCH
  }
}

// the widest copy, 16 or 4 bytes, that the address p and a row of D floats
// both allow
int width(const void* p, int D) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) | (4u * D);
  return a % 16 == 0 ? 16 : 4;
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, KV, S, D); row-major float32 on the device,
// element-aligned.  H must be a multiple of KV, D in [1, 128]; window 0 means
// none, else key j is visible to query i iff i - window < j <= i.  kv_width
// is the width in bytes of the Q, K and V copies: 16 where q, k, v and a row
// of D floats are 16-byte aligned and o 8-byte aligned, else 4 (ops._route
// picks the widest).  Returns the cudaError_t of the launch.
extern "C" int flash_attention_tf32_fwd(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KV, int S, int D, float scale,
                                        int window, int kv_width,
                                        void* stream) {
  if (B < 0 || H < 0 || KV < 1 || S < 0 || D < 1 || D > 128 ||
      H % KV != 0 || B > 65535 || H > 65535 || window < 0 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 4 ||
      (kv_width != 16 && kv_width != 4) ||
      (kv_width == 16 &&
       (width(q, D) < 16 || width(k, D) < 16 || width(v, D) < 16 ||
        reinterpret_cast<uintptr_t>(o) % 8 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || S == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      kv_width == 16
          ? launch_d<16>(qf, kf, vf, of, B, H, KV, S, D, scale, window, s)
          : launch_d<4>(qf, kf, vf, of, B, H, KV, S, D, scale, window, s);
  return static_cast<int>(err);
}
