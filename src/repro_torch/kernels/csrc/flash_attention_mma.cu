// Causal GQA attention on the tensor cores, forward only, bfloat16 in and
// out, with an optional sliding window:
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j]
// over the keys j visible to query i (i - window < j <= i), g = h / (H / KV).
// q, o are (B, H, S, D) and k, v (B, KV, S, D), row-major bfloat16, any D
// from 1 to 128, any element-aligned pointers.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (_flash_kernel / flash_attention_pallas) for bfloat16
// inputs.  The wrapper (flash_attention/ops.py, _route) sends every bfloat16
// call here and every float32 call to flash_attention_tf32.cu.
//
// Bound on an H100 SXM at Zamba2-2.7B's shared attention (B 4, H = KV = 32,
// S 2048, D 80): 4 D operations per visible (query, key) pair, 8.6e10 in
// all, are 0.087 ms at the bf16 tensor-core rate (989 TFLOP/s), against 168
// MB of q, k, v and o (0.050 ms): the operations bound it.
//
// Design (the FlashAttention-2 shape on mma.sync):
// - One block of 4 warps per (query tile of 64 rows, head, batch); warp w
//   owns rows 16 w .. 16 w + 15.  Tiles are issued longest first, and a
//   block visits only the KV tiles that hold a key some row of it can see
//   (from q0 - window + 1, or 0, up to its last row), so the window case
//   is sub-quadratic.  The mask is applied only on tiles that cross the
//   causal diagonal or the window's edge.
// - Q goes once into registers as m16n8k16 A fragments (ldmatrix).  K and V
//   tiles of 64 keys go through a 2-stage ring, so the next tile's copy runs
//   under this tile's math, zero-filled for keys >= S and for the columns
//   from D up to DP, D rounded up to 16.  The copies of Q, K and V are W
//   bytes wide, a template parameter:
//   - 16: cp.async chunks of 8 elements where q, k, v and a row of D
//     elements are 16-byte aligned and o takes pair stores: every model
//     width on fresh tensors.  This kernel has no run-time branch on
//     alignment: a run-time choice of Q's width inside it moved the
//     compiler's register allocation (to 230-255 registers at DP = 128,
//     spills at DP = 80), so any narrower input takes a narrow kernel;
//   - 4: cp.async pairs (even D, k and v 4-byte aligned; Q in pairs too,
//     or, at an odd offset, in single elements, a run-time choice);
//   - 2: an odd D or an odd element offset of k or v, which cp.async (4
//     bytes at least) cannot take: 2-byte loads through registers, stored
//     to shared memory and ordered before the tile is read by the ring's
//     own barriers.
//   A narrow tile is one run of 64 D elements in memory, walked flat with a
//   run-time trip count (unrolled, the 20-64 pieces a thread kept their
//   addresses in registers across the tiles and spilled); its padding
//   columns are zeroed once.  Rows of shared memory are DP + 8 elements
//   long, an odd number of 16-byte chunks, so the 8 rows an ldmatrix phase
//   reads fall in 8 distinct bank groups at every DP (D = 80: 176-byte
//   rows).
// - S = Q K^T on mma.sync.m16n8k16 bf16 -> f32 (K by ldmatrix); the bf16
//   products are exact in f32, so only the order of summation differs from
//   the plain version.  scale multiplies the f32 scores, as in the JAX
//   kernel, with log2(e) folded in, so that p = exp2(s - m) is one ex2
//   per score without expf's range reduction.  The row max and sum run
//   over the quad of lanes that holds a row.  Masked keys get p = 0
//   exactly, never exp(-1e30 - m), and m stays -inf until a row's first
//   visible key (alpha = 1 then).
// - P V: the f32 accumulators of two n8 tiles of S are the A fragment of
//   one k16 step, and V comes by ldmatrix.trans.  P is NOT rounded to one
//   bf16: the JAX kernel multiplies an f32 p by v, and a bf16 p carries
//   ~2^-9 relative error per term, ~4e-5 absolute at S 2048 on outputs of
//   ~0.04, past the 1e-5 floor of the per-element bound the kernel is held
//   to.  P = P_hi + P_lo, both bf16 (P_lo = bf16(P - P_hi)), keeps ~16 bits
//   of p, ~2^-17 relative, for two MMAs against each V fragment: 1.5x the
//   tensor work of plain FA2.
// - Epilogue: O / l (l == 0 -> 1, as in the JAX kernel), rounded to nearest
//   even, stored as bf16 pairs with ragged rows guarded, or (narrow kernels)
//   one element at a time where D is odd or o is not 4-byte aligned.
// - Occupancy: registers, not shared memory, limit the blocks of an SM, so
//   the launch bounds ask for 3 blocks up to DP = 80 (at most 170 registers
//   a thread) and 4 up to DP = 48.  At DP >= 96 the O accumulator and Q
//   fragments alone take 96-128 registers and a cap of 170 spills, so 2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows of a block
constexpr int kBK = 64;                 // keys of a K/V tile
constexpr int kThreads = 128;           // 4 warps of 16 query rows
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// blocks an SM should hold at a padded head size DP (launch bounds)
constexpr int min_blocks(int dp) { return dp <= 48 ? 4 : dp <= 80 ? 3 : 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b on one m16n8k16 tile: bf16 a (16 x 16, row) and b (16 x 8, col),
// f32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (p0, p1) -> hi = bf16 pair of them, lo = bf16 pair of what hi misses; the
// lower 16 bits hold p0 (the lower column of an A fragment register)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// rows [r0, r0 + 64) of src (S rows of D) into dst (64 rows of ROW elements,
// the first DP of them read): 16-byte chunks, zeros for rows >= S and for
// the chunks from D to DP (D % 8 == 0, src 16-byte aligned)
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int S, int D, int tid) {
  constexpr int kRow = DP + 8;
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int i = 0; i < kChunks / 2; ++i) {  // 64 * kChunks / kThreads
    const int e = tid + i * kThreads;
    const int r = e / kChunks;
    const int c = e % kChunks;
    const bool in = r0 + r < S && 8 * c < D;
    const __nv_bfloat16* from =
        in ? src + static_cast<size_t>(r0 + r) * D + 8 * c : src;
    cp_async16(smem_u32(dst + r * kRow + 8 * c), from, in ? 16 : 0);
  }
}

// the same rows in pieces of W bytes: 4 by cp.async (D even, src 4-byte
// aligned) or 2 through registers; only the first D columns are written
// (zero_pad clears the rest once), zeros for rows >= S.  The 64 rows are
// one run of 64 D elements at src + r0 D, walked flat: element f lies in
// row f / D, the quotient from a float reciprocal of D (exact: f < 2^13
// and D <= 128 keep the rounding below 0.5 / D), and the trip count is
// left to run time, so that no piece's address is held across the tiles
template <int DP, int W>
__device__ __forceinline__ void load_tile_narrow(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* src,
                                                 int r0, int S, int D,
                                                 float rcp_d, int tid) {
  static_assert(W == 4 || W == 2, "pieces of 4 or 2 bytes");
  constexpr int kRow = DP + 8;
  constexpr int kE = W / 2;                 // elements of a piece
  const int end = kBK * D;                  // elements of the tile
  const int valid = min(S - r0, kBK) * D;   // those of rows < S
  const __nv_bfloat16* base = src + static_cast<size_t>(r0) * D;
#pragma unroll 4
  for (int f = kE * tid; f < end; f += kE * kThreads) {
    const int r = static_cast<int>((f + 0.5f) * rcp_d);
    __nv_bfloat16* to = dst + r * kRow + (f - r * D);
    const bool in = f < valid;
    if constexpr (W == 4) {
      cp_async4(smem_u32(to), in ? base + f : base, in ? 4 : 0);
    } else {
      *reinterpret_cast<uint16_t*>(to) =
          in ? *reinterpret_cast<const uint16_t*>(base + f) : uint16_t{0};
    }
  }
}

// columns [D, DP) of `rows` rows of ROW elements set to zero, in the tiles
// that narrow copies fill
template <int DP>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* dst, int rows, int D,
                                         int tid) {
  constexpr int kRow = DP + 8;
  for (int r = tid; r < rows; r += kThreads) {
    for (int c = D; c < DP; ++c) {
      reinterpret_cast<uint16_t*>(dst)[r * kRow + c] = 0;
    }
  }
}

// a K or V tile in pieces of W bytes
template <int DP, int W>
__device__ __forceinline__ void load_kv(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int r0,
                                        int S, int D, float rcp_d, int tid) {
  if constexpr (W == 16) {
    load_tile<DP>(dst, src, r0, S, D, tid);
  } else {
    load_tile_narrow<DP, W>(dst, src, r0, S, D, rcp_d, tid);
  }
}

// W: the width in bytes of the Q, K and V copies (16 only where all three
// and o allow it); qw: the widest that Q allows (read at W = 4, where Q may
// need 2)
template <int DP, int W>
__global__ void __launch_bounds__(kThreads, min_blocks(DP))
flash_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int H, int KV, int S,
                      int D, float scale, int window, int qw) {
  constexpr int kSteps = DP / 16;  // k16 steps of Q K^T, n16 pairs of P V
  constexpr int kRow = DP + 8;     // elements of a shared-memory row
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* k_s = q_s + kBQ * kRow;      // [2][kBK][kRow]
  __nv_bfloat16* v_s = k_s + 2 * kBK * kRow;  // [2][kBK][kRow]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int q0 = tile * kBQ;
  const __nv_bfloat16* qg = q + (static_cast<size_t>(b) * H + h) * S * D;
  const __nv_bfloat16* kg = k + (static_cast<size_t>(b) * KV + g) * S * D;
  const __nv_bfloat16* vg = v + (static_cast<size_t>(b) * KV + g) * S * D;
  __nv_bfloat16* og = o + (static_cast<size_t>(b) * H + h) * S * D;

  const int hi = min(S, q0 + kBQ);  // keys >= hi are above every row
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int ntiles = (hi - lo + kBK - 1) / kBK;  // >= 1: lo <= q0 < hi

  const float rcp_d = 1.0f / D;  // for the narrow copies
  if constexpr (W == 16) {
    load_tile<DP>(q_s, qg, q0, S, D, tid);
  } else {
    zero_pad<DP>(q_s, kBQ + 4 * kBK, D, tid);  // the Q, K and V tiles
    if (W == 4 && qw >= 4) {
      load_tile_narrow<DP, 4>(q_s, qg, q0, S, D, rcp_d, tid);
    } else {
      load_tile_narrow<DP, 2>(q_s, qg, q0, S, D, rcp_d, tid);
    }
  }
  load_kv<DP, W>(k_s, kg, lo, S, D, rcp_d, tid);
  load_kv<DP, W>(v_s, vg, lo, S, D, rcp_d, tid);
  cp_async_commit();

  // the rows of this lane: c0, c1 of an m16n8 tile hold row r, c2, c3 row
  // r + 8, at columns 2 quad and 2 quad + 1
  const int row0 = q0 + 16 * warp + lane / 4;
  // ldmatrix row addresses: lanes 8 i .. 8 i + 7 give the rows of matrix i
  const int a_row = 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
  const int a_col = 8 * (lane / 16);
  const int kb_row = lane % 8 + 8 * (lane / 16);
  const int kb_col = 8 * ((lane / 8) % 2);
  const int vb_row = lane % 8 + 8 * ((lane / 8) % 2);
  const int vb_col = 8 * (lane / 16);

  uint32_t qa[kSteps][4];
  float acc[2 * kSteps][4];
#pragma unroll
  for (int j = 0; j < 2 * kSteps; ++j) {
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
      load_kv<DP, W>(k_s + (st ^ 1) * kBK * kRow, kg, k0 + kBK, S, D, rcp_d,
                     tid);
      load_kv<DP, W>(v_s + (st ^ 1) * kBK * kRow, vg, k0 + kBK, S, D, rcp_d,
                     tid);
    }
    cp_async_commit();  // possibly empty: one group per iteration
    cp_async_wait1();   // this tile's group (and Q's) has landed
    __syncthreads();    // (and the plain shared stores are seen)
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        ldmatrix_x4(qa[kk], smem_u32(q_s + a_row * kRow + 16 * kk + a_col));
      }
    }
    const __nv_bfloat16* ks = k_s + st * kBK * kRow;
    const __nv_bfloat16* vs = v_s + st * kBK * kRow;

    // S = Q K^T: 8 n8 tiles of keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(ks + (16 * jp + kb_row) * kRow + 16 * kk +
                                 kb_col));
        mma_bf16(s[2 * jp], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax
    const bool edge = k0 + kBK - 1 > q0 ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * quad + (e & 1);
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
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == -INFINITY ? 0.0f : exp2f(x - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * kSteps; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += (P_hi + P_lo) V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kSteps; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vs + (16 * kk + vb_row) * kRow +
                                       16 * dp + vb_col));
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
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
  // bf16 pairs where D is even and o 4-byte aligned (then every pair (d,
  // d + 1) is; always at W = 16), else one element at a time
  if (W == 16 || (D % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0)) {
#pragma unroll
    for (int j = 0; j < 2 * kSteps; ++j) {
      const int d = 8 * j + 2 * quad;
      if (d < D) {  // D even, so d + 1 < D too
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < S) {
            *reinterpret_cast<__nv_bfloat162*>(
                og + static_cast<size_t>(row) * D + d) =
                __floats2bfloat162_rn(acc[j][2 * r] / l[r],
                                      acc[j][2 * r + 1] / l[r]);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2 * kSteps; ++j) {
      const int d = 8 * j + 2 * quad;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        __nv_bfloat16* to = og + static_cast<size_t>(row) * D + d;
        if (row < S && d < D) {
          to[0] = __float2bfloat16_rn(acc[j][2 * r] / l[r]);
        }
        if (row < S && d + 1 < D) {
          to[1] = __float2bfloat16_rn(acc[j][2 * r + 1] / l[r]);
        }
      }
    }
  }
}

template <int DP, int W>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int D, float scale,
                   int window, int qw, cudaStream_t stream) {
  const int smem = (kBQ + 4 * kBK) * (DP + 8) *
                   static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_mma_kernel<DP, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attn_mma_kernel<DP, W><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      KV, S, D, scale, window, qw);
  return cudaGetLastError();
}

// D rounded up to a multiple of 16, the kernel's padded head size
template <int W>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int S, int D, float scale,
                     int window, int qw, cudaStream_t s) {
  switch ((D + 15) / 16) {
#define REPRO_LAUNCH(DP) \
  return launch<DP, W>(q, k, v, o, B, H, KV, S, D, scale, window, qw, s)
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

// the widest copy, 16, 4 or 2 bytes, that the address p and a row of D
// bfloat16 elements both allow
int width(const void* p, int D) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) | (2u * D);
  return a % 16 == 0 ? 16 : a % 4 == 0 ? 4 : 2;
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, KV, S, D); row-major bfloat16 on the device,
// element-aligned.  H must be a multiple of KV, D in [1, 128]; window 0 means
// none, else key j is visible to query i iff i - window < j <= i.  kv_width
// is the width in bytes of the K and V copies: 16 where q, k, v and a row of
// D elements are 16-byte aligned and o 4-byte aligned, else 4 or 2, at most
// what k, v and the row allow (ops._route picks the widest).  Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_mma_fwd(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int KV, int S, int D, float scale,
                                       int window, int kv_width,
                                       void* stream) {
  const int qw = width(q, D);
  if (B < 0 || H < 0 || KV < 1 || S < 0 || D < 1 || D > 128 ||
      H % KV != 0 || B > 65535 || H > 65535 || window < 0 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 2 ||
      (kv_width != 16 && kv_width != 4 && kv_width != 2) ||
      width(k, D) < kv_width || width(v, D) < kv_width ||
      (kv_width == 16 &&
       (qw < 16 || reinterpret_cast<uintptr_t>(o) % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || S == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_width == 16) {
    err = launch_d<16>(q, k, v, o, B, H, KV, S, D, scale, window, qw, s);
  } else if (kv_width == 4) {
    err = launch_d<4>(q, k, v, o, B, H, KV, S, D, scale, window, qw, s);
  } else {
    err = launch_d<2>(q, k, v, o, B, H, KV, S, D, scale, window, qw, s);
  }
  return static_cast<int>(err);
}
