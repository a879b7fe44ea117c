// RWKV6 WKV recurrence with a per-key-channel, time-varying decay, f32:
//   y_t = r_t^T S + (r_t . (u o k_t)) v_t,   S <- diag(w_t) S + k_t v_t^T
// per (batch, head), from S = 0.  r, k, v, w, y are (b, L, nh, P) row-major,
// u is (nh, P).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_wkv/rwkv6_wkv.py
// (_wkv_kernel / rwkv6_wkv_pallas), which steps a (Q, P) chunk held in VMEM
// through a fori_loop and carries the (P, P) state in VMEM scratch along a
// sequential grid axis.  Blocks on Hopper run in no order, so here one block
// owns one (batch, head) and walks the whole sequence itself.  The order of
// the recurrence is kept: the decay is per key channel, so a chunked matrix
// form would divide by cumulative decay products, which overflow.
//
// Bound on an H100 SXM at RWKV6-1.6B (nh 32, P 64), b 4, L 2048: bytes, 336
// MB moved (100 us at 3.35 TB/s), against 5.4 GFLOP of FP32 (80 us at 67
// TFLOP/s).  So the CUDA cores suffice once the whole card works on it.
//
// Design:
// - The (P, P) state of a head is spread over the block in 4 x 4 tiles:
//   thread (g, c) holds rows 4 g .. 4 g + 3 of columns 4 c .. 4 c + 3 (P
//   rounded up to MAXP = 64 or 128; (MAXP / 4)^2 threads).  At P <= 64
//   that is 256 threads (8 warps) a block: 128 blocks at RWKV6-1.6B, one an
//   SM.  A step reads one float4 each of r, k, w (its rows) and of v (its
//   columns) from shared memory: shared-memory deliveries, not FP32 work,
//   bound such a kernel, and a 4 x 4 tile needs 16 words for 16 state
//   elements where a column of 16 rows needed 49.  Per element it takes one
//   FMA for y from the old state and an FMUL and an FMA for the update, a
//   chain of one FMA per step.
// - y_j = sum_i r_i S_ij: the MAXP / 4 row groups of a column tile lie in
//   one warp (lane = g + (MAXP / 4) c'), off the state's chain.  KS = 4
//   steps (2 at MAXP = 128) are updated first, then their 4 KS partial sums
//   a thread are reduced at once by a reduce-scatter of warp shuffles (half
//   of the values swapped with lane g ^ 1, a quarter with g ^ 2, ...): 15
//   shuffles for 16 sums over 16 groups, independent of each other at
//   every level, after which lane g holds one (step, column) sum and
//   stores it.
// - The bonus r . (u o k) is one number a step: each chunk's are summed by
//   the warps in parallel before the chunk's steps (a warp a step, shuffle
//   reduction), and added to y_j as (r . (u o k)) v_j by the storing lane.
// - Staging: the (Q, P) tiles of r, k, v and w of a chunk (Q = 64 steps at
//   P <= 64, 128 KB for both stages; 16 at P <= 128) go by cp.async
//   (16-byte copies where P is a multiple of 4 and the pointers aligned,
//   else 4-byte ones) into one of two stages while the other stage's chunk
//   computes; copies past L or P are zero-filled, so the padded rows and
//   columns of the state stay 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

// threads a block at a padded head size MAXP (4 x 4 state tiles), and
// steps of a staged chunk
__host__ __device__ constexpr int threads(int maxp) {
  return (maxp / 4) * (maxp / 4);
}
__host__ __device__ constexpr int chunk(int maxp) {
  return maxp <= 64 ? 64 : 16;
}
// steps whose partial sums are reduced together: 4 x 4 of them fill the 16
// row groups at MAXP = 64; at 128 (32 groups, 1024 threads) two steps
__host__ __device__ constexpr int steps_a_round(int maxp) {
  return maxp <= 64 ? 4 : 2;
}
// floats of shared memory: two stages of r, k, v, w tiles, and the bonus of
// each step of a chunk
__host__ __device__ constexpr int smem_floats(int maxp) {
  return 2 * 4 * chunk(maxp) * maxp + chunk(maxp);
}

// one level of the reduce-scatter: values [0, 2 HALF) -> [0, HALF), the
// lane keeping the upper half if up, the lower one else, and adding what
// lane ^ m sends of the same half
template <int HALF, int NV>
__device__ __forceinline__ void reduce_level(float (&v)[NV], bool up, int m) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, m);
  }
}

// steps [t0, t0 + Q) of r, k, v, w into stage st ([4][Q][MAXP]), zeros
// past L and P
template <int MAXP>
__device__ __forceinline__ void load_stage(float* st, const float* r,
                                           const float* k, const float* v,
                                           const float* w, size_t base,
                                           size_t step, int t0, int L, int P,
                                           bool vec, int tid) {
  constexpr int Q = chunk(MAXP);
  constexpr int kTile = Q * MAXP;
  constexpr int kThreads = threads(MAXP);
  const float* src[4] = {r, k, v, w};
  if (vec) {
    constexpr int kChunks = MAXP / 4;
    for (int e = tid; e < Q * kChunks; e += kThreads) {
      const int q = e / kChunks;
      const int c = e % kChunks;
      const bool in = t0 + q < L && 4 * c < P;
      const size_t at = in ? base + (t0 + q) * step + 4 * c : 0;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        cp_async16(smem_u32(st + a * kTile + q * MAXP + 4 * c), src[a] + at,
                   in ? 16 : 0);
      }
    }
  } else {
    for (int e = tid; e < Q * MAXP; e += kThreads) {
      const int q = e / MAXP;
      const int i = e % MAXP;
      const bool in = t0 + q < L && i < P;
      const size_t at = in ? base + (t0 + q) * step + i : 0;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        cp_async4(smem_u32(st + a * kTile + q * MAXP + i), src[a] + at,
                  in ? 4 : 0);
      }
    }
  }
}

template <int MAXP>
__global__ void __launch_bounds__(threads(MAXP))
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y, int L, int nh,
           int P, int vec) {
  constexpr int GR = MAXP / 4;  // row groups: the lanes of a column tile
  constexpr int kThreads = threads(MAXP);
  constexpr int kWarps = kThreads / 32;
  constexpr int Q = chunk(MAXP);
  constexpr int kTile = Q * MAXP;
  constexpr int KS = steps_a_round(MAXP);  // steps reduced together
  constexpr int NV = 4 * KS;               // their partial sums a thread
  static_assert(Q % KS == 0 && NV <= GR, "reduce-scatter");
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* ruk_s = smem + 2 * 4 * kTile;  // [Q]: r . (u o k) of each step

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane % GR;                        // rows 4 g .. 4 g + 3
  const int cs = warp * (32 / GR) + lane / GR;    // columns 4 cs .. 4 cs + 3
  const size_t step = static_cast<size_t>(nh) * P;  // stride of t
  const size_t base = (static_cast<size_t>(b) * L * nh + h) * P;

  float u_r[(MAXP + 31) / 32];  // u[lane + 32 m], for the bonus
#pragma unroll
  for (int m = 0; m < (MAXP + 31) / 32; ++m) {
    const int i = lane + 32 * m;
    u_r[m] = i < P ? u[static_cast<size_t>(h) * P + i] : 0.0f;
  }
  float S[4][4];  // S[row 4 g + e][column 4 cs + f]
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int f = 0; f < 4; ++f) S[e][f] = 0.0f;
  }

  const int nchunks = (L + Q - 1) / Q;
  load_stage<MAXP>(smem, r, k, v, w, base, step, 0, L, P, vec != 0, tid);
  cp_async_commit();

  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * Q;
    const int n = min(Q, L - t0);
    const float* r_s = smem + (ci & 1) * 4 * kTile;
    const float* k_s = r_s + kTile;
    const float* v_s = r_s + 2 * kTile;
    const float* w_s = r_s + 3 * kTile;
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; the last one is done with the
                      // other stage and with ruk
    if (ci + 1 < nchunks) {
      load_stage<MAXP>(smem + ((ci + 1) & 1) * 4 * kTile, r, k, v, w, base,
                       step, t0 + Q, L, P, vec != 0, tid);
      cp_async_commit();
    }
    // the bonus of each step: a warp a step
    for (int q = warp; q < n; q += kWarps) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < (MAXP + 31) / 32; ++m) {
        const int i = lane + 32 * m;
        if (i < MAXP) {
          acc = fmaf(r_s[q * MAXP + i] * u_r[m], k_s[q * MAXP + i], acc);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == 0) ruk_s[q] = acc;
    }
    __syncthreads();

    // KS steps at a time: their state updates, then one reduce-scatter of
    // their KS x 4 partial sums over the row groups
#pragma unroll 2
    for (int q0 = 0; q0 < n; q0 += KS) {
      float v16[NV];  // partial y of step q0 + (i >> 2), column 4 cs + (i & 3)
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int q = q0 + s;  // steps past n read zeros and are not stored
        const float4 rr = *reinterpret_cast<const float4*>(r_s + q * MAXP +
                                                           4 * g);
        const float4 kk = *reinterpret_cast<const float4*>(k_s + q * MAXP +
                                                           4 * g);
        const float4 ww = *reinterpret_cast<const float4*>(w_s + q * MAXP +
                                                           4 * g);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + q * MAXP +
                                                           4 * cs);
        const float re[4] = {rr.x, rr.y, rr.z, rr.w};
        const float ke[4] = {kk.x, kk.y, kk.z, kk.w};
        const float we[4] = {ww.x, ww.y, ww.z, ww.w};
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
        // y from the old state (over this thread's 4 rows), then S <- S w +
        // k v
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          float pf = re[0] * S[0][f];
#pragma unroll
          for (int e = 1; e < 4; ++e) pf = fmaf(re[e], S[e][f], pf);
          v16[4 * s + f] = pf;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            S[e][f] = fmaf(S[e][f], we[e], ke[e] * vf[f]);
          }
        }
      }
      // reduce-scatter: at lane bit m the lanes with the bit set keep the
      // upper half of the values and send the lower half, so after log2 NV
      // levels lane g holds the sum of value idx(g) over 2^levels groups;
      // the levels left are plain sums
      reduce_level<NV / 2>(v16, (g & 1) != 0, 1);
      reduce_level<NV / 4>(v16, (g & 2) != 0, 2);
      reduce_level<NV / 8>(v16, (g & 4) != 0, 4);
      if constexpr (NV >= 16) reduce_level<NV / 16>(v16, (g & 8) != 0, 8);
#pragma unroll
      for (int m = NV; m < GR; m <<= 1) {
        v16[0] += __shfl_xor_sync(kFull, v16[0], m);
      }
      if (g < NV) {
        // the value this lane holds: bit m of g adds NV / 2m
        const int idx = (g & 1 ? NV / 2 : 0) + (g & 2 ? NV / 4 : 0) +
                        (g & 4 ? NV / 8 : 0) + (NV >= 16 && (g & 8) ? 1 : 0);
        const int q = q0 + (idx >> 2);
        const int jj = 4 * cs + (idx & 3);
        if (q < n && jj < P) {
          y[base + (t0 + q) * step + jj] =
              fmaf(ruk_s[q], v_s[q * MAXP + jj], v16[0]);
        }
      }
    }
  }
}

template <int MAXP>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, int b, int L, int nh, int P,
           cudaStream_t stream) {
  constexpr size_t kBytes = smem_floats(MAXP) * sizeof(float);
  auto kernel = wkv_kernel<MAXP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = P % 4 == 0 && aligned(r) && aligned(k) && aligned(v) &&
                  aligned(w);
  kernel<<<dim3(nh, b), threads(MAXP), kBytes, stream>>>(r, k, v, w, u, y, L,
                                                          nh, P, vec);
  return static_cast<int>(cudaGetLastError());
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
  if (b == 0 || L == 0 || nh == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 64) return launch<64>(r, k, v, w, u, y, b, L, nh, P, s);
  return launch<128>(r, k, v, w, u, y, b, L, nh, P, s);
}
