// Causal GQA attention, forward only, with an optional sliding window:
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j]
// over the keys j visible to query i (i - window < j <= i), g = h / (H / KV).
// q, o are (B, H, S, D) and k, v (B, KV, S, D), row-major, float32 or
// bfloat16 alike; all math is float32 and o is rounded to the input type.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (_flash_kernel / flash_attention_pallas), which visits
// all (query block, KV block) pairs of a (B, H, nq, nk) grid and carries the
// running max, denominator and (bq, D) accumulator in VMEM scratch along the
// sequential KV axis.  Blocks on Hopper run in no order, so here one block
// owns one (query tile of 64 rows, head, batch) and loops over the KV tiles
// itself.  It visits only the keys some row of its tile can see: from
// q0 - window + 1 (or 0) up to the tile's last row, so tiles wholly above the
// causal diagonal or wholly outside the window are never loaded, and any S
// is taken without padding (ragged query rows and keys are masked here).
//
// Layout: 256 threads, 4 lanes per query row.  Lane c of a row holds the
// float4 column chunks c, c + 4, c + 8, ... of its q row and of its (64, D)
// accumulator in registers (D padded with zeros to 16 NG columns, NG = 2, 4,
// 5 or 8).  Per KV tile of 64 keys the block stages K and V in shared memory
// as float32; each lane forms partial dot products for 4 keys at a time,
// and a 3-shuffle butterfly leaves lane c with the whole score of key c of
// the 4.  Masked keys get p = 0 exactly, never exp(-1e30 - m): the row max,
// the rescale alpha = exp(m - m_new) and the denominator are per tile, each
// lane exponentiates its own keys, and all 4 lanes then accumulate p V over
// the tile's keys for their columns.  A row that has seen no visible key yet
// keeps m = -inf, l = 0 and acc = 0 (alpha is 1 then).  Under causality
// every row sees itself, so l > 0 at the end; l == 0 -> 1 as in the JAX
// kernel.  Query tiles are issued longest first (the last rows see the most
// keys).
//
// Bound on an H100 SXM at Zamba2-2.7B's shared attention (B 4, H = KV = 32,
// S 2048, D 80): 4 D operations per visible (query, key) pair, 8.6e10 in
// all, are 0.087 ms at the bf16 tensor-core rate (989 TFLOP/s) and 1.28 ms
// at the FP32 rate (67 TFLOP/s), against 168 MB of bf16 q, k, v and o (0.050
// ms): the operations bound it.  This kernel uses FP32 FFMA and no tensor
// cores, and each FFMA reads its operand from shared memory, so it runs far
// above the bf16 bound; mma/wgmma, TMA and pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                  // query rows of a block
constexpr int kLanes = 4;                // threads of one query row
constexpr int kThreads = kBQ * kLanes;   // 256
constexpr int kBK = 64;                  // keys of a staged K/V tile
constexpr int kSStride = kBK + 4;        // floats of a score row (no bank
                                         // conflicts across a warp's 8 rows)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_attn_ffma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int S, int D, float scale, int window) {
  constexpr int DP = 16 * NG;  // padded head size: 4 lanes x NG float4
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBK][DP]
  float* v_s = k_s + kBK * DP;                    // [kBK][DP]
  float* s_s = v_s + kBK * DP;                    // [kBQ][kSStride]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int c = tid % kLanes;
  const int q0 = tile * kBQ;
  const int row = q0 + r;
  const size_t q_base = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * KV + g) * S * D;

  float qr[NG][4], acc[NG][4];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c + 4 * i) + e;
      qr[i][e] = (row < S && d < D)
                     ? to_f32(q[q_base + static_cast<size_t>(row) * D + d])
                     : 0.0f;
      acc[i][e] = 0.0f;
    }
  }
  float m = -INFINITY;  // running max of the row (alike in its 4 lanes)
  float l = 0.0f;       // this lane's share of the running denominator
  float* srow = s_s + r * kSStride;

  const int hi = min(S, q0 + kBQ);  // keys >= hi are above every row
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = lo; k0 < hi; k0 += kBK) {
    const int n = min(kBK, hi - k0);  // keys of this tile
    const int n4 = (n + 3) & ~3;      // rounded up to the 4 lanes
    __syncthreads();                  // the previous tile is consumed
    for (int e = tid; e < n4 * DP; e += kThreads) {
      const int j = e / DP;
      const int d = e % DP;
      const bool in = j < n && d < D;
      const size_t at = kv_base + static_cast<size_t>(k0 + j) * D + d;
      k_s[e] = in ? to_f32(k[at]) : 0.0f;
      v_s[e] = in ? to_f32(v[at]) : 0.0f;
    }
    __syncthreads();

    // scores: lane c ends with the score of key j + c of each 4
    float tmax = -INFINITY;
    for (int j = 0; j < n4; j += 4) {
      float a[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + (j + t) * DP);
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const float4 kk = kr[c + 4 * i];
          s0 = fmaf(qr[i][0], kk.x, s0);
          s1 = fmaf(qr[i][1], kk.y, s1);
          s0 = fmaf(qr[i][2], kk.z, s0);
          s1 = fmaf(qr[i][3], kk.w, s1);
        }
        a[t] = s0 + s1;
      }
      const bool odd = c & 1;
      const float b0 = (odd ? a[1] : a[0]) +
                       __shfl_xor_sync(kFull, odd ? a[0] : a[1], 1);
      const float b1 = (odd ? a[3] : a[2]) +
                       __shfl_xor_sync(kFull, odd ? a[2] : a[3], 1);
      const bool up = c & 2;
      const float dot = (up ? b1 : b0) + __shfl_xor_sync(kFull, up ? b0 : b1, 2);
      const int key = k0 + j + c;
      const bool visible = j + c < n && key <= row &&
                           (window <= 0 || key > row - window);
      const float sc = visible ? dot * scale : -INFINITY;
      srow[j + c] = sc;
      tmax = fmaxf(tmax, sc);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = m_new == -INFINITY ? 1.0f : expf(m - m_new);
    l *= alpha;
    // each lane turns its own scores (keys c, c + 4, ...) into p
    for (int j = c; j < n4; j += 4) {
      const float sc = srow[j];
      const float p = sc == -INFINITY ? 0.0f : expf(sc - m_new);
      srow[j] = p;
      l += p;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NG; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
    }
    for (int j = 0; j < n4; ++j) {
      const float p = srow[j];
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * DP);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float4 vv = vr[c + 4 * i];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
    m = m_new;
  }

  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  if (l == 0.0f) l = 1.0f;
  if (row < S) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (c + 4 * i) + e;
        if (d < D) {
          store(&o[q_base + static_cast<size_t>(row) * D + d], acc[i][e] / l);
        }
      }
    }
  }
}

template <typename T, int NG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int D, float scale,
                   int window, cudaStream_t stream) {
  const int smem =
      static_cast<int>((2 * kBK * 16 * NG + kBQ * kSStride) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_ffma_kernel<T, NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attn_ffma_kernel<T, NG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, D, scale,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int S, int D, float scale,
                     int window, cudaStream_t s) {
  if (D <= 32) return launch<T, 2>(q, k, v, o, B, H, KV, S, D, scale, window, s);
  if (D <= 64) return launch<T, 4>(q, k, v, o, B, H, KV, S, D, scale, window, s);
  if (D <= 80) return launch<T, 5>(q, k, v, o, B, H, KV, S, D, scale, window, s);
  return launch<T, 8>(q, k, v, o, B, H, KV, S, D, scale, window, s);
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, KV, S, D); row-major on the device, float32
// (dtype 0) or bfloat16 (dtype 1) alike.  H must be a multiple of KV, D lie
// in [1, 128]; window 0 means none, else key j is visible to query i iff
// i - window < j <= i.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KV, int S, int D, float scale,
                                   int window, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 0 || H < 0 || KV < 1 || S < 0 ||
      D < 1 || D > 128 || H % KV != 0 || B > 65535 || H > 65535 ||
      window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || S == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_d<float>(q, k, v, o, B, H, KV, S, D, scale, window, s)
          : launch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, S, D, scale, window,
                                    s);
  return static_cast<int>(err);
}
