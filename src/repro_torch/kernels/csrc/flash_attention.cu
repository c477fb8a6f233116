// Flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   * flash_fwd_kernel <- flash_attention_pallas (_fa_kernel).
//
// It computes softmax(q k^T * scale + mask) v for q (B, Hq, S, D) and k/v
// (B, Hkv, T, D) with grouped-query heads (kv head = q head / (Hq / Hkv)),
// the causal and sliding-window masks, key padding (columns >= t_valid are
// masked) and the row alignment of the Pallas kernel: query row s sits at
// position s + q_offset.  Scores, the online softmax and the accumulator
// are f32 whatever the input dtype, as in _fa_kernel (which casts q, k, v
// *and* p to f32); the output is written in the input dtype, and a row
// with no valid column writes 0.
//
// What bounds it on the H100: operations.  At the training shapes (S = T =
// 4096, D = 120, causal) it does ~4*D flops per (row, live column) on each
// K/V element it stages, far above the card's ~295 flop/byte balance.  This
// first version runs both products on CUDA cores in f32 (67 TFLOP/s peak,
// against 989 TFLOP/s for bf16 on the tensor cores), so its floor is ~15x
// the bound; a wgmma/TMA design is later work.
//
// The TPU walked key blocks on a sequential grid axis with the softmax
// state carried in VMEM scratch.  Here one thread block owns one
// (batch, q head, 64-row q tile) and loops over the live 64-key tiles
// itself; tiles that the causal mask, the window or t_valid rule out
// whole are never loaded (the Pallas kernel's pl.when block skipping).
// The q tiles are issued last-first, so the blocks with the longest causal
// loop start first.  The 256 threads form a 16 x 16 grid: thread (ty, tx)
// owns query rows ty + 16 i (i < 4), and in the score tile key columns
// tx + 16 c (c < 4), in the output value dims tx*4 + {0..3} and
// 64 + tx*4 + {0..3}.  A row's 16 owners sit in one half-warp, so its max
// and sum are warp shuffles, and the running max, denominator and the
// 4 x 8 accumulator stay in registers.  Q and K tiles live in shared memory
// as f32 rows padded to 128 dims (zeros past D; D = 120 is h2o-danube's
// head dim) with a stride of 132 floats, which keeps the float4 reads of
// 16 different rows free of bank conflicts; the probability tile reuses
// the K tile's space once the scores are done.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for a shape it
// does not take.  dtype 0 = float32, 1 = bfloat16; q, k, v and out share
// it and are contiguous; S and T must be multiples of the 64-row tiles
// (the wrapper pads); window < 0 means no sliding window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kDP = 128;          // head dim as padded in shared memory
constexpr int kLD = kDP + 4;      // row stride of the Q and K tiles, floats
constexpr int kLDP = kBK + 4;     // row stride of the probability tile
constexpr int kThreads = 256;     // a 16 x 16 thread grid
constexpr int kR = kBQ / 16;      // query rows per thread
constexpr int kC = kBK / 16;      // key columns per thread
constexpr int kV = kDP / 16;      // value dims per thread
constexpr size_t kSmemBytes = sizeof(float) * ((size_t)kBQ * kLD + (size_t)kBK * kLD +
                                               (size_t)kBK * kDP);

static_assert(kBQ == kBK, "load_tile stages square tiles");
static_assert(kBQ * kLDP <= kBK * kLD, "the P tile must fit in the K tile's space");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage kBK rows of D elements (row stride D in device memory) as f32 rows
// of kDP floats, `ld` apart, zero past D.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src, int D) {
  for (int e = threadIdx.x; e < kBK * kDP; e += kThreads) {
    const int r = e / kDP, d = e % kDP;
    dst[r * ld + d] = d < D ? to_f32(src[(size_t)r * D + d]) : 0.f;
  }
}

// max / sum over the 16 lanes of a half-warp (one row's owners)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int Hq, int Hkv, int S, int T_, int D, int t_valid,
                 int q_offset, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (kBQ, kLD)
  float* ks = qs + kBQ * kLD;       // (kBK, kLD); then P, (kBQ, kLDP)
  float* vs = ks + kBK * kLD;       // (kBK, kDP)
  float* ps = ks;

  const int qi = gridDim.x - 1 - blockIdx.x;   // longest causal loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* qb = q + (((size_t)b * Hq + h) * S + (size_t)qi * kBQ) * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)T_ * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)T_ * D;
  load_tile(qs, kLD, qb, D);

  // live key tiles [j0, j1): the Pallas kernel's block-skipping test
  const int first_row = qi * kBQ + q_offset;
  const int last_row = first_row + kBQ - 1;
  int hi_col = t_valid - 1;
  if (causal) hi_col = min(hi_col, last_row);
  const int lo_col = window >= 0 ? max(0, first_row - window + 1) : 0;
  const int j0 = lo_col / kBK;
  const int j1 = hi_col < 0 ? 0 : min(T_ / kBK, hi_col / kBK + 1);
  const int dlim = (D + 3) & ~3;    // dims past D are zero in both tiles

  float o[kR][kV];
  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kV; ++u) o[i][u] = 0.f;
  }

  for (int j = j0; j < j1; ++j) {
    __syncthreads();                // the previous tile's P and V are consumed
    load_tile(ks, kLD, kb + (size_t)j * kBK * D, D);
    load_tile(vs, kDP, vb + (size_t)j * kBK * D, D);
    __syncthreads();

    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) s[i][c] = 0.f;
    for (int d = 0; d < dlim; d += 4) {
      float4 qv[kR], kv[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLD + d);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        kv[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * kLD + d);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          float acc = s[i][c];
          acc = fmaf(qv[i].x, kv[c].x, acc);
          acc = fmaf(qv[i].y, kv[c].y, acc);
          acc = fmaf(qv[i].z, kv[c].z, acc);
          acc = fmaf(qv[i].w, kv[c].w, acc);
          s[i][c] = acc;
        }
    }

    // mask, then one online-softmax step per row
    const int col0 = j * kBK;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = first_row + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = col0 + tx + 16 * c;
        const bool ok = col < t_valid && (!causal || col <= row) &&
                        (window < 0 || col > row - window);
        s[i][c] = ok ? s[i][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        s[i][c] = m_new == -INFINITY ? 0.f : expf(s[i][c] - m_new);
        sum += s[i][c];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < kV; ++u) o[i][u] *= alpha;
    }

    __syncthreads();                // every score read of the K tile is done
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) ps[(ty + 16 * i) * kLDP + tx + 16 * c] = s[i][c];
    __syncthreads();

    for (int t = 0; t < kBK; t += 4) {
      float4 pv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLDP + t);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const float4 va = *reinterpret_cast<const float4*>(vs + (t + tt) * kDP + tx * 4);
        const float4 vb4 = *reinterpret_cast<const float4*>(vs + (t + tt) * kDP + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float p = tt == 0 ? pv[i].x : tt == 1 ? pv[i].y : tt == 2 ? pv[i].z : pv[i].w;
          o[i][0] = fmaf(p, va.x, o[i][0]);
          o[i][1] = fmaf(p, va.y, o[i][1]);
          o[i][2] = fmaf(p, va.z, o[i][2]);
          o[i][3] = fmaf(p, va.w, o[i][3]);
          o[i][4] = fmaf(p, vb4.x, o[i][4]);
          o[i][5] = fmaf(p, vb4.y, o[i][5]);
          o[i][6] = fmaf(p, vb4.z, o[i][6]);
          o[i][7] = fmaf(p, vb4.w, o[i][7]);
        }
      }
    }
  }

  T* ob = out + (((size_t)b * Hq + h) * S + (size_t)qi * kBQ) * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const float denom = l[i] == 0.f ? 1.f : l[i];     // fully masked rows -> 0
    const int r = ty + 16 * i;
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int d = (u < 4 ? 0 : 64) + tx * 4 + (u % 4);
      if (d < D) ob[(size_t)r * D + d] = from_f32<T>(o[i][u] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int S, int T_, int D, int t_valid, int q_offset, int causal, int window,
           float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / kBQ, Hq, B);
  flash_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, S, T_, D, t_valid, q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of a q tile and keys of a k tile: S and T must be multiples.
int repro_flash_block_q(void) { return kBQ; }
int repro_flash_block_k(void) { return kBK; }
int repro_flash_max_head_dim(void) { return kDP; }

int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                          int Hq, int Hkv, int S, int T, int D, int t_valid, int q_offset,
                          int causal, int window, float scale, int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || D < 1 || D > kDP || S < kBQ || S % kBQ ||
      T < kBK || T % kBK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Hq, Hkv, S, T, D, t_valid, q_offset, causal,
                         window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, T, D, t_valid, q_offset,
                                 causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
