// Flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   * flash_fwd_kernel (f32) and flash_fwd_kernel_bf16 (bf16)
//     <- flash_attention_pallas (_fa_kernel).
//
// It computes softmax(q k^T * scale + mask) v for q (B, Hq, S, D) and k/v
// (B, Hkv, T, D) with grouped-query heads (kv head = q head / (Hq / Hkv)),
// the causal and sliding-window masks, key padding (columns >= t_valid are
// masked) and the row alignment of the Pallas kernel: query row s sits at
// position s + q_offset.  Scores, the online softmax and the accumulator
// are f32 whatever the input dtype, as in _fa_kernel (which casts q, k, v
// *and* p to f32); the output is written in the input dtype, and a row
// with no valid column writes 0.  Key tiles that the causal mask, the
// window or t_valid rule out whole are never loaded (the Pallas kernel's
// pl.when block skipping).  The TPU walked key blocks on a sequential grid
// axis with the softmax state in VMEM scratch; here a block loops over its
// live key tiles itself with the state in registers.
//
// What bounds it on the H100: operations.  At the training shapes (S = T =
// 4096, D = 120, causal) it does ~4*D flops per (row, live column) on each
// K/V element it stages, far above the card's ~295 flop/byte balance.
//
// bf16 body (flash_fwd_kernel_bf16): both products on the tensor cores.
// One block owns 128 query rows of one (batch, q head): two consumer
// warpgroups of 64 rows each run attention_tile.cuh's stage loop (wgmma
// for Q K^T, f32 online softmax in registers, wgmma for P V with P split
// into bf16 P_hi + P_lo, see there why), and one producer warp brings the
// Q tiles and a 3-stage ring of 64-key K/V tiles by TMA, each stage
// signalled through an mbarrier and released by the consumers.  What the
// design does about the bound: the stage loop issues a stage's Q K^T with
// the previous stage's P V and runs the softmax while they are in flight,
// and the two warpgroups take turns issuing (ping-pong through two
// mbarriers), so one's softmax overlaps the other's products.  Both walk
// all the block's tiles, so their turns pair up; a tile that one of them
// masks whole gives it p = 0.  Three 2-D tensor maps over (rows, D) with
// 64 x 64 boxes in the 128-byte swizzle (the largest box inner extent
// that swizzle allows, so a 128-dim tile is two boxes) load the tiles in
// wgmma's layout; dims past D are filled with zeros by TMA, so D = 120 and
// D = 128 share one path.  D must be a multiple of 8 (a TMA row stride is
// a multiple of 16 bytes; the wrapper pads).  The split costs 6*D instead
// of 4*D tensor-core operations per (row, key), so at best the kernel
// reaches 2/3 of its bound.  Blocks are ordered q head fastest, so the
// Hq / Hkv heads of one KV head run together and share its K/V tiles in
// L2, and the q tiles with the longest causal loops start first.  The
// maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (no -lcuda; tensor_map.cuh, shared with
// the backward).
//
// f32 body (flash_fwd_kernel): the tensor cores have no f32 product, so it
// runs both products on CUDA cores in f32 (67 TFLOP/s peak against 989
// bf16), one block per 64-row q tile.  The 256 threads form a 16 x 16
// grid: thread (ty, tx) owns query rows ty + 16 i (i < 4), and in the
// score tile key columns tx + 16 c (c < 4), in the output value dims
// tx*4 + {0..3} and 64 + tx*4 + {0..3}.  A row's 16 owners sit in one
// half-warp, so its max and sum are warp shuffles, and the running max,
// denominator and the 4 x 8 accumulator stay in registers.  Q and K tiles
// live in shared memory as f32 rows padded to 128 dims with a stride of
// 132 floats, which keeps the float4 reads of 16 different rows free of
// bank conflicts; the probability tile reuses the K tile's space once the
// scores are done.  The q tiles are issued last-first.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for a shape it
// does not take.  dtype 0 = float32, 1 = bfloat16; q, k, v and out share
// it and are contiguous; S and T must be multiples of the dtype's tiles
// (repro_flash_block_q/_k; the wrapper pads); window < 0 means no sliding
// window.  lse, when not null (bf16 only), receives each row's
// log-sum-exp, (B, Hq, S) f32, which the backward kernel
// (flash_attention_bwd.cu) reads; a null lse runs the forward alone, and
// the output is the same bit for bit either way.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "tensor_map.cuh"

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

// Stage kBK rows of D elements (row stride D in device memory) as f32 rows
// of kDP floats, `ld` apart, zero past D.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int D) {
  for (int e = threadIdx.x; e < kBK * kDP; e += kThreads) {
    const int r = e / kDP, d = e % kDP;
    dst[r * ld + d] = d < D ? src[(size_t)r * D + d] : 0.f;
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

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Hq, int Hkv,
                 int S, int T_, int D, int t_valid, int q_offset, int causal, int window,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (kBQ, kLD)
  float* ks = qs + kBQ * kLD;       // (kBK, kLD); then P, (kBQ, kLDP)
  float* vs = ks + kBK * kLD;       // (kBK, kDP)
  float* ps = ks;

  const int qi = gridDim.x - 1 - blockIdx.x;   // longest causal loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const float* qb = q + (((size_t)b * Hq + h) * S + (size_t)qi * kBQ) * D;
  const float* kb = k + ((size_t)b * Hkv + hk) * (size_t)T_ * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * (size_t)T_ * D;
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

  float* ob = out + (((size_t)b * Hq + h) * S + (size_t)qi * kBQ) * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const float denom = l[i] == 0.f ? 1.f : l[i];     // fully masked rows -> 0
    const int r = ty + 16 * i;
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int d = (u < 4 ? 0 : 64) + tx * 4 + (u % 4);
      if (d < D) ob[(size_t)r * D + d] = o[i][u] / denom;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
               int S, int T_, int D, int t_valid, int q_offset, int causal, int window,
               float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / kBQ, Hq, B);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Hq, Hkv, S, T_, D, t_valid, q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

// -- bf16 body: wgmma and TMA ------------------------------------------------

constexpr int kWG = 2;                        // consumer warpgroups per block
constexpr int kBQ16 = kWG * attn_tile::kRows;  // query rows per block
constexpr int kStages = 3;                    // K/V stages in the ring
constexpr int kThreads16 = kWG * attn_tile::kWarpgroup + 32;
constexpr size_t kSmem16 = 1024 +             // slack to align the tiles to 1024 B
                           (size_t)attn_tile::kTileBytes * (kWG + 2 * kStages) +
                           sizeof(uint64_t) * (2 * kStages + 3);

// The log-sum-exp of rows ra (dst[0]) and ra + 8 (dst[8]) in natural units
// of the scaled scores, (m + log2 l) ln 2, for the backward; -inf for a
// row with no valid column.  Every thread of the warpgroup calls it (the
// quad sums shuffle).
__device__ __forceinline__ void store_lse(const attn_tile::Softmax& st, float* dst) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = attn_tile::quad_sum(st.l[r]);
    if (threadIdx.x % 4 == 0)
      dst[8 * r] = l == 0.f ? -INFINITY : (st.m[r] + log2f(l)) * 0.6931471805599453f;
  }
}

__global__ void __launch_bounds__(kThreads16, 1)
flash_fwd_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Hq, int Hkv, int S, int T_, int D,
                      int t_valid, int q_offset, int causal, int window, float scale_log2) {
  using namespace attn_tile;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                                   // kWG Q tiles
  uint8_t* kv = qs + kWG * kTileBytes;                  // stage i: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(kv + 2 * kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  uint64_t* turn = qbar + 1;                            // ping-pong of the warpgroups

  const int h = blockIdx.x;                             // q heads of a KV head adjacent
  const int qi = gridDim.y - 1 - blockIdx.y;            // longest causal loops first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  // live key tiles [j0, j1) of the block's 128 rows
  const int first_row = qi * kBQ16 + q_offset;
  const int last_row = first_row + kBQ16 - 1;
  int hi_col = t_valid - 1;
  if (causal) hi_col = min(hi_col, last_row);
  const int lo_col = window >= 0 ? max(0, first_row - window + 1) : 0;
  const int j0 = lo_col / kKeys;
  const int j1 = hi_col < 0 ? 0 : min(T_ / kKeys, hi_col / kKeys + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWG * 4);                    // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init(&turn[0], kWarpgroup);                    // every thread of the other arrives
    mbar_init(&turn[1], kWarpgroup);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kWG * 4) {
    // producer: one thread issues every copy
    if (lane != 0) return;
    const int q_row = (b * Hq + h) * S + qi * kBQ16;
    mbar_arrive_expect_tx(qbar, kWG * kTileBytes);
    for (int w = 0; w < kWG; ++w)
      for (int half = 0; half < 2; ++half)
        tma_load_2d(qs + w * kTileBytes + half * kHalfBytes, &tq, qbar, half * 64,
                    q_row + w * kRows);
    const int kv_row = (b * Hkv + hk) * T_;
    for (int j = j0, it = 0; j < j1; ++j, ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[st], 2 * kTileBytes);
      uint8_t* ks = kv + 2 * st * kTileBytes;
      for (int half = 0; half < 2; ++half) {
        tma_load_2d(ks + half * kHalfBytes, &tk, &full[st], half * 64, kv_row + j * kKeys);
        tma_load_2d(ks + kTileBytes + half * kHalfBytes, &tv, &full[st], half * 64,
                    kv_row + j * kKeys);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows wg * 64 .. wg * 64 + 63 of the block
  const int wg = warp / 4;
  const int ra = 16 * (warp % 4) + lane / 4;            // this thread's rows ra, ra + 8
  const int fr = first_row + wg * kRows, lr = fr + kRows - 1;
  const int pos[2] = {fr + ra, fr + ra + 8};
  const uint32_t q_smem = smem_u32(qs + wg * kTileBytes);
  float o[64];
  Softmax state;
  init_state(o, state);
  mbar_wait(qbar, 0);
  // both warpgroups walk the block's tiles, alternating their wgmma
  // issues; a tile that one of them masks whole gives it p = 0
  Turns turns{turn, wg};
  attend<kStages>(
      o, state, q_smem, kv, full, empty, j0, j1, scale_log2, turns,
      [&](int j) {          // valid whole for the warpgroup's rows
        const int col0 = j * kKeys, col1 = col0 + kKeys - 1;
        return (col1 < t_valid) & (!causal | (col1 <= fr)) & ((window < 0) | (col0 > lr - window));
      },
      [&](int slot, int col) {
        const int row = pos[slot];
        return (col < t_valid) & (!causal | (col <= row)) & ((window < 0) | (col > row - window));
      });
  __nv_bfloat16* ob = out + (((size_t)b * Hq + h) * S + (size_t)qi * kBQ16 + wg * kRows) * D;
  store_rows(o, state, D, [&](int slot) { return ob + (size_t)(ra + 8 * slot) * D; });
  if (lse != nullptr)
    store_lse(state, lse + ((size_t)b * Hq + h) * S + (size_t)qi * kBQ16 + wg * kRows + ra);
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                int Hq, int Hkv, int S, int T_, int D, int t_valid, int q_offset, int causal,
                int window, float scale, cudaStream_t stream) {
  if (D % 8 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  using attn_tile::tensor_map;
  if (!tensor_map(&tq, q, (size_t)B * Hq * S, D) || !tensor_map(&tk, k, (size_t)B * Hkv * T_, D) ||
      !tensor_map(&tv, v, (size_t)B * Hkv * T_, D))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem16);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, S / kBQ16, B);
  flash_fwd_kernel_bf16<<<grid, kThreads16, kSmem16, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Hq, Hkv, S, T_,
      D, t_valid, q_offset, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of a q tile and keys of a k tile for a dtype (0 = float32,
// 1 = bfloat16): S and T must be multiples.
int repro_flash_block_q(int dtype) { return dtype == 1 ? kBQ16 : kBQ; }
int repro_flash_block_k(int dtype) { return dtype == 1 ? attn_tile::kKeys : kBK; }
int repro_flash_max_head_dim(void) { return kDP; }

int repro_flash_attention(const void* q, const void* k, const void* v, void* out, void* lse,
                          int B, int Hq, int Hkv, int S, int T, int D, int t_valid,
                          int q_offset, int causal, int window, float scale, int dtype,
                          void* stream) {
  if ((dtype != 0 && dtype != 1) || (dtype == 0 && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  const int bq = repro_flash_block_q(dtype), bk = repro_flash_block_k(dtype);
  if (B < 1 || Hkv < 1 || Hq % Hkv || D < 1 || D > kDP || S < bq || S % bq || T < bk || T % bk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, Hq, Hkv, S, T, D, t_valid, q_offset, causal, window,
                      scale, s);
  return launch_bf16(q, k, v, out, lse, B, Hq, Hkv, S, T, D, t_valid, q_offset, causal,
                     window, scale, s);
}

}  // extern "C"
