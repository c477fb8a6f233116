// Flash attention (backward) for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its flash forward
// through the plain chunked attention (src/repro/models/layers.py,
// _flash_cvjp_bwd), and so did the port, which on the card recomputed every
// (row, column) score in f32 and took autograd's VJP of it.  This computes
// the same gradients from the forward's saved output and log-sum-exp
// (flash_attention.cu's bf16 body, its lse pointer), never holding a score
// matrix in device memory: for q (B, Hq, S, D), k/v (B, Hkv, T, D), the
// output o and its gradient g (dO below), with the forward's masks
// (causal, window, key padding at t_valid, query row s at position
// s + q_offset) and grouped-query heads,
//   P  = exp(Q K^T * scale - lse)      f32 registers, 0 where masked
//   dP = dO V^T
//   dS = P (dP - Di),  Di = rowsum(dO o)  (f32, a pre-pass)
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K
// with f32 sums; P is rounded to bf16 before P^T dO (as the chunked
// reference rounds it before P V) and dS to bf16 before its two products,
// the one rounding the reference does not make.
//
// What bounds it on the H100: operations.  Per (row, live column) it does
// the forward's two products again and three more, ~10*D flops, on tiles
// it stages once per block pair, far above the card's ~295 flop/byte
// balance.
//
// Three kernels, launched in turn on the caller's stream:
//   flash_bwd_dot_kernel    Di for every row, one warp a row;
//   flash_bwd_dkdv_kernel   one block per (batch, kv head, 128 keys): two
//                           consumer warpgroups of 64 keys each hold their
//                           K and V tiles in shared memory and dK, dV in
//                           registers, and walk the q tiles of every query
//                           head of the group that the mask keeps; S^T =
//                           K Q^T and dP^T = V dO^T put the keys on the
//                           wgmma's M side, so P^T and dS^T are A operands
//                           straight from the accumulator registers (the
//                           forward's P V trick), and the group's heads sum
//                           into dK, dV without atomics;
//   flash_bwd_dq_kernel     one block per (batch, q head, 128 rows), the
//                           forward's layout: two warpgroups of 64 rows
//                           recompute S and dP against each live K/V tile
//                           and add dS K into dQ in registers.
// dQ is thus a second, q-parallel pass (three products recomputed) instead
// of f32 atomics into a scratch: seven products per (row, column) where
// atomics would take five, but no read-modify-write traffic and the same
// result on every run.  A producer warp in each kernel brings the streamed
// tiles by TMA into a ring of mbarrier-signalled stages (Q, dO and the
// rows' lse and Di for dK/dV; K, V for dQ), as in the forward, in the
// 128-byte swizzle that attention_tile.cuh's wgmma descriptors read.
// Tiles that the masks drop whole are never loaded; partly masked tiles
// take the masked body, whole ones the unmasked one, chosen before the
// products are issued so that no branch lies between a wgmma and its wait.
// The head dim is a template parameter: 64 (one 64-dim half a tile, the
// recurrent families' heads) or 128 (D = 65..128, dims past D zero-filled
// by TMA); the wrapper picks it from D.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after the launches, 0 on success, or cudaErrorInvalidValue for a shape it
// does not take.  Everything is bf16 except lse and the Di scratch (f32,
// (B, Hq, S)), contiguous, starting on 16-byte boundaries; S a multiple of
// repro_flash_bwd_block_q, T of repro_flash_bwd_block_k, D a multiple of 8
// and at most the chosen head tile (0: 64, 1: 128); window < 0 means none.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "tensor_map.cuh"

namespace {

using namespace attn_tile;

constexpr int kWG = 2;                          // consumer warpgroups per block
constexpr int kThreads = kWG * kWarpgroup + 32;  // and one producer warp
constexpr int kBlockQ = kWG * kRows;            // rows of a dQ block
constexpr int kBlockK = kWG * kKeys;            // keys of a dK/dV block
constexpr int kStagesKV = 2;                    // (Q, dO) stages of a dK/dV block
constexpr int kStagesQ = 3;                     // (K, V) stages of a dQ block
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>
struct Tile {
  static constexpr int kBytes = (kD / 64) * kHalfBytes;   // 64 rows x kD dims
};

template <int kD>
constexpr size_t smem_dkdv() {
  return 1024 + (size_t)Tile<kD>::kBytes * 2 * (kWG + kStagesKV) +
         sizeof(float) * 2 * kRows * kStagesKV + sizeof(uint64_t) * (2 * kStagesKV + 1);
}

template <int kD>
constexpr size_t smem_dq() {
  return 1024 + (size_t)Tile<kD>::kBytes * 2 * (kWG + kStagesQ) +
         sizeof(uint64_t) * (2 * kStagesQ + 1);
}

// 1-D bulk copy of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_m64n64k16_rs(d, a, b);
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_m64n128k16_rs(d, a, b);
}

// S (64 x 64) = A B^T over kD dims: A and B are 64-row tiles, both K-major;
// issued, not waited for
template <int kD>
__device__ __forceinline__ void issue_nt(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
    wgmma_m64n64k16_ss(s, desc_k_major(a + off), desc_k_major(b + off), kk > 0);
  }
}

// acc (64 x kD) += A (64 x 64, bf16 fragments in registers) B, where B is a
// 64-row tile read MN-major (its rows are the product's depth); issued,
// not waited for
template <int kD>
__device__ __forceinline__ void issue_nn(float (&acc)[kD / 2], const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(acc, a[kk], desc_mn_major(b + kk * 16 * 128));
}

// a 64 x 64 f32 accumulator fragment as four bf16 A fragments of 16 columns
// (the S fragment of columns 16 kk .. 16 kk + 15 is the A fragment's layout)
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// fence_registers for A fragments: they stay live (unmoved) until here
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

// the pair (row position, key position) is kept by the forward's masks
struct Mask {
  int t_valid, causal, window;
  __device__ __forceinline__ bool ok(int row, int col) const {
    return (col < t_valid) & (!causal | (col <= row)) & ((window < 0) | (col > row - window));
  }
  // every pair of rows r0 .. r0 + 63 and keys c0 .. c0 + 63 is kept
  __device__ __forceinline__ bool whole(int r0, int c0) const {
    const int c1 = c0 + 63;
    return (c1 < t_valid) & (!causal | (c1 <= r0)) & ((window < 0) | (c0 > r0 + 63 - window));
  }
};

// scale * acc rounded to bf16 into rows ra (slot 0) and ra + 8 (slot 1) of
// a 64 x kD tile; row_ptr(slot) is nullptr for a row not written, dims at
// or past D are not written
template <int kD, typename RowPtr>
__device__ __forceinline__ void store_tile(const float (&acc)[kD / 2], float scale, int D,
                                           RowPtr row_ptr) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* dst = row_ptr(r);
    if (dst == nullptr) continue;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      const int d = 8 * i + 2 * quad;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + d) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
    }
  }
}

// -- Di = rowsum(dO o) ---------------------------------------------------------

__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ g,
                     float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(o + (size_t)row * D);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(g + (size_t)row * D);
  float acc = 0.f;
  for (int d = lane; d < D / 2; d += 32) {
    const float2 a = __bfloat1622float2(o2[d]), b = __bfloat1622float2(g2[d]);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// -- dK, dV ------------------------------------------------------------------------
//
// Fragment of S^T (64 keys x 64 rows): thread t holds keys ra, ra + 8 and
// the tile's rows 8 i + 2 (t % 4) + (e & 1) in register 4 i + e (e >= 2:
// key ra + 8).  lse and Di of a stage's rows sit in shared memory.

template <int kD, bool kMasked>
__device__ __forceinline__ void dkdv_step(float (&dk)[kD / 2], float (&dv)[kD / 2],
                                          uint32_t k_s, uint32_t v_s, uint32_t q_s,
                                          uint32_t do_s, const float* lse, const float* dlt,
                                          float scale_log2, Mask mask, int key_a, int row0) {
  const int quad = threadIdx.x % 4;
  float s[32], dp[32];
  wgmma_fence();
  issue_nt<kD>(s, k_s, q_s);
  wgmma_commit();
  issue_nt<kD>(dp, v_s, do_s);
  wgmma_commit();
  wgmma_wait<1>();                  // S^T has landed; dP^T may still run
  fence_registers(s);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * i + 2 * quad + (e & 1);
      const float p = ex2(fmaf(s[4 * i + e], scale_log2, -lse[c] * kLog2e));
      s[4 * i + e] = kMasked ? (mask.ok(row0 + c, key_a + 8 * (e >> 1)) ? p : 0.f) : p;
    }
  uint32_t pa[4][4];
  pack_a(s, pa);
  wgmma_fence();
  issue_nn<kD>(dv, pa, do_s);       // dV += P^T dO
  wgmma_commit();
  wgmma_wait<1>();                  // dP^T has landed; dV may still run
  fence_registers(dp);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * i + 2 * quad + (e & 1);
      dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - dlt[c]);
    }
  uint32_t dsa[4][4];
  pack_a(dp, dsa);
  wgmma_fence();
  issue_nn<kD>(dk, dsa, q_s);       // dK += dS^T Q
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(dk);
  fence_registers(dv);
  fence_fragments(pa);
  fence_fragments(dsa);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int S, int T_, int D,
                      int t_valid, int q_offset, int causal, int window, float scale) {
  constexpr int kTile = Tile<kD>::kBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;                                   // kWG K tiles, then kWG V tiles
  uint8_t* ring = ks + 2 * kWG * kTile;                 // stage i: Q, then dO
  float* vecs = reinterpret_cast<float*>(ring + 2 * kStagesKV * kTile);   // lse, Di
  uint64_t* full = reinterpret_cast<uint64_t*>(vecs + 2 * kRows * kStagesKV);
  uint64_t* empty = full + kStagesKV;
  uint64_t* kvbar = empty + kStagesKV;

  const int hk = blockIdx.x, b = blockIdx.z;
  const int c0 = blockIdx.y * kBlockK;                  // the block's first key
  const int group = Hq / Hkv;
  const Mask mask{t_valid, causal, window};

  // q tiles [i0, i1) of 64 rows that see any of the block's keys
  int i0 = 0, i1 = 0;
  if (c0 < t_valid) {
    const int c_last = min(c0 + kBlockK, t_valid) - 1;
    const int r_lo = max(0, causal ? c0 - q_offset : 0);
    const int r_hi = min(S, window >= 0 ? c_last + window - q_offset : S);   // exclusive
    if (r_hi > r_lo) {
      i0 = r_lo / kRows;
      i1 = (r_hi + kRows - 1) / kRows;
    }
  }
  const int tiles = i1 - i0, n = group * tiles;        // stages: heads x q tiles

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStagesKV; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWG * 4);                    // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kWG * 4) {
    // producer: one thread issues every copy
    if (lane != 0) return;
    const int kv_row = (b * Hkv + hk) * T_ + c0;
    mbar_arrive_expect_tx(kvbar, 2 * kWG * kTile);
    for (int w = 0; w < kWG; ++w)
      for (int half = 0; half < kD / 64; ++half) {
        tma_load_2d(ks + w * kTile + half * kHalfBytes, &tk, kvbar, half * 64,
                    kv_row + w * kKeys);
        tma_load_2d(ks + (kWG + w) * kTile + half * kHalfBytes, &tv, kvbar, half * 64,
                    kv_row + w * kKeys);
      }
    for (int it = 0; it < n; ++it) {
      const int h = hk * group + it / tiles, i = i0 + it % tiles;
      const int st = it % kStagesKV;
      if (it >= kStagesKV) mbar_wait(&empty[st], ((it / kStagesKV) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[st], 2 * kTile + 2 * kRows * sizeof(float));
      const int q_row = (b * Hq + h) * S + i * kRows;
      uint8_t* qs = ring + 2 * st * kTile;
      for (int half = 0; half < kD / 64; ++half) {
        tma_load_2d(qs + half * kHalfBytes, &tq, &full[st], half * 64, q_row);
        tma_load_2d(qs + kTile + half * kHalfBytes, &tdo, &full[st], half * 64, q_row);
      }
      float* v = vecs + 2 * kRows * st;
      bulk_load(v, lse + q_row, kRows * sizeof(float), &full[st]);
      bulk_load(v + kRows, delta + q_row, kRows * sizeof(float), &full[st]);
    }
    return;
  }

  // consumer warpgroup wg: keys key0 .. key0 + 63 of the block
  const int wg = warp / 4;
  const int ra = 16 * (warp % 4) + lane / 4;            // this thread's keys ra, ra + 8
  const int key0 = c0 + wg * kKeys;
  const uint32_t k_s = smem_u32(ks + wg * kTile), v_s = smem_u32(ks + (kWG + wg) * kTile);
  const float scale_log2 = scale * kLog2e;
  float dka[kD / 2], dva[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kvbar, 0);
  for (int it = 0; it < n; ++it) {
    const int i = i0 + it % tiles, st = it % kStagesKV;
    mbar_wait(&full[st], (it / kStagesKV) & 1);
    __syncwarp();                   // converge after the barrier wait: wgmma is .aligned
    const uint32_t q_s = smem_u32(ring + 2 * st * kTile), do_s = q_s + kTile;
    const float* lse_s = vecs + 2 * kRows * st;
    const int row0 = i * kRows + q_offset;              // position of the tile's first row
    if (mask.whole(row0, key0))
      dkdv_step<kD, false>(dka, dva, k_s, v_s, q_s, do_s, lse_s, lse_s + kRows, scale_log2,
                           mask, key0 + ra, row0);
    else
      dkdv_step<kD, true>(dka, dva, k_s, v_s, q_s, do_s, lse_s, lse_s + kRows, scale_log2,
                          mask, key0 + ra, row0);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  const size_t base = ((size_t)b * Hkv + hk) * T_;
  auto row_of = [&](__nv_bfloat16* out, int r) -> __nv_bfloat16* {
    const int key = key0 + ra + 8 * r;
    return key < T_ ? out + (base + key) * D : nullptr;
  };
  store_tile<kD>(dka, scale, D, [&](int r) { return row_of(dk, r); });
  store_tile<kD>(dva, 1.f, D, [&](int r) { return row_of(dv, r); });
}

// -- dQ ------------------------------------------------------------------------------
//
// Fragment of S (64 rows x 64 keys): thread t holds rows ra, ra + 8 and the
// tile's keys 8 i + 2 (t % 4) + (e & 1) in register 4 i + e; each row's
// lse and Di sit in registers.

template <int kD, bool kMasked>
__device__ __forceinline__ void dq_step(float (&dq)[kD / 2], uint32_t q_s, uint32_t do_s,
                                        uint32_t k_s, uint32_t v_s, const float (&lse2)[2],
                                        const float (&dlt)[2], float scale_log2, Mask mask,
                                        const int (&pos)[2], int key0) {
  const int quad = threadIdx.x % 4;
  float s[32], dp[32];
  wgmma_fence();
  issue_nt<kD>(s, q_s, k_s);
  wgmma_commit();
  issue_nt<kD>(dp, do_s, v_s);
  wgmma_commit();
  wgmma_wait<1>();                  // S has landed; dP may still run
  fence_registers(s);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * i + e], scale_log2, -lse2[e >> 1]));
      s[4 * i + e] =
          kMasked ? (mask.ok(pos[e >> 1], key0 + 8 * i + 2 * quad + (e & 1)) ? p : 0.f) : p;
    }
  wgmma_wait<0>();
  fence_registers(dp);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - dlt[e >> 1]);
  uint32_t dsa[4][4];
  pack_a(dp, dsa);
  wgmma_fence();
  issue_nn<kD>(dq, dsa, k_s);       // dQ += dS K
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(dq);
  fence_fragments(dsa);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Hq,
                    int Hkv, int S, int T_, int D, int t_valid, int q_offset, int causal,
                    int window, float scale) {
  constexpr int kTile = Tile<kD>::kBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                                   // kWG Q tiles, then kWG dO tiles
  uint8_t* kv = qs + 2 * kWG * kTile;                   // stage i: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(kv + 2 * kStagesQ * kTile);
  uint64_t* empty = full + kStagesQ;
  uint64_t* qbar = empty + kStagesQ;

  const int h = blockIdx.x;                             // q heads of a KV head adjacent
  const int qi = gridDim.y - 1 - blockIdx.y;            // longest causal loops first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const Mask mask{t_valid, causal, window};

  // live key tiles [j0, j1) of the block's 128 rows: the forward's rule
  const int first_row = qi * kBlockQ + q_offset;
  const int last_row = first_row + kBlockQ - 1;
  int hi_col = t_valid - 1;
  if (causal) hi_col = min(hi_col, last_row);
  const int lo_col = window >= 0 ? max(0, first_row - window + 1) : 0;
  const int j0 = lo_col / kKeys;
  const int j1 = hi_col < 0 ? 0 : min(T_ / kKeys, hi_col / kKeys + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStagesQ; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWG * 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_row = (b * Hq + h) * S + qi * kBlockQ;
  if (warp == kWG * 4) {
    if (lane != 0) return;
    mbar_arrive_expect_tx(qbar, 2 * kWG * kTile);
    for (int w = 0; w < kWG; ++w)
      for (int half = 0; half < kD / 64; ++half) {
        tma_load_2d(qs + w * kTile + half * kHalfBytes, &tq, qbar, half * 64,
                    q_row + w * kRows);
        tma_load_2d(qs + (kWG + w) * kTile + half * kHalfBytes, &tdo, qbar, half * 64,
                    q_row + w * kRows);
      }
    const int kv_row = (b * Hkv + hk) * T_;
    for (int j = j0, it = 0; j < j1; ++j, ++it) {
      const int st = it % kStagesQ;
      if (it >= kStagesQ) mbar_wait(&empty[st], ((it / kStagesQ) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[st], 2 * kTile);
      uint8_t* ks = kv + 2 * st * kTile;
      for (int half = 0; half < kD / 64; ++half) {
        tma_load_2d(ks + half * kHalfBytes, &tk, &full[st], half * 64, kv_row + j * kKeys);
        tma_load_2d(ks + kTile + half * kHalfBytes, &tv, &full[st], half * 64,
                    kv_row + j * kKeys);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows wg * 64 .. wg * 64 + 63 of the block
  const int wg = warp / 4;
  const int ra = 16 * (warp % 4) + lane / 4;            // this thread's rows ra, ra + 8
  const int fr = first_row + wg * kRows;
  const int pos[2] = {fr + ra, fr + ra + 8};
  const size_t row_a = (size_t)q_row + wg * kRows + ra;
  const float lse2[2] = {lse[row_a] * kLog2e, lse[row_a + 8] * kLog2e};
  const float dlt[2] = {delta[row_a], delta[row_a + 8]};
  const uint32_t q_s = smem_u32(qs + wg * kTile), do_s = smem_u32(qs + (kWG + wg) * kTile);
  const float scale_log2 = scale * kLog2e;
  float dqa[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dqa[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int j = j0, it = 0; j < j1; ++j, ++it) {
    const int st = it % kStagesQ;
    mbar_wait(&full[st], (it / kStagesQ) & 1);
    __syncwarp();
    const uint32_t k_s = smem_u32(kv + 2 * st * kTile), v_s = k_s + kTile;
    if (mask.whole(fr, j * kKeys))
      dq_step<kD, false>(dqa, q_s, do_s, k_s, v_s, lse2, dlt, scale_log2, mask, pos,
                         j * kKeys);
    else
      dq_step<kD, true>(dqa, q_s, do_s, k_s, v_s, lse2, dlt, scale_log2, mask, pos,
                        j * kKeys);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  __nv_bfloat16* out = dq + row_a * D;
  store_tile<kD>(dqa, scale, D, [&](int r) { return out + (size_t)(8 * r) * D; });
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* g, void* dq, void* dk, void* dv, void* delta, int B, int Hq, int Hkv,
           int S, int T_, int D, int t_valid, int q_offset, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const size_t q_rows = (size_t)B * Hq * S, kv_rows = (size_t)B * Hkv * T_;
  if (!tensor_map(&tq, q, q_rows, D) || !tensor_map(&tk, k, kv_rows, D) ||
      !tensor_map(&tv, v, kv_rows, D) || !tensor_map(&tdo, g, q_rows, D))
    return (int)cudaErrorInvalidValue;
  constexpr size_t kSmemKV = smem_dkdv<kD>(), kSmemQ = smem_dq<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemKV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemQ);
  if (err != cudaSuccess) return (int)err;
  const int rows = (int)q_rows;
  float* dl = static_cast<float*>(delta);
  const float* ls = static_cast<const float*>(lse);
  flash_bwd_dot_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(g), dl, rows, D);
  flash_bwd_dkdv_kernel<kD><<<dim3(Hkv, (T_ + kBlockK - 1) / kBlockK, B), kThreads, kSmemKV,
                              stream>>>(
      tq, tk, tv, tdo, ls, dl, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Hq, Hkv, S, T_, D, t_valid, q_offset, causal, window,
      scale);
  flash_bwd_dq_kernel<kD><<<dim3(Hq, S / kBlockQ, B), kThreads, kSmemQ, stream>>>(
      tq, tk, tv, tdo, ls, dl, static_cast<__nv_bfloat16*>(dq), Hq, Hkv, S, T_, D, t_valid,
      q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of a q block and keys of a k block: S and T must be multiples.
int repro_flash_bwd_block_q(void) { return kBlockQ; }
int repro_flash_bwd_block_k(void) { return kKeys; }
// Head dim of instantiation `tile` (0 or 1), 0 for any other index.
int repro_flash_bwd_head_tile(int tile) { return tile == 0 ? 64 : tile == 1 ? 128 : 0; }

int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* g, void* dq, void* dk, void* dv,
                              void* delta, int B, int Hq, int Hkv, int S, int T, int D,
                              int t_valid, int q_offset, int causal, int window, float scale,
                              int tile, void* stream) {
  const int dims = repro_flash_bwd_head_tile(tile);
  if (B < 1 || Hkv < 1 || Hq % Hkv || D < 8 || D % 8 || D > dims || S < kBlockQ ||
      S % kBlockQ || T < kKeys || T % kKeys)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)g |
       (uintptr_t)lse | (uintptr_t)delta | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) %
      16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dims == 64)
    return launch<64>(q, k, v, o, lse, g, dq, dk, dv, delta, B, Hq, Hkv, S, T, D, t_valid,
                      q_offset, causal, window, scale, s);
  return launch<128>(q, k, v, o, lse, g, dq, dk, dv, delta, B, Hq, Hkv, S, T, D, t_valid,
                     q_offset, causal, window, scale, s);
}

}  // extern "C"
