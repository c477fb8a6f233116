// Paged attention for NVIDIA Hopper (sm_90a): decode and chunked prefill.
//
// Replaces the two TPU kernels of src/repro/kernels/paged_attention.py:
//   * paged_decode_kernel  <- paged_attention_pallas (_pa_kernel and the
//     two-phase _pa_kernel_quantized body);
//   * paged_prefill_kernel (f32) and paged_prefill_kernel_bf16 (bf16)
//     <- paged_prefill_attention_pallas (_pa_prefill_kernel).
//
// Both read one layer of the paged KV pool, (N, Hkv, bs, D), through a
// per-sequence block table (B, nb) of page ids, so no linearised (B, T, D)
// copy of the cache is ever written to device memory.  Pages that the
// causal frontier or the sliding window rules out are never read.  The TPU
// walked pages on a sequential grid axis with the online-softmax state
// carried in scratch between grid steps; here a block loops over the pages
// itself and reads its block-table row and length or base itself (the
// TPU's scalar prefetch).
//
// What bounds them on the H100: the bytes of K/V read.  Decode does 2*D
// flops per K/V element it reads (about one flop per byte in bf16), far
// below the card's ~295 flop/byte balance; prefill at C=128 rows per KV
// head reaches ~G*C flops per byte, still short of it at these sizes, and
// at the main path's size (one 128-token chunk, 64 blocks) launch latency
// and the first page loads dominate.  So each live page is read once per
// block and serves as many query rows as the block holds.
//
// Prefill, bf16 body (paged_prefill_kernel_bf16): the G*C query rows of a
// KV head are flattened as the Pallas kernel flattens them (row r is head
// r / C at position base + r % C) and cut into 64-row tiles, so every page
// staged once serves 64 rows (the f32 body: 16).  One consumer warpgroup
// runs attention_tile.cuh's stage loop (wgmma for Q K^T and for P V with P
// split into bf16 P_hi + P_lo, f32 online softmax in registers; see there
// why P is split), and one producer warp fills a 3-stage ring of 64-key
// K/V stages by cp.async, 16 bytes a lane, straight into the 128-byte
// swizzle that wgmma reads: key t of stage j comes from page
// bt[(64 j + t) / bs], so any bs works, and keys past the table and dims
// past D are zero-filled.  A stage is signalled through an mbarrier once
// its copies have landed (cp.async.wait_group, then fence.proxy.async for
// the tensor cores' async proxy), overlapped with the previous stage's
// products.  D must be a multiple of 8 and at most 128 (the wrapper pads).
//
// Decode, and the f32 prefill body, run on CUDA cores: the block stages a
// page in shared memory, converted to f32, and every query row of the
// block (decode: the G heads of a KV head; f32 prefill: a tile of 16 of
// the G*C rows) scores against it there, with the running max,
// denominator and accumulator in shared memory.  The tensor cores have no
// f32 product.  Left for later work on decode: cp.async/TMA page loads
// overlapped with the previous page's math, split-K over pages for small
// batches (B*Hkv blocks fill only part of the 132 SMs at batch 4).
//
// Numerics follow the Pallas bodies: f32 scores, softmax and accumulators;
// a masked column gets -inf; a row with no valid column yields 0.  With
// `quant` set, decode runs the two-phase body of _pa_kernel_quantized:
// pass 0 computes the final max and denominator, pass 1 re-scores each page
// and accumulates bf16(p) * bf16(v), which reproduces the gather path's
// roundings (K/V read as bf16, probabilities cast to bf16 before the value
// product) and keeps greedy decoding token-exact with it.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for a shape it
// does not take.  dtype 0 = float32, 1 = bfloat16; q, the pools and the
// output share that dtype; tables, lengths and bases are int32; window < 0
// means no sliding window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;           // prefill query rows per block
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round-to-nearest-even through bf16, as jnp's astype(bfloat16) rounds
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage one (bs, D) page of one KV head in shared memory as f32, rows
// `ld` floats apart (ld = D + 1 for K breaks the bank conflicts of the
// row-per-thread score loop).
template <typename T>
__device__ __forceinline__ void load_page(float* dst, int ld, const T* __restrict__ src,
                                          int bs, int D, bool quant) {
  const int n = bs * D;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float x = to_f32(src[e]);
    if (quant) x = round_bf16(x);
    dst[(e / D) * ld + (e % D)] = x;
  }
}

// One online-softmax step for `rows` rows over a (rows, bs) score tile:
// scores become probabilities in place, alpha[r] rescales the old state.
__device__ __forceinline__ void online_update(float* s, float* m, float* l, float* alpha,
                                              int rows, int bs) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* sr = s + r * bs;
    const float m_prev = m[r];
    float mx = m_prev;
    for (int t = 0; t < bs; ++t) mx = fmaxf(mx, sr[t]);
    const float a = (m_prev == -INFINITY) ? 0.f : expf(m_prev - mx);
    float sum = 0.f;
    for (int t = 0; t < bs; ++t) {
      const float p = (mx == -INFINITY) ? 0.f : expf(sr[t] - mx);
      sr[t] = p;
      sum += p;
    }
    l[r] = l[r] * a + sum;
    m[r] = mx;
    alpha[r] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ bt,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int Hkv, int G, int D, int bs, int nb, int window, float scale,
                    int quant) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int ldk = D + 1;
  float* qs = smem;                 // (G, D)
  float* ks = qs + G * D;           // (bs, D + 1)
  float* vs = ks + bs * ldk;        // (bs, D)
  float* ss = vs + bs * D;          // (G, bs) scores, then probabilities
  float* acc = ss + G * bs;         // (G, D)
  float* m = acc + G * D;           // (G,)
  float* l = m + G;                 // (G,)
  float* alpha = l + G;             // (G,)

  const int length = lengths[b];
  const size_t head = (size_t)b * Hkv + h;      // q is (B, Hkv, G, D) in memory
  const T* qb = q + head * G * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    qs[e] = to_f32(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  __syncthreads();

  const int passes = quant ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool values = !quant || pass == 1;
    for (int j = 0; j < nb; ++j) {
      const int start = j * bs;
      // block sparsity: skip pages past the causal frontier or wholly
      // before the window (uniform across the block)
      if (start > length) break;
      if (window >= 0 && start + bs - 1 <= length - window) continue;
      const size_t page = (size_t)bt[(size_t)b * nb + j];
      const size_t off = (page * Hkv + h) * (size_t)bs * D;
      load_page(ks, ldk, k_pool + off, bs, D, quant);
      if (values) load_page(vs, D, v_pool + off, bs, D, quant);
      __syncthreads();
      for (int e = threadIdx.x; e < G * bs; e += blockDim.x) {
        const int g = e / bs, t = e % bs;
        const float* qr = qs + g * D;
        const float* kr = ks + t * ldk;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        const int col = start + t;
        const bool ok = col <= length && (window < 0 || col > length - window);
        ss[e] = ok ? s * scale : -INFINITY;
      }
      __syncthreads();
      if (!quant) {
        online_update(ss, m, l, alpha, G, bs);
      } else if (pass == 0) {
        online_update(ss, m, l, alpha, G, bs);     // final stats only
      } else {
        // re-score against the FINAL stats: p = bf16(exp(s - m) / l)
        for (int e = threadIdx.x; e < G * bs; e += blockDim.x) {
          const int g = e / bs;
          const float lg = l[g] == 0.f ? 1.f : l[g];
          const float p = (m[g] == -INFINITY) ? 0.f : expf(ss[e] - m[g]) / lg;
          ss[e] = round_bf16(p);
        }
      }
      __syncthreads();
      if (values) {
        for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
          const int g = e / D, d = e % D;
          const float* pr = ss + g * bs;
          float s = 0.f;
          for (int t = 0; t < bs; ++t) s = fmaf(pr[t], vs[t * D + d], s);
          acc[e] = quant ? acc[e] + s : acc[e] * alpha[g] + s;
        }
      }
      __syncthreads();
    }
  }

  T* ob = out + head * G * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    float val = acc[e];
    if (!quant) {
      const float lg = l[e / D];
      val /= (lg == 0.f ? 1.f : lg);      // fully masked rows -> 0
    }
    ob[e] = from_f32<T>(val);
  }
}

__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                     const float* __restrict__ v_pool, const int* __restrict__ bt,
                     const int* __restrict__ base_arr, int chunk_len,
                     float* __restrict__ out, int Hkv, int GC, int C, int D, int bs, int nb,
                     int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, GC - r0);
  const int ldk = D + 1;
  float* qs = smem;                 // (kRows, D)
  float* ks = qs + kRows * D;       // (bs, D + 1)
  float* vs = ks + bs * ldk;        // (bs, D)
  float* ss = vs + bs * D;          // (kRows, bs)
  float* acc = ss + kRows * bs;     // (kRows, D)
  float* m = acc + kRows * D;       // (kRows,)
  float* l = m + kRows;
  float* alpha = l + kRows;

  const int base = base_arr[b];
  const int limit = base + chunk_len;   // valid columns are < limit
  // row r of the flattened (G, C) tile of this KV head is chunk query r % C
  const size_t head = (size_t)b * Hkv + h;
  const float* qb = q + (head * GC + r0) * D;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    qs[e] = to_f32(qb[e]);
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  // the tile's lowest and highest query position bound the live pages
  int lo = INT32_MAX, hi = INT32_MIN;
  for (int r = 0; r < rows; ++r) {
    const int pos = base + (r0 + r) % C;
    lo = min(lo, pos);
    hi = max(hi, pos);
  }
  const int last_col = min(hi, limit - 1);
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const int start = j * bs;
    if (start > last_col) break;
    if (window >= 0 && start + bs - 1 <= lo - window) continue;
    const size_t page = (size_t)bt[(size_t)b * nb + j];
    const size_t off = (page * Hkv + h) * (size_t)bs * D;
    load_page(ks, ldk, k_pool + off, bs, D, false);
    load_page(vs, D, v_pool + off, bs, D, false);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * bs; e += blockDim.x) {
      const int r = e / bs, t = e % bs;
      const float* qr = qs + r * D;
      const float* kr = ks + t * ldk;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int col = start + t;
      const int pos = base + (r0 + r) % C;
      const bool ok = col <= pos && col < limit && (window < 0 || col > pos - window);
      ss[e] = ok ? s * scale : -INFINITY;
    }
    __syncthreads();
    online_update(ss, m, l, alpha, rows, bs);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
      const int r = e / D, d = e % D;
      const float* pr = ss + r * bs;
      float s = 0.f;
      for (int t = 0; t < bs; ++t) s = fmaf(pr[t], vs[t * D + d], s);
      acc[e] = acc[e] * alpha[r] + s;
    }
    __syncthreads();
  }

  float* ob = out + (head * GC + r0) * D;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const float lg = l[e / D];
    ob[e] = acc[e] / (lg == 0.f ? 1.f : lg);
  }
}

// -- prefill, bf16 body: wgmma and cp.async ---------------------------------

constexpr int kPStages = 3;                   // K/V stages in the ring
constexpr int kPThreads = attn_tile::kWarpgroup + 32;
constexpr size_t kPSmem = 1024 + (size_t)attn_tile::kTileBytes * (1 + 2 * kPStages) +
                          sizeof(uint64_t) * (2 * kPStages + 1);

// One block: 64 of the G*C flattened query rows of one (sequence, KV head)
// (row r is q head h*G + r / C at position base + r % C, the layout of q in
// memory), one consumer warpgroup and one producer warp.  A stage is 64
// keys of the sequence's block-table row: key t of stage j lies in page
// bt[(64 j + t) / bs] at row (64 j + t) % bs, a (bs, D) slab at
// (page * Hkv + h) * bs * D of the pool.  Keys past the table and dims
// past D are zero-filled.
__global__ void __launch_bounds__(kPThreads, 1)
paged_prefill_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_pool,
                          const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ bt,
                          const int* __restrict__ base_arr, int chunk_len,
                          __nv_bfloat16* __restrict__ out, int Hkv, int GC, int C, int D, int bs,
                          int nb, int window, float scale_log2) {
  using namespace attn_tile;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* kv = qs + kTileBytes;                        // stage i: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(kv + 2 * kPStages * kTileBytes);
  uint64_t* empty = full + kPStages;
  uint64_t* qbar = empty + kPStages;

  const int r0 = blockIdx.x * attn_tile::kRows, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(attn_tile::kRows, GC - r0);
  const int base = base_arr[b];
  const int limit = base + chunk_len;                   // valid columns are < limit
  // the tile's lowest and highest query position bound its live stages
  const int ra_last = r0 + rows - 1;
  const bool one_head = r0 / C == ra_last / C;
  const int lo = one_head ? base + r0 % C : base;
  const int hi = one_head ? base + ra_last % C : base + C - 1;
  const int last_col = min(hi, limit - 1);
  const int j0 = window >= 0 ? max(0, lo - window + 1) / kKeys : 0;
  const int j1 = last_col < 0 ? 0 : min(last_col / kKeys + 1, (nb * bs + kKeys - 1) / kKeys);
  const size_t head = (size_t)b * Hkv + h;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kPStages; ++i) {
      mbar_init(&full[i], 32);                          // every producer lane arrives
      mbar_init(&empty[i], 4);                          // one arrival per consumer warp
    }
    mbar_init(qbar, 32);
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: lane copies 16-byte chunk c of rows lane / 16 + 2 i; a
    // stage is signalled once its copies have landed and are fenced for
    // the consumers' wgmma (async proxy)
    const int c = lane % 16, rsub = lane / 16;
    const bool dim_ok = c * 8 < D;
    for (int i = 0; i < attn_tile::kRows / 2; ++i) {
      const int r = rsub + 2 * i;
      const bool ok = dim_ok && r < rows;
      cp_async_16(qs + swizzled(r, c), ok ? q + (head * GC + r0 + r) * D + c * 8 : q, ok);
    }
    cp_async_commit();
    // the last committed group is signalled once the next one is issued,
    // or before the producer blocks on a free stage (the consumers hold a
    // stage until the next one's scores are done)
    uint64_t* pending = qbar;
    const int* row_bt = bt + (size_t)b * nb;
    for (int j = j0, it = 0; j < j1; ++j, ++it) {
      const int st = it % kPStages;
      if (it >= kPStages) {
        if (pending != nullptr) {
          cp_async_wait<0>();
          fence_proxy_async();
          mbar_arrive(pending);
          pending = nullptr;
        }
        mbar_wait(&empty[st], ((it / kPStages) & 1) ^ 1);
      }
      uint8_t* ks = kv + 2 * st * kTileBytes;
      for (int i = 0; i < kKeys / 2; ++i) {
        const int t = rsub + 2 * i, key = j * kKeys + t, page = key / bs;
        const bool ok = dim_ok && page < nb;
        const size_t off =
            ok ? (((size_t)row_bt[page] * Hkv + h) * bs + key % bs) * D + c * 8 : 0;
        cp_async_16(ks + swizzled(t, c), k_pool + off, ok);
        cp_async_16(ks + kTileBytes + swizzled(t, c), v_pool + off, ok);
      }
      cp_async_commit();
      if (pending != nullptr) {
        cp_async_wait<1>();                             // the previous group has landed
        fence_proxy_async();
        mbar_arrive(pending);
      }
      pending = &full[st];
    }
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(pending);
    return;
  }

  const int ra = 16 * warp + lane / 4;                  // this thread's rows ra, ra + 8
  const int pos[2] = {base + (r0 + ra) % C, base + (r0 + ra + 8) % C};
  const uint32_t q_smem = smem_u32(qs);
  float o[64];
  Softmax state;
  init_state(o, state);
  mbar_wait(qbar, 0);
  NoTurns turn;
  attend<kPStages>(
      o, state, q_smem, kv, full, empty, j0, j1, scale_log2, turn,
      [&](int j) {                    // valid whole for every row of the tile
        const int col0 = j * kKeys, col1 = col0 + kKeys - 1;
        return (col1 <= lo) & (col1 < limit) & ((window < 0) | (col0 > hi - window));
      },
      [&](int slot, int col) {
        const int p = pos[slot];
        return (col <= p) & (col < limit) & ((window < 0) | (col > p - window));
      });
  __nv_bfloat16* ob = out + (head * GC + r0) * D;
  store_rows(o, state, D, [&](int slot) -> __nv_bfloat16* {
    const int r = ra + 8 * slot;
    return r < rows ? ob + (size_t)r * D : nullptr;
  });
}

size_t decode_smem_bytes(int G, int D, int bs) {
  return sizeof(float) * ((size_t)G * D * 2 + (size_t)bs * (2 * D + 1) + (size_t)G * bs + 3 * G);
}

size_t prefill_smem_bytes(int D, int bs, int dtype) {
  if (dtype == 1) return kPSmem;
  return sizeof(float) * ((size_t)kRows * D * 2 + (size_t)bs * (2 * D + 1) +
                          (size_t)kRows * bs + 3 * kRows);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_decode(const void* q, const void* k_pool, const void* v_pool, const void* bt,
                  const void* lengths, void* out, int B, int Hkv, int G, int D, int bs,
                  int nb, int window, float scale, int quant, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(G, D, bs);
  cudaError_t err = allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(bt), static_cast<const int*>(lengths), static_cast<T*>(out),
      Hkv, G, D, bs, nb, window, scale, quant);
  return (int)cudaGetLastError();
}

int launch_prefill_f32(const void* q, const void* k_pool, const void* v_pool, const void* bt,
                       const void* base, int chunk_len, void* out, int B, int Hkv, int G, int C,
                       int D, int bs, int nb, int window, float scale, cudaStream_t stream) {
  const size_t smem = prefill_smem_bytes(D, bs, 0);
  cudaError_t err = allow_smem(paged_prefill_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int GC = G * C;
  dim3 grid(B, Hkv, (GC + kRows - 1) / kRows);
  paged_prefill_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool),
      static_cast<const int*>(bt), static_cast<const int*>(base), chunk_len,
      static_cast<float*>(out), Hkv, GC, C, D, bs, nb, window, scale);
  return (int)cudaGetLastError();
}

int launch_prefill_bf16(const void* q, const void* k_pool, const void* v_pool, const void* bt,
                        const void* base, int chunk_len, void* out, int B, int Hkv, int G,
                        int C, int D, int bs, int nb, int window, float scale,
                        cudaStream_t stream) {
  if (D % 8 || D > attn_tile::kDP ||
      ((uintptr_t)q | (uintptr_t)k_pool | (uintptr_t)v_pool) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(paged_prefill_kernel_bf16, kPSmem);
  if (err != cudaSuccess) return (int)err;
  const int GC = G * C;
  dim3 grid((GC + attn_tile::kRows - 1) / attn_tile::kRows, Hkv, B);
  paged_prefill_kernel_bf16<<<grid, kPThreads, kPSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(bt),
      static_cast<const int*>(base), chunk_len, static_cast<__nv_bfloat16*>(out), Hkv, GC, C,
      D, bs, nb, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a launch needs, so the wrapper can refuse shapes
// the card cannot hold before launching.
size_t repro_paged_decode_smem(int G, int D, int bs) { return decode_smem_bytes(G, D, bs); }
size_t repro_paged_prefill_smem(int D, int bs, int dtype) {
  return prefill_smem_bytes(D, bs, dtype);
}

int repro_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                 const void* bt, const void* lengths, void* out, int B,
                                 int Hkv, int G, int D, int bs, int nb, int window,
                                 float scale, int dtype, int quant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(q, k_pool, v_pool, bt, lengths, out, B, Hkv, G, D, bs, nb,
                                window, scale, quant, s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k_pool, v_pool, bt, lengths, out, B, Hkv, G, D,
                                        bs, nb, window, scale, quant, s);
  return (int)cudaErrorInvalidValue;
}

int repro_paged_prefill_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* bt, const void* base, int chunk_len, void* out,
                                  int B, int Hkv, int G, int C, int D, int bs, int nb,
                                  int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_prefill_f32(q, k_pool, v_pool, bt, base, chunk_len, out, B, Hkv, G, C,
                                 D, bs, nb, window, scale, s);
  if (dtype == 1)
    return launch_prefill_bf16(q, k_pool, v_pool, bt, base, chunk_len, out, B, Hkv, G, C, D,
                               bs, nb, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
