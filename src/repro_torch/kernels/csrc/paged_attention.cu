// Paged attention for NVIDIA Hopper (sm_90a): decode and chunked prefill.
//
// Replaces the two TPU kernels of src/repro/kernels/paged_attention.py:
//   * paged_decode_split_kernel and paged_decode_combine_kernel
//     <- paged_attention_pallas (_pa_kernel and the two-phase
//     _pa_kernel_quantized body);
//   * paged_prefill_kernel (f32) and paged_prefill_kernel_bf16 (bf16)
//     <- paged_prefill_attention_pallas (_pa_prefill_kernel).
//
// Both read one layer of the paged KV pool, (N, Hkv, bs, D), through a
// per-sequence block table (B, nb) of page ids, so no linearised (B, T, D)
// copy of the cache is ever written to device memory.  Keys that the
// causal frontier or the sliding window rules out are never read.  The TPU
// walked pages on a sequential grid axis with the online-softmax state
// carried in scratch between grid steps; here a block loops over its keys
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
// Decode (split-K, "flash-decoding", on CUDA cores: at one flop per byte
// the tensor cores would not help).  The limit is bytes and parallelism:
// B * Hkv blocks, one per KV head, fill a quarter of the 132 SMs at batch
// 4.  So the key axis is cut into splits of kps keys (a multiple of bs;
// the wrapper's decode_split_plan picks it from the shapes alone, never
// from the lengths, which would cost a sync), and the grid is (splits,
// Hkv, B).  A split wholly past its sequence's length, or wholly before
// its window, writes the empty state (m = -inf, l = 0) and exits.  Inside
// a split the four warps take runs of 8 keys each; a run is copied by
// cp.async into a 3-stage ring of the warp's own, in the pool's dtype,
// straight from its pages, while the previous runs are scored; each K row
// is read once for all G query rows, and a score is a __shfl_xor reduction
// of the lanes' 4-dim partial products.  The online max, denominator and
// value accumulator live in registers; the warps merge in shared memory.
//   * Plain body, 2 launches: each split's (m, l, acc) into an f32
//     workspace (the wrapper allocates it), then a combine kernel that
//     merges each row's splits in split order and divides by l.
//   * read_dtype body (_pa_kernel_quantized), 3 launches: the stats pass
//     writes each split's (m, l); the value pass merges every split's stats
//     into the final (m, l), in one fixed order that every block repeats
//     exactly, re-scores its keys and sums bf16(exp(s - m) / l) * bf16(v)
//     in f32; the combine kernel adds the splits' sums in split order.
//     K/V are read through bf16 and the probabilities cast to bf16 before
//     the value product, which reproduces the gather path's roundings and
//     keeps greedy decoding token-exact with it.
// No atomics touch the data, so the result is deterministic.
//
// Prefill, f32 body (paged_prefill_kernel): the block stages a page in
// shared memory as f32 and a tile of 16 of the G*C query rows scores
// against it there, with the running max, denominator and accumulator in
// shared memory.  The tensor cores have no f32 product.
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
// Numerics follow the Pallas bodies: f32 scores, softmax and accumulators;
// a masked column gets -inf; a row with no valid column yields 0.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launches, 0 on success, or cudaErrorInvalidValue for a shape it
// does not take.  dtype 0 = float32, 1 = bfloat16; q, the pools and the
// output share that dtype; tables, lengths and bases are int32; window < 0
// means no sliding window.  Decode takes its split plan (splits, kps), its
// f32 workspace and the current device's index from the caller; D must fill
// whole 16-byte rows (a multiple of 4 in f32, 8 in bf16; the wrapper pads)
// and be at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;           // prefill query rows per block
constexpr int kDefaultSmem = 48 * 1024;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round-to-nearest-even through bf16, as jnp's astype(bfloat16) rounds
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage one (bs, D) f32 page of one KV head in shared memory, rows `ld`
// floats apart (ld = D + 1 for K breaks the bank conflicts of the
// row-per-thread score loop).
__device__ __forceinline__ void load_page(float* dst, int ld, const float* __restrict__ src,
                                          int bs, int D) {
  const int n = bs * D;
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[(e / D) * ld + (e % D)] = src[e];
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

// -- decode: split-K over the key axis, on CUDA cores --------------------------

constexpr int kDWarps = 4;                    // warps per decode block
constexpr int kDThreads = 32 * kDWarps;
constexpr int kDStages = 3;                   // stages in each warp's cp.async ring
constexpr int kDPass = 128;                   // dims one pass of a warp's lanes covers (4 each)
constexpr int kDRows = 4;                     // query rows a decode block holds in registers

enum DecodeMode { kPlain = 0, kStats = 1, kValues = 2 };

// four consecutive elements as f32: a 16-byte f32 or an 8-byte bf16 read
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// One level of transpose_sum: a lane keeps the half of its 2 * off values
// that its lane bit `off` selects and adds its partner's copy of that half.
template <int off>
__device__ __forceinline__ void transpose_level(float (&v)[32], int lane) {
  const bool upper = lane & off;
#pragma unroll
  for (int i = 0; i < off; ++i) {
    const float send = upper ? v[i] : v[i + off];
    const float keep = upper ? v[i + off] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Sums 32 values over the warp's lanes and leaves the sum of value i in
// lane i (31 shuffles for 32 sums, against 160 for a butterfly per value).
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  transpose_level<16>(v, lane);
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  return v[0];
}

// max / sum over the `width` lanes of an aligned lane group
template <int width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < width; off *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < width; off *= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (m, l) <- the softmax state of the keys of (m, l) and of (m2, l2); the
// same for either order of the two, so a butterfly leaves every lane equal
__device__ __forceinline__ void merge_stats(float& m, float& l, float m2, float l2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;                  // both empty
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the kernel before it on the stream has run launch_dependents
// (or exited); it must run wait_prerequisite before it reads what that
// kernel writes.  Without the attribute, wait_prerequisite returns at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Shared memory of a decode block: the page ids of its split, then either
// the warps' cp.async rings (kDStages stages of 32 / kDRows K rows and as
// many V rows each, in the pool's dtype) or, once every warp is done with
// its ring, the warps' states for the merge (m, l and the accumulator of
// kDRows rows each).  Host and kernel compute it alike.
__host__ __device__ inline int decode_page_bytes(int bs, int kps) {
  return (((kps + bs - 1) / bs + 1) * 4 + 15) & ~15;
}

__host__ __device__ inline size_t decode_smem_bytes(int D, int bs, int kps, int elem) {
  const size_t ring = (size_t)kDWarps * kDStages * 2 * (32 / kDRows) * D * elem;
  const size_t merge = sizeof(float) * kDWarps * kDRows * (2 + (size_t)D);
  return decode_page_bytes(bs, kps) + (ring > merge ? ring : merge);
}

// Where a warp's runs of keys come from and go to.
template <typename T>
struct RunKeys {
  const T* k_pool;
  const T* v_pool;
  const int* pages;                             // the split's page ids, from page ps0
  int ps0, Hkv, h, bs, D, keys, row_bytes, stage_bytes;
};

// Copies run warp + i * kDWarps -- `keys` keys from `first` on, those past
// `last` zero-filled -- into stage i % kDStages of the warp's ring: K rows,
// then (kReadV) V rows, 16 bytes a lane, straight from their pages.
template <bool kReadV, typename T>
__device__ __forceinline__ void issue_run(uint8_t* ring, int i, int first, int last, int warp,
                                          int lane, const RunKeys<T>& rk) {
  const int key0 = first + (warp + i * kDWarps) * rk.keys;
  uint8_t* st = ring + (i % kDStages) * rk.stage_bytes;
  const int chunks = rk.row_bytes / 16;
  for (int e = lane; e < rk.keys * chunks; e += 32) {
    const int t = e / chunks, c = e % chunks, key = key0 + t;
    const bool ok = key <= last;
    const size_t off =
        ok ? (((size_t)rk.pages[key / rk.bs - rk.ps0] * rk.Hkv + rk.h) * rk.bs + key % rk.bs) *
                 rk.D
           : 0;
    attn_tile::cp_async_16(st + t * rk.row_bytes + 16 * c,
                           reinterpret_cast<const uint8_t*>(rk.k_pool + off) + 16 * c, ok);
    if (kReadV)
      attn_tile::cp_async_16(st + (rk.keys + t) * rk.row_bytes + 16 * c,
                             reinterpret_cast<const uint8_t*>(rk.v_pool + off) + 16 * c, ok);
  }
}

// A lane's four dims of row t of a stage (K rows, then V rows), pass c; a
// lane past D reads the row's first dims, which meet its zero q and add to
// accumulator dims that are never stored.  kQuant: read through bf16.
template <bool kQuant, typename T>
__device__ __forceinline__ float4 read4(const uint8_t* st, int t, int c, int row_bytes, int D,
                                        int lane) {
  const int d = c * kDPass + 4 * lane;
  const float4 x = load4(reinterpret_cast<const T*>(st + t * row_bytes) + (d < D ? d : 0));
  return (kQuant && sizeof(T) == 4) ? round_bf16(x) : x;   // bf16 pools are exact
}

// One block: split s of the key axis of one (sequence b, KV head h), for
// the kDRows query rows g0 .. g0 + kDRows - 1 of that head (a group of
// G > kDRows rows takes ceil(G / kDRows) blocks).  The split covers keys
// [s * kps, s * kps + kps); its live keys are the part of that range inside
// the valid columns [lo, length], an interval [first, last].
//
// The live keys are cut into runs of kK = 32 / kDRows keys, and warp w takes
// runs w, w + kDWarps, ...: each run's K (and V) rows are copied by
// cp.async, 16 bytes a lane, straight from the pages the block table names
// into a kDStages-deep ring of the warp's own, so that two runs' loads are
// in flight while one is scored.  A lane holds dims [128 c + 4 lane,
// 128 c + 4 lane + 4) of q for the kDRows rows (c < kNC), so each K row is
// read once for all kDRows rows; the kDRows * kK partial products of a run
// are summed over the lanes by transpose_sum, which leaves the score of row
// lane / kK and key lane % kK in that lane.  The softmax then takes one
// exp per lane, its running state lives in each row's group of kK lanes,
// and the value product broadcasts each probability to the lanes, whose
// accumulators hold their dims of all kDRows rows.  The warps merge in shared
// memory at the end, in warp order.
//   kPlain:  writes the split's (m, l) and its unnormalised accumulator;
//   kStats:  writes the split's (m, l) only (read_dtype body, first pass);
//   kValues: merges all splits' (m, l) into the final (m, l), then sums
//            bf16(exp(s - m) / l) * bf16(v) over the split's keys (second
//            pass).
// The workspace holds, per (b, h, split, g): ml = (m, l) and part[D].
template <typename T, int kNC, int kMode>
__global__ void __launch_bounds__(kDThreads, 4)   // 4 blocks an SM: <= 128 registers
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool, const int* __restrict__ bt,
                          const int* __restrict__ lengths, float2* __restrict__ ml,
                          float* __restrict__ part, int Hkv, int G, int D, int bs, int nb,
                          int splits, int kps, int window, float scale) {
  constexpr bool kQuant = kMode != kPlain;      // the read_dtype body: bf16 K/V reads
  constexpr bool kReadV = kMode != kStats;
  constexpr int kK = 32 / kDRows;               // keys per run: one score per lane
  extern __shared__ __align__(16) uint8_t dsmem[];
  const int s = blockIdx.x, b = blockIdx.z;
  const int groups = (G + kDRows - 1) / kDRows;
  const int h = blockIdx.y / groups, g0 = (blockIdx.y % groups) * kDRows;
  const int rows = min(kDRows, G - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int my_r = lane / kK, my_t = lane % kK; // the (row, key) of this lane's score
  const size_t bh = (size_t)b * Hkv + h;
  const size_t ws = (bh * splits + s) * G + g0;   // workspace row of (b, h, s, g0)
  launch_dependents();                          // the next pass may start loading its K/V

  // q, the length and the split's page ids: loads independent of each other
  float4 qr[kDRows][kNC];
#pragma unroll
  for (int r = 0; r < kDRows; ++r)
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int d = c * kDPass + 4 * lane;
      qr[r][c] = (r < rows && d < D) ? load4(q + (bh * G + g0 + r) * D + d)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  int* pages = reinterpret_cast<int*>(dsmem);
  const int length = lengths[b];
  const int key_end = min(s * kps + kps, nb * bs);
  const int ps0 = s * kps / bs, psn = (key_end + bs - 1) / bs - ps0;
  for (int i = threadIdx.x; i < psn; i += kDThreads) pages[i] = bt[(size_t)b * nb + ps0 + i];
  const int lo = window >= 0 ? max(0, length - window + 1) : 0;
  const int first = max(s * kps, lo), last = min(key_end - 1, length);
  if (first > last) {                           // nothing of the split is valid
    if (kMode != kValues && threadIdx.x < rows) ml[ws + threadIdx.x] = make_float2(-INFINITY, 0.f);
    return;
  }

  __syncthreads();                              // the page ids are in

  const int row_bytes = D * (int)sizeof(T);
  const int stage_bytes = (kReadV ? 2 : 1) * kK * row_bytes;
  uint8_t* ring = dsmem + decode_page_bytes(bs, kps) + warp * kDStages * stage_bytes;
  const RunKeys<T> run_keys{k_pool, v_pool, pages, ps0, Hkv, h, bs, D, kK, row_bytes, stage_bytes};
  const int runs = (last - first + kK) / kK;
  const int my_runs = warp < runs ? (runs - warp + kDWarps - 1) / kDWarps : 0;

  float4 acc[kDRows][kNC];
#pragma unroll
  for (int r = 0; r < kDRows; ++r)
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int i = 0; i < kDStages - 1; ++i) {
    if (i < my_runs) issue_run<kReadV>(ring, i, first, last, warp, lane, run_keys);
    attn_tile::cp_async_commit();
  }
  // this lane's row's softmax state: running (kPlain, kStats), or final
  // (kValues, once the first runs' copies are in flight: every split's
  // stats merged in one fixed order -- lane t of the row's group folds
  // splits t, t + kK, ... in turn, then a butterfly merges the group -- so
  // every block of the row computes the same values)
  float m = -INFINITY, l = 0.f;
  if (kMode == kValues) {
    wait_prerequisite();                        // the stats pass has written ml
    if (my_r < rows) {
#pragma unroll 4
      for (int t = my_t; t < splits; t += kK) {
        const float2 st = ml[(bh * splits + t) * G + g0 + my_r];
        merge_stats(m, l, st.x, st.y);
      }
    }
#pragma unroll
    for (int off = 1; off < kK; off *= 2) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
      merge_stats(m, l, m2, l2);
    }
    if (l == 0.f) l = 1.f;                      // fully masked rows -> 0
  }
  for (int i = 0; i < my_runs; ++i) {
    // the stage run i + 2 goes to was scored in iteration i - 1
    if (i + kDStages - 1 < my_runs)
      issue_run<kReadV>(ring, i + kDStages - 1, first, last, warp, lane, run_keys);
    attn_tile::cp_async_commit();
    attn_tile::cp_async_wait<kDStages - 1>();   // this lane's copies of run i have landed
    __syncwarp();                               // and every lane's
    const uint8_t* st = ring + (i % kDStages) * stage_bytes;
    const int key0 = first + (warp + i * kDWarps) * kK;

    float v[32];                                // v[r * kK + t]: partial product of row r, key t
#pragma unroll
    for (int t = 0; t < kK; ++t) {
      float4 kf[kNC];
#pragma unroll
      for (int c = 0; c < kNC; ++c) kf[c] = read4<kQuant, T>(st, t, c, row_bytes, D, lane);
#pragma unroll
      for (int r = 0; r < kDRows; ++r) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < kNC; ++c) p = dot4(qr[r][c], kf[c], p);
        v[r * kK + t] = p;
      }
    }
    const float x = transpose_sum(v, lane);
    const float sc = key0 + my_t <= last ? x * scale : -INFINITY;

    float p, alpha = 1.f;
    if (kMode == kValues) {
      p = m == -INFINITY ? 0.f : round_bf16(expf(sc - m) / l);   // divided, as the reference
    } else {
      // online softmax over the run: its first key is valid, so m_new is finite
      const float m_new = fmaxf(m, group_max<kK>(sc));
      alpha = expf(m - m_new);
      p = expf(sc - m_new);
      l = l * alpha + group_sum<kK>(p);
      m = m_new;
    }
    if (kReadV) {
      if (kMode == kPlain) {
#pragma unroll
        for (int r = 0; r < kDRows; ++r) {
          const float a = __shfl_sync(0xffffffffu, alpha, r * kK);
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            acc[r][c].x *= a;
            acc[r][c].y *= a;
            acc[r][c].z *= a;
            acc[r][c].w *= a;
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kK; ++t) {
        float4 vf[kNC];
#pragma unroll
        for (int c = 0; c < kNC; ++c) vf[c] = read4<kQuant, T>(st, kK + t, c, row_bytes, D, lane);
#pragma unroll
        for (int r = 0; r < kDRows; ++r) {
          const float pr = __shfl_sync(0xffffffffu, p, r * kK + t);
#pragma unroll
          for (int c = 0; c < kNC; ++c) fma4(acc[r][c], pr, vf[c]);
        }
      }
    }
    __syncwarp();                               // done with the stage before it is refilled
  }

  // merge the warps, in warp order; the merge area overlaps the rings
  __syncthreads();
  float* wm = reinterpret_cast<float*>(dsmem + decode_page_bytes(bs, kps));
  float* wl = wm + kDWarps * kDRows;
  float* wacc = wl + kDWarps * kDRows;          // (kDWarps, kDRows, D)
  if (my_t == 0) {
    wm[warp * kDRows + my_r] = m;
    wl[warp * kDRows + my_r] = l;
  }
  if (kReadV) {
#pragma unroll
    for (int r = 0; r < kDRows; ++r)
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int d = c * kDPass + 4 * lane;
        if (d < D) *reinterpret_cast<float4*>(wacc + (warp * kDRows + r) * D + d) = acc[r][c];
      }
  }
  __syncthreads();
  if (kMode != kValues) {
    for (int r = threadIdx.x; r < rows; r += kDThreads) {
      float mx = -INFINITY, sum = 0.f;
      for (int w = 0; w < kDWarps; ++w) mx = fmaxf(mx, wm[w * kDRows + r]);
      for (int w = 0; w < kDWarps; ++w) sum += wl[w * kDRows + r] * expf(wm[w * kDRows + r] - mx);
      ml[ws + r] = make_float2(mx, sum);
    }
  }
  if (kReadV) {
    for (int e = threadIdx.x; e < rows * D; e += kDThreads) {
      const int r = e / D, d = e % D;
      float mx = -INFINITY, sum = 0.f;
      if (kMode == kPlain)
        for (int w = 0; w < kDWarps; ++w) mx = fmaxf(mx, wm[w * kDRows + r]);
      for (int w = 0; w < kDWarps; ++w) {
        const float x = wacc[(w * kDRows + r) * D + d];
        sum += kMode == kPlain ? x * expf(wm[w * kDRows + r] - mx) : x;
      }
      part[(ws + r) * D + d] = sum;
    }
  }
}

// One thread per output element (b, h, g, d): the live splits of the row
// (those the split kernels found valid keys in, from the length and the
// window) merged in split order.  normalise (plain body): weights
// exp(m_s - m) and a final division by l; otherwise (read_dtype body) the
// partial sums, already normalised, are added.
template <typename T>
__global__ void __launch_bounds__(kDThreads)
paged_decode_combine_kernel(const float2* __restrict__ ml, const float* __restrict__ part,
                            const int* __restrict__ lengths, T* __restrict__ out, int n,
                            int Hkv, int G, int D, int splits, int kps, int keys, int window,
                            int normalise) {
  const int e = blockIdx.x * kDThreads + threadIdx.x;
  if (e >= n) return;
  const int d = e % D, row = e / D;             // row = (b * Hkv + h) * G + g
  const size_t bh = row / G;
  const int g = row % G;
  const int length = lengths[bh / Hkv];
  const int lo = window >= 0 ? max(0, length - window + 1) : 0;
  const int hi = min(length, keys - 1);
  const int t0 = lo / kps, t1 = lo <= hi ? hi / kps : t0 - 1;   // the live splits
  wait_prerequisite();                          // the split passes have written ml, part
  const float2* mr = ml + bh * splits * G + g;                  // split t at t * G
  const float* pr = part + (bh * splits * G + g) * D + d;       // split t at t * G * D
  float val = 0.f;
  if (normalise) {
    float mx = -INFINITY, l = 0.f;
#pragma unroll 4
    for (int t = t0; t <= t1; ++t) mx = fmaxf(mx, mr[(size_t)t * G].x);
#pragma unroll 4
    for (int t = t0; t <= t1; ++t) {
      const float2 st = mr[(size_t)t * G];
      const float w = expf(st.x - mx);
      l += st.y * w;
      val += pr[(size_t)t * G * D] * w;
    }
    val /= (l == 0.f ? 1.f : l);                // fully masked rows -> 0
  } else {
#pragma unroll 4
    for (int t = t0; t <= t1; ++t) val += pr[(size_t)t * G * D];
  }
  out[e] = from_f32<T>(val);
}

// -- prefill, f32 body ------------------------------------------------------

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
    qs[e] = qb[e];
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
    load_page(ks, ldk, k_pool + off, bs, D);
    load_page(vs, D, v_pool + off, bs, D);
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

struct DecodeArgs {
  const void *q, *k_pool, *v_pool, *bt, *lengths;
  void* out;
  float* ws;          // per (b, h, split, g): (m, l), then the partial sums part[D]
  int B, Hkv, G, D, bs, nb, splits, kps, window;
  float scale;
  int device;         // the current device, whose shared-memory limit is raised
};

// Launches `kernel` on `stream`; `dependent` lets it start while the
// kernel before it finishes (programmatic dependent launch).
template <typename... Params, typename... Args>
cudaError_t launch_on(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t stream,
                      bool dependent, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kDThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int kNC, int kMode>
cudaError_t launch_split(const DecodeArgs& a, cudaStream_t stream) {
  auto kernel = paged_decode_split_kernel<T, kNC, kMode>;
  const size_t smem = decode_smem_bytes(a.D, a.bs, a.kps, sizeof(T));
  // the shared-memory limit is raised once per device and size, not per call
  static size_t allowed[64] = {};
  if (a.device < 0 || a.device >= 64 || smem > allowed[a.device]) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    if (a.device >= 0 && a.device < 64) allowed[a.device] = smem;
  }
  const size_t rows = (size_t)a.B * a.Hkv * a.splits * a.G;
  const dim3 grid(a.splits, a.Hkv * ((a.G + kDRows - 1) / kDRows), a.B);
  return launch_on(kernel, grid, smem, stream, kMode == kValues,
                   static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
                   static_cast<const T*>(a.v_pool), static_cast<const int*>(a.bt),
                   static_cast<const int*>(a.lengths), reinterpret_cast<float2*>(a.ws),
                   a.ws + 2 * rows, a.Hkv, a.G, a.D, a.bs, a.nb, a.splits, a.kps, a.window,
                   a.scale);
}

// plain body: split pass, combine; read_dtype body: stats pass, value
// pass, combine -- all on one stream, in that order, each after the first
// launched as a dependent of the one before
template <typename T, int kNC>
int launch_decode_body(const DecodeArgs& a, int quant, cudaStream_t stream) {
  cudaError_t err = quant ? launch_split<T, kNC, kStats>(a, stream)
                          : launch_split<T, kNC, kPlain>(a, stream);
  if (err == cudaSuccess && quant) err = launch_split<T, kNC, kValues>(a, stream);
  if (err != cudaSuccess) return (int)err;
  const int n = a.B * a.Hkv * a.G * a.D;
  const size_t rows = (size_t)a.B * a.Hkv * a.splits * a.G;
  return (int)launch_on(paged_decode_combine_kernel<T>, dim3((n + kDThreads - 1) / kDThreads),
                        0, stream, true, reinterpret_cast<const float2*>(a.ws),
                        static_cast<const float*>(a.ws + 2 * rows),
                        static_cast<const int*>(a.lengths), static_cast<T*>(a.out), n, a.Hkv,
                        a.G, a.D, a.splits, a.kps, a.nb * a.bs, a.window, (int)!quant);
}

// D up to 128 in one pass of the lanes, up to 256 in two
template <typename T>
int launch_decode(const DecodeArgs& a, int quant, cudaStream_t stream) {
  const int groups = (a.G + kDRows - 1) / kDRows;
  if (a.D % (16 / (int)sizeof(T)) || a.D > 2 * kDPass || a.splits < 1 || a.kps < 1 ||
      (long long)a.splits * a.kps < (long long)a.nb * a.bs || a.B > 65535 ||
      (long long)a.Hkv * groups > 65535 ||
      ((uintptr_t)a.q | (uintptr_t)a.k_pool | (uintptr_t)a.v_pool) % 16)
    return (int)cudaErrorInvalidValue;
  if (a.D > kDPass) return launch_decode_body<T, 2>(a, quant, stream);
  return launch_decode_body<T, 1>(a, quant, stream);
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
size_t repro_paged_decode_smem(int D, int bs, int kps, int dtype) {
  return decode_smem_bytes(D, bs, kps, dtype == 1 ? 2 : 4);
}
size_t repro_paged_prefill_smem(int D, int bs, int dtype) {
  return prefill_smem_bytes(D, bs, dtype);
}

int repro_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                 const void* bt, const void* lengths, void* out, void* workspace,
                                 int B, int Hkv, int G, int D, int bs, int nb, int splits,
                                 int kps, int window, float scale, int dtype, int quant,
                                 int device, void* stream) {
  const DecodeArgs a{q, k_pool, v_pool, bt, lengths, out, static_cast<float*>(workspace),
                     B, Hkv, G, D, bs, nb, splits, kps, window, scale, device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_decode<float>(a, quant, s);
  if (dtype == 1) return launch_decode<__nv_bfloat16>(a, quant, s);
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
