// Attention tile core for NVIDIA Hopper (sm_90a): the bf16 bodies of the
// flash-attention and paged-prefill kernels share it.
//
// One consumer warpgroup (128 threads) owns a 64-row bf16 Q tile and walks
// 64-key bf16 K/V stages that a producer warp brings into a ring in shared
// memory, each stage signalled on an mbarrier; per stage it computes
//   S = Q K^T                      one wgmma chain, both operands in smem,
//                                  f32 accumulator in registers;
//   mask, online softmax           f32 registers on the accumulator fragment,
//                                  rows reduced across the quad by shuffles;
//   O += P_hi V + P_lo V           two wgmmas per 16 keys, P from registers.
// A stage's Q K^T is issued together with the previous stage's P V, and
// its softmax runs while that product is in flight (attend); two
// warpgroups of one block may also take turns issuing (Turns).  The
// kernels differ only in how a K/V stage is addressed (contiguous rows by
// TMA for flash, block-table pages by cp.async for prefill) and in how a
// row's position is derived, which they pass in as mask functors.
//
// Why P is split in two: the reference keeps P in f32 for the value product
// (_fa_kernel and _pa_prefill_kernel cast p to v's f32 dtype).  Rounding P
// once to bf16 moves an output near 0 by ~2^-9 |v|, past the flash kernel's
// limit of one bf16 step.  P_hi = bf16(P), P_lo = bf16(P - P_hi) keeps 16
// significant bits of P (error <= 2^-18 max|v|) for 6*D tensor-core
// operations per (row, key) instead of 4*D.  bf16 x bf16 products are
// exact in f32, so S differs from the plain version only in summation
// order.
//
// Shared-memory tiles: 64 rows x 128 dims of bf16 (D zero-padded to 128),
// stored as two 64-dim halves of 64 rows x 128 bytes, 8 KB apart, each in
// the 128-byte swizzle that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and
// wgmma's 128B layout reads: 16-byte chunk c of row r sits at chunk
// c ^ (r % 8).  Every tile starts on a 1024-byte boundary.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kRows = 64;                 // query rows per consumer warpgroup
constexpr int kKeys = 64;                 // keys per K/V stage
constexpr int kDP = 128;                  // head dim as padded in shared memory
constexpr int kHalfBytes = 64 * 64 * 2;   // one 64-dim half of a tile
constexpr int kTileBytes = 2 * kHalfBytes;
constexpr int kWarpgroup = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..15, 8 bf16 each) of row r in a tile
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * kHalfBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// -- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase with this parity has completed.  A wait that has not
// returned after ~2^32 cycles (seconds) traps, so a lost arrival ends the
// kernel with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// -- copies -----------------------------------------------------------------

// TMA: a 2-D box of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tensor_map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// cp.async of 16 bytes, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) before later async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma ------------------------------------------------------------------

// Descriptor of a K-major operand in the 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Descriptor of an MN-major operand (V: keys are K, dims are N) in the
// 128-byte swizzle: the two 64-dim halves kHalfBytes apart (LBO), 8-key
// groups 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kHalfBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that the registers may change here, so that no read
// of an accumulator moves above the wait for the wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_registers(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) {=, +=} A (64 x 16, smem) * B (16 x 64, smem), both
// K-major; the accumulator is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// -- the consumer's stage loop ------------------------------------------------
//
// Fragment layout of an m64nN f32 accumulator (and of S here): thread t of
// the warpgroup holds rows ra = 16 (t / 32) + (t % 32) / 4 and rb = ra + 8;
// register 4 i + e holds column 8 i + 2 (t % 4) + (e & 1) of row ra (e < 2)
// or rb (e >= 2).  A row's 64 scores are spread over the 4 threads of a
// quad, so its max and sum take two shuffles.

struct Softmax {
  float m[2];   // running max of rows ra, rb, in units of scale * log2(e)
  float l[2];   // this thread's part of the running denominators
};

__device__ __forceinline__ void init_state(float (&o)[64], Softmax& st) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// P as the A operand of m64n128k16, 16 keys per step: the S fragment of
// keys 16 kk .. 16 kk + 15 is exactly the A fragment's layout.
struct Probs {
  uint32_t hi[4][4];   // bf16(P)
  uint32_t lo[4][4];   // bf16(P - bf16(P))
};

__device__ __forceinline__ void fence_registers(Probs& p) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) asm volatile("" : "+r"(p.hi[kk][a]), "+r"(p.lo[kk][a])::"memory");
}

// S = Q K^T over the 128 padded dims, issued (not waited for)
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
    wgmma_m64n64k16_ss(s, desc_k_major(q + off), desc_k_major(k + off), kk > 0);
  }
}

// O += P_hi V + P_lo V over the stage's 64 keys, issued (not waited for)
__device__ __forceinline__ void issue_values(float (&o)[64], const Probs& p, uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = desc_mn_major(v + kk * 16 * 128);
    wgmma_m64n128k16_rs(o, p.hi[kk], dv);
    wgmma_m64n128k16_rs(o, p.lo[kk], dv);
  }
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scores to probabilities in place: scale, mask (when kMasked: ok(slot, c)
// for row ra or rb and stage column c), the online-softmax update of st,
// and alpha, the factor that rescales O.  m starts at -inf and alpha is 0
// while it is -inf, as in _fa_kernel.  Selects only, no branches: the
// value product of the previous stage is in flight meanwhile.
template <bool kMasked, typename Ok>
__device__ __forceinline__ void softmax_step(float (&s)[32], Softmax& st, float (&alpha)[2],
                                             float scale_log2, Ok ok) {
  const int quad = threadIdx.x % 4;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * scale_log2;
      if (kMasked) x = ok(e >> 1, 8 * i + 2 * quad + (e & 1)) ? x : -INFINITY;
      s[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(st.m[r], quad_max(mx[r]));
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;   // a row with nothing valid yet
    alpha[r] = ex2(st.m[r] - m_use[r]);             // 0 while the old max is -inf
    st.m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[4 * i + e] - m_use[e >> 1]);   // masked: 0
      s[4 * i + e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + sum[r];
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    o[4 * i + 0] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
}

// One conversion per pair for each term (conversions run at a quarter of
// the ALU rate): the rounded pair's halves, widened back by shifts, give
// the remainders.
__device__ __forceinline__ void split(const float (&s)[32], Probs& p) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float x = s[8 * kk + 2 * a], y = s[8 * kk + 2 * a + 1];
      const uint32_t h = pack_bf16(x, y);
      const float xh = __uint_as_float(h << 16), yh = __uint_as_float(h & 0xffff0000u);
      p.hi[kk][a] = h;
      p.lo[kk][a] = pack_bf16(x - xh, y - yh);
    }
}

// Ping-pong between two consumer warpgroups that walk the same stages:
// their wgmma issues alternate (0, 1, 0, 1, ...), so one warpgroup's
// softmax runs while the other's products occupy the tensor cores.
// turn[w] (one arrival per thread of the other warpgroup) completes a
// phase each time the other warpgroup has issued; the lead is at most one
// issue, so a parity wait cannot miss a phase.  Both warpgroups must issue
// equally often.
struct Turns {
  uint64_t* turn;
  int w;          // this warpgroup (0 or 1)
  int k = 0;      // its issues so far
  __device__ __forceinline__ void wait() {
    const int phase = k - 1 + w;    // 0 waits for 1's previous issue, 1 for 0's current
    if (phase >= 0) mbar_wait(&turn[w], phase & 1);
    __syncwarp();
  }
  __device__ __forceinline__ void pass() {   // every thread arrives: no branch
    mbar_arrive(&turn[1 - w]);                 // while the wgmmas are in flight
    ++k;
  }
};

// A single consumer warpgroup issues when it likes.
struct NoTurns {
  __device__ __forceinline__ void wait() {}
  __device__ __forceinline__ void pass() {}
};

// The first live stage: S = Q K^T, softmax, P split.
template <bool kMasked, typename Turn, typename Ok>
__device__ __forceinline__ void first_step(Softmax& st, Probs& p, uint32_t q, uint32_t k,
                                           float scale_log2, Turn& turn, Ok ok) {
  float s[32];
  turn.wait();
  wgmma_fence();
  issue_scores(s, q, k);
  wgmma_commit();
  turn.pass();
  wgmma_wait<0>();
  fence_registers(s);
  float alpha[2];
  softmax_step<kMasked>(s, st, alpha, scale_log2, ok);   // O is 0: no rescale
  split(s, p);
}

// A later stage: S = Q K^T and O += P V of the previous stage are issued
// together; the softmax of S runs while the value product is in flight;
// then O is rescaled and the new P split.  No branch lies between an issue
// and its wait, so ptxas keeps the wgmmas asynchronous.
template <bool kMasked, typename Turn, typename Ok>
__device__ __forceinline__ void next_step(float (&o)[64], Softmax& st, Probs& p, uint32_t q,
                                          uint32_t k, uint32_t v_prev, float scale_log2,
                                          Turn& turn, Ok ok) {
  float s[32];
  turn.wait();
  wgmma_fence();
  issue_scores(s, q, k);
  wgmma_commit();
  wgmma_fence();
  issue_values(o, p, v_prev);
  wgmma_commit();
  turn.pass();
  wgmma_wait<1>();              // S has landed; the value product may still run
  fence_registers(s);
  float alpha[2];
  softmax_step<kMasked>(s, st, alpha, scale_log2, ok);
  wgmma_wait<0>();
  fence_registers(o);
  fence_registers(p);
  rescale(o, alpha);
  split(s, p);
}

// O += P V of the last live stage.
template <typename Turn>
__device__ __forceinline__ void last_step(float (&o)[64], Probs& p, uint32_t v, Turn& turn) {
  turn.wait();
  wgmma_fence();
  issue_values(o, p, v);
  wgmma_commit();
  turn.pass();
  wgmma_wait<0>();
  fence_registers(o);
  fence_registers(p);
}

// The warpgroup's walk over the K/V stages of key tiles j0 .. j1 - 1.  The
// tile of iteration it = j - j0 lies in ring stage it % kStages (K at
// kv + 2 stage kTileBytes, V right after it); it is waited for on
// full[stage] and released, once every read of it is done, by one arrival
// per warp on empty[stage].  q: the shared-memory address of this
// warpgroup's Q tile.  whole(j): tile j valid whole for every row (no
// mask); ok(slot, col): key col valid for row ra (slot 0) or rb (slot 1);
// a tile masked whole for every row gives p = 0.  A stage is released one
// step late, after the value product that reads its V.  turn orders the
// wgmma issues against another warpgroup (Turns) or not (NoTurns).
template <int kStages, typename Turn, typename Whole, typename Ok>
__device__ __forceinline__ void attend(float (&o)[64], Softmax& st, uint32_t q, uint8_t* kv,
                                       uint64_t* full, uint64_t* empty, int j0, int j1,
                                       float scale_log2, Turn& turn, Whole whole, Ok ok) {
  if (j0 >= j1) return;
  const int lane = threadIdx.x % 32;
  auto wait = [&](int j) {
    const int it = j - j0;
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    __syncwarp();                 // converge after the barrier wait: wgmma is .aligned
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(j - j0) % kStages]);
  };
  auto k_tile = [&](int j) { return smem_u32(kv + 2 * ((j - j0) % kStages) * kTileBytes); };
  Probs p;
  wait(j0);
  auto ok0 = [&](int slot, int c) { return ok(slot, j0 * kKeys + c); };
  if (whole(j0))
    first_step<false>(st, p, q, k_tile(j0), scale_log2, turn, ok0);
  else
    first_step<true>(st, p, q, k_tile(j0), scale_log2, turn, ok0);
  for (int j = j0 + 1; j < j1; ++j) {
    wait(j);
    auto okj = [&](int slot, int c) { return ok(slot, j * kKeys + c); };
    const uint32_t v_prev = k_tile(j - 1) + kTileBytes;
    if (whole(j))
      next_step<false>(o, st, p, q, k_tile(j), v_prev, scale_log2, turn, okj);
    else
      next_step<true>(o, st, p, q, k_tile(j), v_prev, scale_log2, turn, okj);
    release(j - 1);
  }
  last_step(o, p, k_tile(j1 - 1) + kTileBytes, turn);
  release(j1 - 1);
}

// O / l rounded once to bf16.  row_ptr(slot) gives the output row of ra
// (slot 0) or rb (slot 1), or nullptr for a row that is not written; dims
// at or past D are not written (D is even).  A row with no valid column
// has l = 0 and O = 0 and writes 0.
template <typename RowPtr>
__device__ __forceinline__ void store_rows(const float (&o)[64], const Softmax& st, int D,
                                           RowPtr row_ptr) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(st.l[r]);
    const float inv = l == 0.f ? 1.f : 1.f / l;
    __nv_bfloat16* dst = row_ptr(r);
    if (dst == nullptr) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = 8 * i + 2 * quad;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + d) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    }
  }
}

}  // namespace attn_tile
