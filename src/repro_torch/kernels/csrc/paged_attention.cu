// Paged attention for NVIDIA Hopper (sm_90a): decode and chunked prefill.
//
// Replaces the two TPU kernels of src/repro/kernels/paged_attention.py:
//   * paged_decode_kernel  <- paged_attention_pallas (_pa_kernel and the
//     two-phase _pa_kernel_quantized body);
//   * paged_prefill_kernel <- paged_prefill_attention_pallas (_pa_prefill_kernel).
//
// Both read one layer of the paged KV pool, (N, Hkv, bs, D), through a
// per-sequence block table (B, nb) of page ids, so no linearised (B, T, D)
// copy of the cache is ever written to device memory.
//
// What bounds them on the H100: the bytes of K/V read.  Decode does 2*D
// flops per K/V element it reads (about one flop per byte in bf16), far
// below the card's ~295 flop/byte balance; prefill at C=128 rows per KV
// head reaches ~G*C flops per byte, still short of it at these sizes.  The
// design therefore reads each live page once per block: the block stages
// the page in shared memory, converted to f32, and every query row of the
// block (all G heads of a KV head; for prefill a tile of G*C rows) scores
// against it there.  Pages that the causal frontier or the sliding window
// rules out are never read.
//
// The TPU walked pages on a sequential grid axis with the online-softmax
// state carried in scratch between grid steps.  Here one thread block owns
// one (sequence, KV head[, row tile]) and loops over that sequence's pages
// itself, keeping the running max, denominator and accumulator in shared
// memory; the block reads its block-table row and length itself (the
// TPU's scalar prefetch).
//
// Left for later work: page loads with cp.async/TMA overlapped with the
// previous page's math, split-K over pages for small batches (B*Hkv blocks
// fill only part of the 132 SMs at batch 4), and tensor-core (wgmma) score
// and value products for prefill.
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
// after the launch, 0 on success.  dtype 0 = float32, 1 = bfloat16; q, the
// pools and the output share that dtype; tables, lengths and bases are
// int32; window < 0 means no sliding window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool, const int* __restrict__ bt,
                     const int* __restrict__ base_arr, int chunk_len,
                     T* __restrict__ out, int Hkv, int GC, int C, int D, int bs, int nb,
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
  const T* qb = q + (head * GC + r0) * D;
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

  T* ob = out + (head * GC + r0) * D;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const float lg = l[e / D];
    ob[e] = from_f32<T>(acc[e] / (lg == 0.f ? 1.f : lg));
  }
}

size_t decode_smem_bytes(int G, int D, int bs) {
  return sizeof(float) * ((size_t)G * D * 2 + (size_t)bs * (2 * D + 1) + (size_t)G * bs + 3 * G);
}

size_t prefill_smem_bytes(int D, int bs) {
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

template <typename T>
int launch_prefill(const void* q, const void* k_pool, const void* v_pool, const void* bt,
                   const void* base, int chunk_len, void* out, int B, int Hkv, int G, int C,
                   int D, int bs, int nb, int window, float scale, cudaStream_t stream) {
  const size_t smem = prefill_smem_bytes(D, bs);
  cudaError_t err = allow_smem(paged_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int GC = G * C;
  dim3 grid(B, Hkv, (GC + kRows - 1) / kRows);
  paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(bt), static_cast<const int*>(base), chunk_len,
      static_cast<T*>(out), Hkv, GC, C, D, bs, nb, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a launch needs, so the wrapper can refuse shapes
// the card cannot hold before launching.
size_t repro_paged_decode_smem(int G, int D, int bs) { return decode_smem_bytes(G, D, bs); }
size_t repro_paged_prefill_smem(int D, int bs) { return prefill_smem_bytes(D, bs); }

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
    return launch_prefill<float>(q, k_pool, v_pool, bt, base, chunk_len, out, B, Hkv, G, C,
                                 D, bs, nb, window, scale, s);
  if (dtype == 1)
    return launch_prefill<__nv_bfloat16>(q, k_pool, v_pool, bt, base, chunk_len, out, B,
                                         Hkv, G, C, D, bs, nb, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
