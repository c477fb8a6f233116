// Dense matrix product for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/matmul.py:
//   * matmul_kernel <- matmul_pallas (_mm_kernel), wrapped by ops.matmul.
//
// It computes c = a @ b for row-major a (m, k) and b (k, n), both float32 or
// both bfloat16, into c (m, n) of the same dtype.  As in _mm_kernel, tiles
// are read in the input dtype and widened to f32, the sum over k is an f32
// accumulator, and the result is rounded once to the output dtype.
//
// What bounds it on the H100: operations.  At the paper path's 512^3 the
// product is 268 MFLOP against 3.1 MB of operands (~85 flop/byte), at
// 4096^3 137 GFLOP against 201 MB; both sit above the card's balance point.
// This first version runs on CUDA cores in f32 (67 TFLOP/s peak, against
// 989 TFLOP/s for bf16 on the tensor cores), so the f32 peak is its floor.
//
// The TPU kernel walked k on a sequential ("arbitrary") grid axis with the
// accumulator carried in VMEM scratch, padding every dimension to its
// 128/256/128 blocks.  Here one thread block owns one output tile and loops
// over k itself, the accumulator in registers: each thread holds a TM x TN
// register block, and per step of BK the block stages an a tile (BM x BK,
// stored transposed, k-major) and a b tile (BK x BN) in shared memory as
// f32.  Loads and stores are predicated on m, k and n, so no padding copy is
// made and any shape >= 1 runs the kernel (1 x 512 x 128 and 8 x 8 x 8
// included); out-of-range elements are staged as zeros.
//
// Two tile shapes, chosen per call so that the card gets at least one block
// per SM (132 on the H100 SXM) where the output allows it:
//   * 128 x 128, 256 threads with 8 x 8 outputs each, when ceil(m/128) *
//     ceil(n/128) blocks fill every SM (2048^2 and up);
//   * 32 x 32, 64 threads with 4 x 4 outputs each, otherwise.  At the paper
//     path's 512^2 output this gives 256 blocks where 128 x 128 tiles would
//     give 16 for 132 SMs.
// A thread's columns are two groups of four, BN/2 apart (one group in the
// small tile), so the float4 reads of the b tile by a warp's threads are
// consecutive and free of bank conflicts; the a tile's row stride is BM + 4
// floats, so its transposing stores hit 32 distinct banks.
//
// The k loop runs in ascending order with one fused multiply-add per
// element, so the sum order is fixed; it differs from cuBLAS's and the
// CPU's, which is why the f32 checks allow for summation order.
//
// Left for later work: tensor cores (wgmma on bf16, or TF32 where the
// caller accepts it), TMA or cp.async double buffering of the tiles, and
// vectorised global loads where the shapes allow.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for a shape or
// dtype it does not take.  dtype 0 = float32, 1 = bfloat16; a, b and c are
// contiguous and distinct.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// BM x BN output tile, BK-deep k steps, TM x TN outputs per thread
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
              int m, int k, int n) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kCols = BN / TN;         // threads along n
  constexpr int kGroups = TN / 4;        // float4 column groups per thread
  constexpr int kGroupStride = BN / kGroups;
  constexpr int kRowGroups = TM / 4;
  constexpr int kRowGroupStride = BM / kRowGroups;
  constexpr int kLDA = BM + 4;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register blocks are float4 groups");
  static_assert(BM % 32 == 0, "a-tile stride BM + 4 needs BM % 32 == 0");
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0,
                "every thread stages the same number of tile elements");

  __shared__ __align__(16) float as[BK * kLDA];   // a tile, k-major
  __shared__ __align__(16) float bs[BK * BN];     // b tile, row-major

  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // a tile: consecutive threads read consecutive k of one row
#pragma unroll
    for (int it = 0; it < BM * BK / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int i = e / BK, kk = e % BK;
      const int r = row0 + i, kc = k0 + kk;
      as[kk * kLDA + i] = (r < m && kc < k) ? to_f32(a[(size_t)r * k + kc]) : 0.f;
    }
    // b tile: consecutive threads read consecutive columns of one row
#pragma unroll
    for (int it = 0; it < BK * BN / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int kk = e / BN, j = e % BN;
      const int kr = k0 + kk, cc = col0 + j;
      bs[kk * BN + j] = (kr < k && cc < n) ? to_f32(b[(size_t)kr * n + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < kRowGroups; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(
            &as[kk * kLDA + g * kRowGroupStride + ty * 4]);
        av[4 * g] = x.x; av[4 * g + 1] = x.y; av[4 * g + 2] = x.z; av[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(
            &bs[kk * BN + g * kGroupStride + tx * 4]);
        bv[4 * g] = x.x; bv[4 * g + 1] = x.y; bv[4 * g + 2] = x.z; bv[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i / 4) * kRowGroupStride + ty * 4 + i % 4;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + (j / 4) * kGroupStride + tx * 4 + j % 4;
      if (cc < n) c[(size_t)r * n + cc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* a, const void* b, void* c, int m, int k, int n, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, k, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* c, int m, int k, int n, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long big_blocks = (long long)((m + 127) / 128) * ((n + 127) / 128);
  if (big_blocks >= sms) return launch<T, 128, 128, 8, 8, 8>(a, b, c, m, k, n, s);
  return launch<T, 32, 32, 8, 4, 4>(a, b, c, m, k, n, s);
}

}  // namespace

extern "C" {

int repro_matmul(const void* a, const void* b, void* c, int m, int k, int n, int dtype,
                 void* stream) {
  if (m < 1 || k < 1 || n < 1 || (m + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, c, m, k, n, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, b, c, m, k, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
