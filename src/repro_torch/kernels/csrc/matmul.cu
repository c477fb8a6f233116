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
// The f32 body is what the paper path runs, and the tensor cores have no
// f32 product (TF32 would change the numbers the f32 checks hold), so the
// kernel runs on CUDA cores in f32 (67 TFLOP/s peak): its floor is the f32
// peak, and its design is about hiding latency.
//
// The TPU kernel walked k on a sequential ("arbitrary") grid axis with the
// accumulator carried in VMEM scratch, padding every dimension to its
// 128/256/128 blocks.  Here one thread block owns one output tile and loops
// over k itself, the accumulator in registers: each thread holds a TM x TN
// register block.  The a (BM x BK) and b (BK x BN) tiles of each k step
// are copied by cp.async, 16 bytes a thread, in the input dtype (bf16 is
// widened when read into registers), into a ring of kStages = 3 stages in
// shared memory: while stage kt is computed, stages kt + 1 and kt + 2 are
// in flight.  A step's hand-off is cp.async.wait_group and one
// __syncthreads, which also frees the stage the next copies overwrite.
// Copies past m, k or n are zero-filled (cp.async's src-size operand), so
// no padding copy is made and any shape >= 1 runs the kernel.  Rows whose
// start is not 16-byte aligned (k or n not a multiple of 4 in f32 or of 8
// in bf16, or an unaligned pointer) take predicated plain loads into the
// same ring instead (1 x 512 x 128, 100 x 200 x 60 and 8 x 8 x 8 included).
//
// Two tile shapes; the wrapper picks one per call (kernels/matmul.py,
// matmul_tile) and passes its index down:
//   * 0: 64 x 32, 128 threads of 4 x 4 outputs, BK = 32: the paper path's
//     512^2 output gets 128 blocks of 4 warps, one per SM;
//   * 1: 128 x 128, 256 threads of 8 x 8 outputs, BK = 32, where the output
//     fills every SM with such tiles (2048^2 and up).
// A warp's lanes are 4 rows by 8 columns of threads, each thread's rows 4
// apart and its columns groups of four 32 apart.  Per four k values, a
// thread reads four k values of each of its rows (one 16-byte read each:
// the a tile's rows are padded by one 16-byte chunk, so a warp's four rows
// hit distinct banks) and, per k, its column groups of the b tile (a
// warp's eight groups are 128 consecutive bytes): 16 shared-memory
// wavefronts per warp for 64 FMAs per thread on the big tile.
//
// Every output is one ascending k loop with one fused multiply-add per
// product, from 0, for every tile shape and both dtypes, so the bf16 kernel
// equals the f32 kernel on the widened inputs, rounded once, bit for bit.
// The order differs from cuBLAS's and the CPU's, which is why the f32
// checks allow for summation order.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for a shape,
// tile or dtype it does not take.  dtype 0 = float32, 1 = bfloat16; a, b
// and c are contiguous and distinct.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kStages = 3;        // k steps in the shared-memory ring

// four consecutive elements as f32: a 16-byte f32 or an 8-byte bf16 read
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void store4(float* p, float x, float y, float z, float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float x, float y, float z, float w) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(z, w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

template <typename T, int BM, int BN, int BK>
struct Tiles {
  static constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte copy
  static constexpr int kLDA = BK + kVec;          // a-tile row stride, one chunk of padding
  static constexpr int kStage = BM * kLDA + BK * BN;   // elements per stage
  static constexpr size_t kSmem = sizeof(T) * kStages * kStage;
};

// BM x BN output tile, BK-deep k steps, TM x TN outputs per thread.
// A warp's lanes are 4 rows by 8 columns of threads; a thread's rows are 4
// apart and its column groups of four 32 apart, so a warp owns a (4 TM) x
// (8 TN) tile.  kAligned: k and n are multiples of 16 bytes' worth of
// elements and every pointer is 16-byte aligned, so the tiles are copied
// by cp.async.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool kAligned>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
              int m, int k, int n) {
  using Tl = Tiles<T, BM, BN, BK>;
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kLanesN = 8, kLanesM = 32 / kLanesN;
  constexpr int kWarpsN = BN / (kLanesN * TN);
  constexpr int kGroups = TN / 4;        // column groups of four per thread
  constexpr int kVec = Tl::kVec, kLDA = Tl::kLDA;
  static_assert(TN % 4 == 0 && BK % 4 == 0 && BK % kVec == 0 && BN % kVec == 0,
                "tiles are 16-byte chunks and register blocks float4 groups");
  static_assert(BN % (kLanesN * TN) == 0 && BM % (kLanesM * TM) == 0 &&
                    (BM / (kLanesM * TM)) * kWarpsN * 32 == kThreads,
                "the warps tile the block");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / kWarpsN) * (kLanesM * TM) + lane / kLanesN;   // first row
  const int tx = (warp % kWarpsN) * (kLanesN * TN) + (lane % kLanesN) * 4;   // first column
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int steps = (k + BK - 1) / BK;

  // stage kt: the a tile (BM x BK, rows kLDA apart), then the b tile (BK x BN)
  auto load_stage = [&](int kt) {
    T* as = smem + (kt % kStages) * Tl::kStage;
    T* bs = as + BM * kLDA;
    const int k0 = kt * BK;
    if (kAligned) {
      for (int e = tid; e < BM * (BK / kVec); e += kThreads) {
        const int r = e / (BK / kVec), ch = e % (BK / kVec);
        const int gr = row0 + r, gk = k0 + ch * kVec;
        const bool ok = gr < m && gk < k;
        cp_async_16(as + r * kLDA + ch * kVec, ok ? a + (size_t)gr * k + gk : a, ok);
      }
      for (int e = tid; e < BK * (BN / kVec); e += kThreads) {
        const int r = e / (BN / kVec), ch = e % (BN / kVec);
        const int gk = k0 + r, gc = col0 + ch * kVec;
        const bool ok = gk < k && gc < n;
        cp_async_16(bs + r * BN + ch * kVec, ok ? b + (size_t)gk * n + gc : b, ok);
      }
    } else {
      const T zero = from_f32<T>(0.f);
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        as[r * kLDA + kk] = (gr < m && gk < k) ? a[(size_t)gr * k + gk] : zero;
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int r = e / BN, j = e % BN;
        const int gk = k0 + r, gc = col0 + j;
        bs[r * BN + j] = (gk < k && gc < n) ? b[(size_t)gk * n + gc] : zero;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load_stage(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();     // this thread's copies of stage kt have landed
    __syncthreads();                  // everyone's have, and stage kt - 1 is free
    if (kt + kStages - 1 < steps) load_stage(kt + kStages - 1);
    cp_async_commit();
    const T* as = smem + (kt % kStages) * Tl::kStage;
    const T* bs = as + BM * kLDA;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 av[TM];                  // four k values of each of the thread's rows
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = load4(as + (ty + i * kLanesM) * kLDA + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 x = load4(bs + (kq + kk) * BN + tx + g * kLanesN * 4);
          bv[4 * g] = x.x; bv[4 * g + 1] = x.y; bv[4 * g + 2] = x.z; bv[4 * g + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = component(av[i], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * kLanesM;
    if (r >= m) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int cc = col0 + tx + g * kLanesN * 4;
      T* dst = c + (size_t)r * n + cc;
      if (kAligned && cc + 3 < n) {
        store4(dst, acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cc + j < n) dst[j] = from_f32<T>(acc[i][4 * g + j]);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN, bool kAligned>
int launch(const void* a, const void* b, void* c, int m, int k, int n, cudaStream_t s) {
  constexpr size_t smem = Tiles<T, BM, BN, BK>::kSmem;
  auto kernel = matmul_kernel<T, BM, BN, BK, TM, TN, kAligned>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, (BM / TM) * (BN / TN), smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, k, n);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch_tile(const void* a, const void* b, void* c, int m, int k, int n, cudaStream_t s) {
  if ((m + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  constexpr int vec = 16 / sizeof(T);
  const bool aligned = k % vec == 0 && n % vec == 0 &&
                       ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
  if (aligned) return launch<T, BM, BN, BK, TM, TN, true>(a, b, c, m, k, n, s);
  return launch<T, BM, BN, BK, TM, TN, false>(a, b, c, m, k, n, s);
}

// tile 0: 64 x 32 (128 threads, 4 x 4 each); tile 1: 128 x 128 (256, 8 x 8)
template <typename T>
int dispatch(const void* a, const void* b, void* c, int m, int k, int n, int tile,
             cudaStream_t s) {
  if (tile == 0) return launch_tile<T, 64, 32, 32, 4, 4>(a, b, c, m, k, n, s);
  if (tile == 1) return launch_tile<T, 128, 128, 32, 8, 8>(a, b, c, m, k, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int repro_matmul(const void* a, const void* b, void* c, int m, int k, int n, int tile,
                 int dtype, void* stream) {
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, c, m, k, n, tile, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, b, c, m, k, n, tile, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
