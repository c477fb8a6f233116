// Single-channel 2-D convolution for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/conv2d.py:
//   * conv2d_kernel <- conv2d_pallas (_conv_kernel), wrapped by ops.conv2d.
//
// It computes the valid cross-correlation out = x * w of a row-major image
// x (h, w) with taps w (kh, kw), into out (h - kh + 1, w - kw + 1), all of
// one dtype (float32 or bfloat16).  As in _conv_kernel, the image and the
// taps are read as f32, each output is an f32 sum over the taps in the same
// order (row of taps outer, column inner), and it is rounded once to x's
// dtype.  The sum uses one fused multiply-add per tap where the Pallas body
// writes a multiply and an add, so results may differ in the last bit.
//
// What bounds it on the H100: bytes, and below ~512^2 the launch.  At the
// paper's 512^2 image and 5x5 taps it does 2 * 25 flops per output against
// 8 bytes read and written per output in f32, far below the card's balance
// point; at that size the byte bound (~0.6 us) lies below one launch's
// latency, so what a call costs above the launch is the latency of the
// loads a block waits on before it can compute.  At 4096^2 the grid spans
// many waves and the kernel has to stream bytes.
//
// The TPU kernel blocked output rows only (bh = 8) and kept the whole image
// resident in VMEM, slicing an input slab with the halo per row block; the
// wrapper padded rows and sent small images to the oracle.  Here one thread
// block owns one output tile, and:
//   * One load round.  Every thread issues its share of the block's copies
//     before anyone waits: the taps, then each row of the input tile with
//     its halo, all as cp.async 16-byte copies into shared memory, in x's
//     dtype, then one cp.async.wait_group and one __syncthreads.  A row is
//     copied from the 16-byte boundary at or below its first element (the
//     first copy of a row may read up to 15 bytes before it, inside the
//     same 16-byte granule of the allocation) and read at that offset, so
//     rows at any alignment (odd widths, bf16 rows at odd element offsets,
//     where a 4-byte copy could not start) take the same 16-byte copies.
//     Bytes past the image's row or last row are zero-filled by the copy's
//     src-size operand: no predicated loads, no padding copy, and any size
//     runs the kernel (10 x 10 * 5 x 5 included).
//   * Taps fixed at compile time.  conv2d_kernel<T, KH, KW, kTile> is
//     instantiated for the paths' 3x3 (the image pipeline's Laplacian) and
//     5x5 (Table 1), with the taps in registers and every loop unrolled;
//     KH = KW = 0 is the runtime-size instantiation of the same kernel, for
//     any taps up to 32 x 32, its taps read from shared memory.
//   * A register sliding window.  Each thread owns a strip of kRows
//     consecutive output rows in one column; a warp's 32 threads own 32
//     consecutive columns, so its shared-memory reads are 32 consecutive
//     elements of one row (no bank conflicts).  The thread reads each of
//     the kRows + kh - 1 input rows its strip needs once (kw values, into
//     registers) and adds it to every accumulator of the strip that the row
//     feeds: (kRows + kh - 1) * kw shared-memory reads per kRows outputs,
//     where one read per tap would be kh * kw per output.
//   * The same sums.  Accumulator r of a strip receives input rows r, r + 1,
//     ..., r + kh - 1 in turn, each row's columns in order: tap row outer,
//     column inner, one fmaf per tap from 0, as in a direct loop.  So every
//     instantiation and every tile gives the same bits, and the bf16
//     kernel equals the f32 kernel on the widened inputs, rounded once.
//   * Two tiles; the wrapper picks one per call (kernels/conv2d.py,
//     conv2d_plan) and passes its index down:
//       - 0: 32 x 32 outputs, 4 warps of 8-row strips: the paths' 508^2 and
//         382^2 outputs get 256 and 144 blocks, at least one per SM of the
//         132;
//       - 1: 64 x 64 outputs, 8 warps (2 across, 4 down) of 16-row strips,
//         where such tiles give every SM a block (4096^2 gets 4096 blocks):
//         fewer halo bytes per output (68 x 72 staged elements per 64 x 64
//         at 5x5, against 36 x 40 per 32 x 32) and half the tap loads.
//     The largest staged tile (runtime size, tile 1, 32 x 32 taps, f32) is
//     95 rows of 400 bytes plus the taps, 42,112 bytes: under the 48 KB a
//     block gets without opting in.
//
// TMA (cp.async.bulk.tensor with the hardware's out-of-bounds fill) would
// load the tile with one instruction, but needs a tensor map encoded on the
// host for every image, on a call that is already bound by its launch.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for a shape,
// instantiation, tile or dtype it does not take.  taps 0 = runtime size, 1 =
// 3 x 3, 2 = 5 x 5; dtype 0 = float32, 1 = bfloat16; x, w and out are
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 32;        // largest kh and kw
constexpr int kCopy = 16;           // bytes a cp.async copy moves
constexpr size_t kMaxSmem = 48 * 1024;

// An output tile: warps across (32 columns each), warps down, and the rows
// of a thread's strip.
template <int kWarpsX_, int kWarpsY_, int kRows_> struct TileShape {
  static constexpr int kWarpsX = kWarpsX_, kRows = kRows_;
  static constexpr int kThreads = 32 * kWarpsX_ * kWarpsY_;
  static constexpr int kW = 32 * kWarpsX_;            // output columns
  static constexpr int kH = kRows_ * kWarpsY_;        // output rows
};
// the tiles, by the index the wrapper passes
template <int kTile> struct Tile;
template <> struct Tile<0> : TileShape<1, 4, 8> {};
template <> struct Tile<1> : TileShape<2, 4, 16> {};

// Bytes of n elements of esize bytes that start anywhere inside a 16-byte
// granule, rounded up to whole copies: a staged row, or the taps.
__host__ __device__ constexpr int staged_bytes(int n, int esize) {
  return (kCopy - 1 + n * esize + kCopy - 1) / kCopy * kCopy;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// cp.async of the 16 bytes at src (16-byte aligned), of which the first n
// are read and the rest zero-filled (n = 0: nothing is read)
__device__ __forceinline__ void cp_async_16(void* dst, uintptr_t src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(n)
               : "memory");
}

// Copy 16-byte chunk c of the bytes [start, end), counted from the
// boundary at or below start, to dst; bytes at or past end are zeros.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, uintptr_t start,
                                           uintptr_t end, int c) {
  const uintptr_t lo = (start & ~uintptr_t(kCopy - 1)) + (uintptr_t)c * kCopy;
  const int n = lo < end ? (int)(end - lo < kCopy ? end - lo : kCopy) : 0;
  cp_async_16(dst, n ? lo : start & ~uintptr_t(kCopy - 1), n);
}

template <typename T, int KH, int KW, int kTile>
__global__ void __launch_bounds__(Tile<kTile>::kThreads)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
              int h, int wd, int kh_arg, int kw_arg) {
  using D = Tile<kTile>;
  constexpr int kRows = D::kRows;
  constexpr int E = sizeof(T);
  const int kh = KH > 0 ? KH : kh_arg, kw = KW > 0 ? KW : kw_arg;
  const int ih = D::kH + kh - 1;                        // staged rows
  const int rb = staged_bytes(D::kW + kw - 1, E);       // bytes a staged row
  const int chunks = rb / kCopy;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tile = smem;                           // ih rows of rb bytes
  unsigned char* taps = smem + ih * rb;
  const int h_out = h - kh + 1, w_out = wd - kw + 1;
  const int row0 = blockIdx.y * D::kH, col0 = blockIdx.x * D::kW;
  const int tid = threadIdx.x;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);

  // the one load round: taps, then every staged row, before any wait
  const int tap_chunks = staged_bytes(kh * kw, E) / kCopy;
  for (int c = tid; c < tap_chunks; c += D::kThreads)
    copy_chunk(taps + c * kCopy, wa, wa + (uintptr_t)kh * kw * E, c);
  for (int e = tid; e < ih * chunks; e += D::kThreads) {
    const int r = e / chunks, c = e - r * chunks;
    const int gr = row0 + r;
    const uintptr_t row = xa + ((size_t)gr * wd + col0) * E;
    // a row past the image: every byte zero-filled
    const uintptr_t end = gr < h ? xa + ((size_t)gr * wd + wd) * E : 0;
    copy_chunk(tile + r * rb + c * kCopy, gr < h ? row : xa, end, c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = tid / 32;
  const int lc = (warp % D::kWarpsX) * 32 + tid % 32;   // local column
  const int lr0 = (warp / D::kWarpsX) * kRows;         // strip's first row
  const int oc = col0 + lc;
  if (oc >= w_out || row0 + lr0 >= h_out) return;      // no barrier follows
  const T* tp = reinterpret_cast<const T*>(taps + (wa & (kCopy - 1)));
  // staged row lr, from its own 16-byte offset, at this thread's column
  auto staged = [&](int lr) {
    const unsigned shift =
        (unsigned)((xa + ((size_t)(row0 + lr) * wd + col0) * E) & (kCopy - 1));
    return reinterpret_cast<const T*>(tile + lr * rb + shift) + lc;
  };

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if constexpr (KH > 0) {
    float wr[KH * KW];
#pragma unroll
    for (int t = 0; t < KH * KW; ++t) wr[t] = to_f32(tp[t]);
#pragma unroll
    for (int i = 0; i < kRows + KH - 1; ++i) {
      const T* src = staged(lr0 + i);
      float v[KW];
#pragma unroll
      for (int dj = 0; dj < KW; ++dj) v[dj] = to_f32(src[dj]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int di = i - r;                           // tap row input row i gives r
        if (di >= 0 && di < KH) {
#pragma unroll
          for (int dj = 0; dj < KW; ++dj) acc[r] = fmaf(v[dj], wr[di * KW + dj], acc[r]);
        }
      }
    }
  } else {
    for (int i = 0; i < kRows + kh - 1; ++i) {
      const T* src = staged(lr0 + i);
      for (int dj = 0; dj < kw; ++dj) {
        const float v = to_f32(src[dj]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int di = i - r;
          if (di >= 0 && di < kh) acc[r] = fmaf(v, to_f32(tp[di * kw + dj]), acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int orow = row0 + lr0 + r;
    if (orow < h_out) out[(size_t)orow * w_out + oc] = from_f32<T>(acc[r]);
  }
}

template <int kTile>
size_t smem_bytes(int kh, int kw, int esize) {
  using D = Tile<kTile>;
  return (size_t)(D::kH + kh - 1) * staged_bytes(D::kW + kw - 1, esize) +
         staged_bytes(kh * kw, esize);
}

template <typename T, int KH, int KW, int kTile>
int launch(const void* x, const void* w, void* out, int h, int wd, int kh, int kw,
           cudaStream_t s) {
  using D = Tile<kTile>;
  const int h_out = h - kh + 1, w_out = wd - kw + 1;
  const size_t smem = smem_bytes<kTile>(kh, kw, sizeof(T));
  if ((h_out + D::kH - 1) / D::kH > 65535 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w_out + D::kW - 1) / D::kW, (h_out + D::kH - 1) / D::kH);
  conv2d_kernel<T, KH, KW, kTile><<<grid, D::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), h, wd, kh,
      kw);
  return (int)cudaGetLastError();
}

template <typename T, int kTile>
int launch_taps(const void* x, const void* w, void* out, int h, int wd, int kh, int kw,
                int taps, cudaStream_t s) {
  if (taps == 0) return launch<T, 0, 0, kTile>(x, w, out, h, wd, kh, kw, s);
  if (taps == 1 && kh == 3 && kw == 3) return launch<T, 3, 3, kTile>(x, w, out, h, wd, kh, kw, s);
  if (taps == 2 && kh == 5 && kw == 5) return launch<T, 5, 5, kTile>(x, w, out, h, wd, kh, kw, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_tile(const void* x, const void* w, void* out, int h, int wd, int kh, int kw,
                int taps, int tile, cudaStream_t s) {
  if (tile == 0) return launch_taps<T, 0>(x, w, out, h, wd, kh, kw, taps, s);
  if (tile == 1) return launch_taps<T, 1>(x, w, out, h, wd, kh, kw, taps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest kh and kw the kernel takes.
int repro_conv2d_max_taps(void) { return kMaxTaps; }

int repro_conv2d(const void* x, const void* w, void* out, int h, int wd, int kh, int kw,
                 int taps, int tile, int dtype, void* stream) {
  if (kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps || h < kh || wd < kw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tile<float>(x, w, out, h, wd, kh, kw, taps, tile, s);
  if (dtype == 1) return launch_tile<__nv_bfloat16>(x, w, out, h, wd, kh, kw, taps, tile, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
