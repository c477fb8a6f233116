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
// What bounds it on the H100: bytes.  At the paper's 512^2 image and 5x5
// taps it does 2 * 25 flops per output against 8 bytes read and written per
// output in f32, far below the card's balance point; at these sizes the
// bound (~0.6 us) is below one launch's latency.
//
// The TPU kernel blocked output rows only (bh = 8) and kept the whole image
// resident in VMEM, slicing an input slab with the halo per row block; the
// wrapper padded rows and sent small images to the oracle.  Here one thread
// block owns one 32 x 32 output tile: it stages the (32 + kh - 1) x
// (32 + kw - 1) input tile with its halo, and the taps, in shared memory
// as f32, then each of its 32 x 8 threads computes one column of four output
// rows (8 rows apart).  Shared-memory reads of a warp's 32 threads are 32
// consecutive floats of one row; the taps are read by every thread at once
// (a broadcast).  Loads and stores are predicated on the image's and the
// output's edges, so any size runs the kernel (10 x 10 * 5 x 5 included)
// and no padding copy is made.  kh and kw are runtime values up to 32; the
// staged tile then takes at most 63 x 63 floats plus the taps, under the
// 48 KB a block gets without opting in.  The 32 x 32 tile gives 256 blocks
// at 512^2 * 5x5 and 144 at 384^2 * 3x3, at least one per SM of the 132.
//
// Left for later work: reuse of each staged row across a thread's output
// rows in registers, and a wider tile per block for large images.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for a shape or
// dtype it does not take.  dtype 0 = float32, 1 = bfloat16; x, w and out
// are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;                       // output columns per block
constexpr int kTileH = 32;                       // output rows per block
constexpr int kThreadRows = 8;                   // thread rows per block
constexpr int kThreads = kTileW * kThreadRows;   // 256
constexpr int kRowsPerThread = kTileH / kThreadRows;
constexpr int kMaxTaps = 32;                     // largest kh and kw

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
              int h, int wd, int kh, int kw) {
  extern __shared__ float smem[];
  const int ih = kTileH + kh - 1, iw = kTileW + kw - 1;
  float* tile = smem;                 // (ih, iw) input tile with its halo
  float* taps = smem + ih * iw;       // (kh, kw)
  const int h_out = h - kh + 1, w_out = wd - kw + 1;
  const int row0 = blockIdx.y * kTileH, col0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  for (int e = tid; e < kh * kw; e += kThreads) taps[e] = to_f32(w[e]);
  for (int e = tid; e < ih * iw; e += kThreads) {
    const int r = e / iw, cc = e % iw;
    const int gr = row0 + r, gc = col0 + cc;
    tile[e] = (gr < h && gc < wd) ? to_f32(x[(size_t)gr * wd + gc]) : 0.f;
  }
  __syncthreads();

  const int oc = col0 + threadIdx.x;
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int lr = threadIdx.y + rr * kThreadRows;
    const int orow = row0 + lr;
    float acc = 0.f;
    for (int di = 0; di < kh; ++di) {
      const float* src = tile + (lr + di) * iw + threadIdx.x;
      const float* wt = taps + di * kw;
      for (int dj = 0; dj < kw; ++dj) acc = fmaf(src[dj], wt[dj], acc);
    }
    if (orow < h_out && oc < w_out) out[(size_t)orow * w_out + oc] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int h, int wd, int kh, int kw,
           cudaStream_t s) {
  const int h_out = h - kh + 1, w_out = wd - kw + 1;
  const dim3 grid((w_out + kTileW - 1) / kTileW, (h_out + kTileH - 1) / kTileH);
  const size_t smem =
      sizeof(float) * ((size_t)(kTileH + kh - 1) * (kTileW + kw - 1) + (size_t)kh * kw);
  conv2d_kernel<T><<<grid, dim3(kTileW, kThreadRows), smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), h, wd, kh,
      kw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest kh and kw the kernel takes.
int repro_conv2d_max_taps(void) { return kMaxTaps; }

int repro_conv2d(const void* x, const void* w, void* out, int h, int wd, int kh, int kw,
                 int dtype, void* stream) {
  if (kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps || h < kh || wd < kw ||
      (h - kh + 1 + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, h, wd, kh, kw, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, h, wd, kh, kw, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
