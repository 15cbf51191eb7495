// 3x3 SAME stride-1 convolution (+ bias) for sm_90a: the forward of every
// 3x3 stride-1 conv of the flagship train step and, with the weights rotated
// by 180 degrees and Cin/Cout swapped, its input gradient.
//
// Replaces the TPU kernels `conv3x3_pallas`
// (conditional_score_diffusion_tpu/ops/conv_pallas.py:198; pallas_call :90 in
// `_conv3x3_pallas_fwd_impl` :76) and `conv3x3_hmajor` (:144; pallas_call
// :159), the same conv on an (H, W, B, C) layout.
//
//   out[b, y, x, o] = bias[o] + sum_{dy, dx, i} in[b, y + dy - 1, x + dx - 1, i] * w[dy, dx, i, o]
//   in outside the image is 0 (the SAME padding, by bounds checks: no padded copy)
//
// Layout: channels are contiguous; an element (b, y, x, c) of `in` is at
// b * xsb + y * xsh + x * xsw + c, and of `out` at b * osb + y * osh + x * osw
// + c.  NHWC is (xsb, xsh, xsw) = (H*W*C, W*C, C); (H, W, B, C), the TPU
// kernel 5's layout, is (C, W*B*C, B*C): one kernel serves both.  `w` is
// (3, 3, Cin, Cout) contiguous (the wrapper repacks PyTorch's OIHW once per
// call), `bias` float32 or null.  in, w and out are all float32 or all
// bfloat16; the sums are float32 and the output is rounded once.  Indices are
// 32-bit: the wrapper refuses tensors of 2**31 elements or more.
//
// Design: an implicit GEMM, M = B*H*W pixels, N = Cout, K = 9*Cin.  One
// block of 256 threads owns 64 consecutive pixels (of any images: no waste
// at 5x5) x 16*CO output channels; each thread keeps 4 pixels x CO output
// channels in float32 registers.  The K loop runs over the 9 taps and, per
// tap, chunks of 16 input channels: the block gathers the 64 pixels' shifted
// inputs (zero outside the image or past Cin, so Cin = 6 and uneven split
// halves need no special case; scalar loads, so no load assumes C % 4 == 0)
// and the chunk's 16 x 16*CO weights into shared memory, then runs 16 rank-1
// updates.  CO (1, 2, 4 or 6) is chosen per call to waste the fewest output
// channels: the flagship's widths are multiples of 96, so CO = 6 (96 output
// channels a block) there, and CO = 1 for its 6-channel output conv.
//
// What bounds it on an H100: 2*9*M*Cin*Cout operations on x, w and out
// read or written once (the 160x160x96 train-step convs at B=16: 68 GFLOP on
// ~315 MB), so float32 operations: 67 TFLOP/s on the CUDA cores, ~1 ms a
// call.  This first version uses the CUDA cores for bfloat16 too and does not
// overlap the loads with the FMAs beyond what occupancy gives; tensor cores
// (mma/wgmma for bfloat16; TF32 stays off for float32 parity), TMA and a
// double-buffered K loop are later work.  Its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;             // pixels per block
constexpr int kBK = 16;             // input channels per chunk
constexpr int kThreads = 256;       // 16 pixel rows x 16 channel columns
constexpr int kAStride = kBM + 2;   // a_s row: 2-float pad puts a warp's stores on 32 banks

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
};

template <typename T, int CO>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out, int M, int H,
               int W, int Cin, int Cout, int xsb, int xsh, int xsw, int osb, int osh,
               int osw) {
  constexpr int kBN = 16 * CO;
  __shared__ __align__(16) float a_s[kBK * kAStride];  // [k][pixel]
  __shared__ __align__(16) float b_s[kBK * kBN];       // [k][output channel]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int HW = H * W;

  // Loader role: input channel lk of the pixels lp + 16*j, j < 4, so a warp
  // reads 16 contiguous channels of each of 2 pixels.
  const int lk = tid & 15, lp = tid >> 4;
  int pb[4], py[4], px[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + lp + 16 * j;
    if (m < M) {
      const int b = m / HW, r = m - b * HW;
      py[j] = r / W;
      px[j] = r - py[j] * W;
      pb[j] = b * xsb;
    } else {
      py[j] = -2;  // every tap falls outside the image
      px[j] = 0;
      pb[j] = 0;
    }
  }

  // Compute role: pixels m0 + 4*tm .. +3, output channels n0 + CO*tn .. +CO-1.
  const int tn = tid & 15, tm = tid >> 4;
  float acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const T* wt = w + tap * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
      const int c = c0 + lk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int yy = py[j] + dy, xx = px[j] + dx;
        float v = 0.f;
        if (c < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = Cvt<T>::to_f(x[pb[j] + yy * xsh + xx * xsw + c]);
        a_s[lk * kAStride + lp + 16 * j] = v;
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int k = i / kBN, n = i - k * kBN;
        const int cc = c0 + k, o = n0 + n;
        b_s[i] = (cc < Cin && o < Cout) ? Cvt<T>::to_f(wt[cc * Cout + o]) : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float2 a01 = *reinterpret_cast<const float2*>(a_s + k * kAStride + tm * 4);
        const float2 a23 = *reinterpret_cast<const float2*>(a_s + k * kAStride + tm * 4 + 2);
        const float a[4] = {a01.x, a01.y, a23.x, a23.y};
        float bv[CO];
#pragma unroll
        for (int j = 0; j < CO; ++j) bv[j] = b_s[k * kBN + tn * CO + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CO; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
    const int b = m / HW, r = m - b * HW;
    const int y = r / W, xo = r - y * W;
    T* o_ptr = out + b * osb + y * osh + xo * osw;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int o = n0 + tn * CO + j;
      if (o >= Cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[o];
      o_ptr[o] = Cvt<T>::from_f(v);
    }
  }
}

// Output channels per thread: the one that pads Cout least, the larger on a tie.
int pick_co(int Cout) {
  const int cos[4] = {6, 4, 2, 1};
  int best = 1;
  long best_pad = -1;
  for (int co : cos) {
    const int bn = 16 * co;
    const long pad = (long)((Cout + bn - 1) / bn) * bn - Cout;
    if (best_pad < 0 || pad < best_pad) {
      best = co;
      best_pad = pad;
    }
  }
  return best;
}

template <typename T, int CO>
int launch_co(const void* x, const void* w, const void* bias, void* out, int M, int H, int W,
              int Cin, int Cout, int xsb, int xsh, int xsw, int osb, int osh, int osw,
              cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (Cout + 16 * CO - 1) / (16 * CO));
  conv3x3_kernel<T, CO><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), M, H, W, Cin, Cout, xsb, xsh, xsw, osb, osh, osw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int M, int H, int W,
           int Cin, int Cout, int xsb, int xsh, int xsw, int osb, int osh, int osw,
           cudaStream_t s) {
  switch (pick_co(Cout)) {
    case 6: return launch_co<T, 6>(x, w, bias, out, M, H, W, Cin, Cout, xsb, xsh, xsw, osb, osh, osw, s);
    case 4: return launch_co<T, 4>(x, w, bias, out, M, H, W, Cin, Cout, xsb, xsh, xsw, osb, osh, osw, s);
    case 2: return launch_co<T, 2>(x, w, bias, out, M, H, W, Cin, Cout, xsb, xsh, xsw, osb, osh, osw, s);
    default: return launch_co<T, 1>(x, w, bias, out, M, H, W, Cin, Cout, xsb, xsh, xsw, osb, osh, osw, s);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias may be null.  Strides are in
// elements; the channel stride is 1.  Returns a cudaError_t (0 on success).
int conv3x3_launch(const void* x, const void* w, const void* bias, void* out, int B, int H,
                   int W, int Cin, int Cout, int xsb, int xsh, int xsw, int osb, int osh,
                   int osw, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long m = (long)B * H * W;
  if (m * (Cin > Cout ? Cin : Cout) >= (1L << 31) || 9L * Cin * Cout >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = static_cast<int>(m);
  if (dtype == 0)
    return launch<float>(x, w, bias, out, M, H, W, Cin, Cout, xsb, xsh, xsw, osb, osh, osw, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bias, out, M, H, W, Cin, Cout, xsb, xsh, xsw, osb, osh,
                                 osw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
