// Separable 4-tap FIR resampling at factor 2 (NCSN++ with fir=True), for
// sm_90a.
//
// Replaces two TPU kernels of
// conditional_score_diffusion_tpu/ops/pallas_kernels.py:
//   - `fir_upsample2` (:131, its body `_up_kernel`):
//     upfirdn2d(x, k2d * 4, up=2, pad=(2, 1)), entry fir_upsample2_launch;
//   - `fir_downsample2` (:156, its body `_down_kernel`):
//     upfirdn2d(x, k2d, down=2, pad=(1, 1)), entry fir_downsample2_launch.
//
// With the per-axis taps c0..c3 (k / sum(k) * gain, gain 2 for up and 1 for
// down, passed per call) and zeros outside the image, on both axes:
//   up:   out[2t] = c3*x[t-1] + c1*x[t]      out[2t+1] = c2*x[t] + c0*x[t+1]
//   down: out[t]  = c3*x[2t-1] + c2*x[2t] + c1*x[2t+1] + c0*x[2t+2]
//
// x and out are NHWC, both float32 or both bfloat16 (T); the taps' products
// are summed in float32 and the output is rounded to T once.  Any channel
// count is taken (the input and output pyramids have 6): every load is one
// scalar, so no row is read past its end.  The caller checks that H and W
// are even for the downsample.
//
// Design: one thread per output element, channels fastest, so a warp reads
// and writes consecutive addresses of one or a few pixels; a grid-stride loop
// covers the tensor.  No shared memory: the 2x2 (up) or 4x4 (down) input
// pixels an output needs are re-read by its neighbours from L1/L2, not from
// device memory.  The TPU kernel's halo DMA, pre-padding and tile picking
// exist for VMEM and are not carried over.
//
// What bounds it on an H100: 4 (up) or 16 (down) multiply-adds per output
// element against one read of x and one write of out, so at every shape of
// the NCSN++ sampler (B=8; 5x5 to 160x160; 6 to 256 channels) it is bound by
// bytes: the least time is (|x| + |out|) / 3.35 TB/s.  Its times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads per SM, then grid-stride

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

struct Taps {
  float c0, c1, c2, c3;
};

// The two input rows (or columns) of output position o of the upsample, with
// their taps: (t-1, c3), (t, c1) for even o; (t, c2), (t+1, c0) for odd o.
__device__ __forceinline__ void up_phase(int o, const Taps& c, int& i0, float& w0, int& i1, float& w1) {
  const int t = o >> 1;
  if (o & 1) {
    i0 = t;
    w0 = c.c2;
    i1 = t + 1;
    w1 = c.c0;
  } else {
    i0 = t - 1;
    w0 = c.c3;
    i1 = t;
    w1 = c.c1;
  }
}

template <typename T>
__global__ void fir_up2_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int H, int W, int C,
                               Taps c) {
  const int Ho = 2 * H, Wo = 2 * W;
  const int64_t total = (int64_t)B * Ho * Wo * C;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int ch = (int)(i % C);
    int64_t r = i / C;
    const int ox = (int)(r % Wo);
    r /= Wo;
    const int oy = (int)(r % Ho);
    const int b = (int)(r / Ho);
    int ys[2], xs[2];
    float wy[2], wx[2];
    up_phase(oy, c, ys[0], wy[0], ys[1], wy[1]);
    up_phase(ox, c, xs[0], wx[0], xs[1], wx[1]);
    const T* xb = x + (int64_t)b * H * W * C + ch;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (ys[a] < 0 || ys[a] >= H) continue;
      float row = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (xs[s] < 0 || xs[s] >= W) continue;
        row += wx[s] * Cvt<T>::to_f(xb[((int64_t)ys[a] * W + xs[s]) * C]);
      }
      acc += wy[a] * row;
    }
    out[i] = Cvt<T>::from_f(acc);
  }
}

template <typename T>
__global__ void fir_down2_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int H, int W, int C,
                                 Taps c) {
  const int Ho = H / 2, Wo = W / 2;
  const float w[4] = {c.c3, c.c2, c.c1, c.c0};  // for input offsets -1, 0, 1, 2 from 2t
  const int64_t total = (int64_t)B * Ho * Wo * C;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int ch = (int)(i % C);
    int64_t r = i / C;
    const int ox = (int)(r % Wo);
    r /= Wo;
    const int oy = (int)(r % Ho);
    const int b = (int)(r / Ho);
    const T* xb = x + (int64_t)b * H * W * C + ch;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int yy = 2 * oy - 1 + a;
      if (yy < 0 || yy >= H) continue;
      float row = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int xx = 2 * ox - 1 + s;
        if (xx < 0 || xx >= W) continue;
        row += w[s] * Cvt<T>::to_f(xb[((int64_t)yy * W + xx) * C]);
      }
      acc += w[a] * row;
    }
    out[i] = Cvt<T>::from_f(acc);
  }
}

int grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
int launch(bool up, const void* x, void* out, int B, int H, int W, int C, Taps c, cudaStream_t stream) {
  const int64_t total = up ? (int64_t)B * 4 * H * W * C : (int64_t)B * (H / 2) * (W / 2) * C;
  if (total == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (up)
    fir_up2_kernel<T><<<grid_for(total), kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                                B, H, W, C, c);
  else
    fir_down2_kernel<T><<<grid_for(total), kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                                  static_cast<T*>(out), B, H, W, C, c);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool up, const void* x, void* out, int B, int H, int W, int C, float c0, float c1, float c2,
             float c3, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (!up && (H % 2 != 0 || W % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Taps c{c0, c1, c2, c3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(up, x, out, B, H, W, C, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(up, x, out, B, H, W, C, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns 0 or a cudaError_t.
extern "C" int fir_upsample2_launch(const void* x, void* out, int B, int H, int W, int C, float c0, float c1,
                                    float c2, float c3, int dtype, void* stream) {
  return dispatch(true, x, out, B, H, W, C, c0, c1, c2, c3, dtype, stream);
}

extern "C" int fir_downsample2_launch(const void* x, void* out, int B, int H, int W, int C, float c0,
                                      float c1, float c2, float c3, int dtype, void* stream) {
  return dispatch(false, x, out, B, H, W, C, c0, c1, c2, c3, dtype, stream);
}

extern "C" const char* fir_resample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
