// Fused GroupNorm -> SiLU -> 3x3 SAME conv (+ bias, + temb) for sm_90a.
//
// Replaces the TPU kernel `gn_silu_conv3x3_hmajor`
// (conditional_score_diffusion_tpu/ops/fused_block_pallas.py:107, its body
// `_fused_kernel` :63 and the statistics `group_norm_stats` :44), which the
// DDPM resblock runs on its norm1 -> act -> conv1 tail in eval mode.
//
//   out[b, y, x, o] = bias[o] + temb[b, o]
//       + sum_{dy, dx, i} act[b, y + dy - 1, x + dx - 1, i] * w[o, i, dy, dx]
//   act = silu(gn(x)) inside the image, 0 outside (the SAME padding applies to
//         the activation, not to x)
//
// x and out are NHWC, w is OIHW (PyTorch's own conv layout, so the model's
// parameters are used as they are), gamma/beta/bias/temb float32.  x, w and
// out are all float32 or all bfloat16; GroupNorm statistics and the sums are
// float32 either way.  In bfloat16 the activation is rounded to bfloat16
// before the product, as the TPU kernel rounds it before its MXU dot.
//
// Two launches on the caller's stream:
//   1. gn_stats: one block per (batch, group) takes the group's mean and
//      variance (two passes, float32) and folds GroupNorm's affine into one
//      scale/shift per (batch, channel): act = silu(x * scale + shift).
//   2. gn_silu_conv3x3: one block per (image, 8x8 output tile, 64 output
//      channels).  For each chunk of 16 input channels it loads the 10x10
//      input halo, applies scale/shift and SiLU once per element into shared
//      memory (zero outside the image), stages the chunk's 9 weight taps in
//      shared memory, and accumulates the nine taps in float32 registers:
//      each thread owns 4 pixels x 4 output channels.
//
// What bounds it on an H100: at the shapes the flagship sampler gives it
// (B=8; 20x20x192, 10x10x288, 5x5x288) the work is 2*9*B*H*W*Cin*Cout
// operations on ~2-6 MB of data, so it is bound by operations (float32
// FMAs on the CUDA cores; the bf16 path uses them too).  This first version
// keeps everything on the CUDA cores and tiles 8x8 pixels, which wastes
// lanes at 10x10 and 5x5; tensor cores (wgmma/mma.sync) and tiles fitted to
// the small images are later work.  Its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kEps = 1e-6f;       // GroupNorm epsilon of the DDPM resblock
constexpr int kTile = 8;            // output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 2;    // input halo side
constexpr int kHaloStride = kHalo * kHalo + 1;  // odd: spreads the stores over banks
constexpr int kTN = 64;             // output channels per block
constexpr int kKC = 16;             // input channels per chunk
constexpr int kTapStride = kKC * kTN + 4;  // +4 floats: taps land on other banks
constexpr int kThreads = 256;
constexpr int kStatsThreads = 256;

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

// Sum over the block; every thread gets the total.  blockDim.x is a multiple
// of 32 and at most 1024.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats(const T* __restrict__ x, const float* __restrict__ gamma,
         const float* __restrict__ beta, float* __restrict__ scale,
         float* __restrict__ shift, int HW, int C, int G) {
  __shared__ float red[32];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cpg = C / G;
  const int n = HW * cpg;
  const T* xb = x + (size_t)b * HW * C + (size_t)g * cpg;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s += Cvt<T>::to_f(xb[(size_t)(i / cpg) * C + i % cpg]);
  const float mean = block_sum(s, red) / n;

  float q = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = Cvt<T>::to_f(xb[(size_t)(i / cpg) * C + i % cpg]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) / n + kEps);

  for (int c = threadIdx.x; c < cpg; c += blockDim.x) {
    const int ch = g * cpg + c;
    const float sc = rstd * gamma[ch];
    scale[b * C + ch] = sc;
    shift[b * C + ch] = beta[ch] - mean * sc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_silu_conv3x3(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ shift,
                const float* __restrict__ bias, const float* __restrict__ temb,
                T* __restrict__ out, int H, int W, int Cin, int Cout, int tiles_w) {
  __shared__ float act_s[kKC * kHaloStride];
  __shared__ __align__(16) float w_s[9 * kTapStride];

  const int ty0 = (blockIdx.x / tiles_w) * kTile;
  const int tx0 = (blockIdx.x % tiles_w) * kTile;
  const int n0 = blockIdx.y * kTN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tn = tid & 15;         // output channels n0 + 4*tn .. +3
  const int tm = tid >> 4;         // pixels: row tm/2, columns 4*(tm%2) .. +3
  const int py = tm >> 1, px0 = (tm & 1) * 4;

  const T* xb = x + (size_t)b * H * W * Cin;
  const float* scale_b = scale + (size_t)b * Cin;
  const float* shift_b = shift + (size_t)b * Cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kKC) {
    // Activated halo: channel fastest, so a warp reads 2 pixels x 16
    // contiguous channels.
    for (int i = tid; i < kHalo * kHalo * kKC; i += kThreads) {
      const int k = i % kKC, pos = i / kKC;
      const int hy = ty0 - 1 + pos / kHalo, hx = tx0 - 1 + pos % kHalo;
      const int c = c0 + k;
      float v = 0.f;
      if (hy >= 0 && hy < H && hx >= 0 && hx < W && c < Cin) {
        float a = Cvt<T>::to_f(xb[((size_t)hy * W + hx) * Cin + c]) * scale_b[c] + shift_b[c];
        a = a / (1.f + __expf(-a));
        v = Cvt<T>::to_f(Cvt<T>::from_f(a));
      }
      act_s[k * kHaloStride + pos] = v;
    }
    // Weights of this chunk: w[o][c0 + k][tap] -> w_s[tap][k][o - n0].  For
    // one output channel the chunk's 16 x 9 values are contiguous; a warp
    // reads 8 consecutive of them for each of 4 output channels.
    for (int i = tid; i < kTN * kKC * 9; i += kThreads) {
      const int e8 = i & 7, nsub = (i >> 3) & 3, rest = i >> 5;
      const int sector = rest % (kKC * 9 / 8), nquad = rest / (kKC * 9 / 8);
      const int n = nquad * 4 + nsub;
      const int e = sector * 8 + e8;  // k * 9 + tap
      const int k = e / 9, tap = e % 9;
      const int c = c0 + k, o = n0 + n;
      float v = 0.f;
      if (c < Cin && o < Cout) v = Cvt<T>::to_f(w[((size_t)o * Cin + c) * 9 + tap]);
      w_s[tap * kTapStride + k * kTN + n] = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* arow = act_s + (py + dy) * kHalo + px0 + dx;
      const float* wrow = w_s + tap * kTapStride + tn * 4;
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(wrow + k * kTN);
        const float* ak = arow + k * kHaloStride;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = ak[i];
          acc[i][0] = fmaf(a, bv.x, acc[i][0]);
          acc[i][1] = fmaf(a, bv.y, acc[i][1]);
          acc[i][2] = fmaf(a, bv.z, acc[i][2]);
          acc[i][3] = fmaf(a, bv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  const int oy = ty0 + py;
  if (oy >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ox = tx0 + px0 + i;
    if (ox >= W) continue;
    T* o_ptr = out + (((size_t)b * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tn * 4 + j;
      if (o >= Cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[o];
      if (temb != nullptr) v += temb[(size_t)b * Cout + o];
      o_ptr[o] = Cvt<T>::from_f(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* gamma, const void* beta,
           const void* bias, const void* temb, void* out, void* scale_shift,
           int B, int H, int W, int Cin, int Cout, int G, cudaStream_t stream) {
  float* scale = static_cast<float*>(scale_shift);
  float* shift = scale + (size_t)B * Cin;
  gn_stats<T><<<B * G, kStatsThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), scale, shift, H * W, Cin, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles_h = (H + kTile - 1) / kTile, tiles_w = (W + kTile - 1) / kTile;
  const dim3 grid(tiles_h * tiles_w, (Cout + kTN - 1) / kTN, B);
  gn_silu_conv3x3<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
      static_cast<const float*>(bias), static_cast<const float*>(temb),
      static_cast<T*>(out), H, W, Cin, Cout, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias and temb may be null.  scale_shift
// is float32 scratch of 2 * B * Cin.  Returns a cudaError_t (0 on success).
int gn_silu_conv3x3_launch(const void* x, const void* w, const void* gamma,
                           const void* beta, const void* bias, const void* temb,
                           void* out, void* scale_shift, int B, int H, int W,
                           int Cin, int Cout, int G, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || G <= 0 || Cin % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, gamma, beta, bias, temb, out, scale_shift, B, H, W, Cin, Cout, G, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, gamma, beta, bias, temb, out, scale_shift, B, H, W, Cin,
                                 Cout, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gn_silu_conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
