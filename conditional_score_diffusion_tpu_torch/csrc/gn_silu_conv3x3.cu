// GroupNorm -> SiLU -> 3x3 SAME conv (+ bias, + temb) for sm_90a.
//
// Replaces the TPU kernel `gn_silu_conv3x3_hmajor`
// (conditional_score_diffusion_tpu/ops/fused_block_pallas.py:107, its body
// `_fused_kernel` :63 and the statistics `group_norm_stats` :44), which the
// DDPM resblock runs on its norm1 -> act -> conv1 tail in eval mode.
//
//   out[b, y, x, o] = bias[o] + temb[b, o]
//       + sum_{dy, dx, i} act[b, y + dy - 1, x + dx - 1, i] * w[dy, dx, i, o]
//   act = silu(gn(x)) inside the image, 0 outside (the SAME padding applies to
//         the activation, not to x)
//
// x and out are NHWC, w is (3, 3, Cin, Cout) contiguous (the wrapper repacks
// the model's OIHW parameter), gamma/beta/bias/temb float32.  x, w and out
// are all float32 or all bfloat16; GroupNorm statistics and the sums are
// float32 either way.  In bfloat16 the activation is rounded to bfloat16
// before the product, as the TPU kernel rounds it before its MXU dot.
//
// Two launches on the caller's stream:
//   1. gn_silu_act: one block per (batch, group) takes the group's mean and
//      variance (two passes, float32; 16-byte loads where the group's
//      channels are a whole number of vectors), folds GroupNorm's affine
//      into one scale/shift per channel, and writes the group's activation
//      silu(x * scale + shift), rounded to the working type, to a scratch
//      tensor of x's shape: each element is activated once.
//   2. the 3x3 implicit-GEMM main loop of csrc/conv3x3_core.cuh on that
//      activation (the SAME padding is the loop's zero fill).
//
// What bounds it on an H100: at the sampler's shapes (B=8: 20x20x192,
// 10x10x288, 5x5x288; the harness's B=16: 16x16x128, 8x8x128, 4x4x192;
// NCSN++ 20x20x128 to 5x5x256) the work is 0.1-2.1 GFLOP on 0.1-3 MB, so
// operations bound it on paper (float32 FMAs on the CUDA cores, bfloat16 on
// the tensor cores) at a few microseconds; in practice a handful of
// 128-pixel tiles cannot fill 132 SMs, and the two launches' fixed costs
// are a large share.  The main loop packs all images' pixels into M (no
// per-image tile to waste at 4x4-10x10) and splits K over a thread-block
// cluster where the tiles are fewer than the SMs.  Activating each element
// as the main loop staged it instead (9 taps x the N tiles of work, an
// exponential and a division each) bounded the bfloat16 tail.  Pass 1 is a
// fixed cost of its own (one block reads each (batch, group)); launching
// pass 2 as its programmatic dependent made the split-8 shapes slower and
// was dropped.

#include "conv3x3_core.cuh"

#include <cstddef>

namespace {

constexpr float kEps = 1e-6f;  // GroupNorm epsilon of the DDPM resblock
constexpr int kActThreads = 256;
constexpr int kInFlight = 16;  // elements a thread loads before it uses the first

// Sum over the block; every thread gets the total.  blockDim.x is a multiple
// of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// V elements of T at p (V * sizeof(T) is 16, or V is 1) to and from float32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&a)[V]) {
  if constexpr (V == 1 && sizeof(T) == 4) {
    a[0] = *reinterpret_cast<const float*>(p);
  } else if constexpr (V == 1) {
    a[0] = __uint_as_float(uint32_t(*reinterpret_cast<const uint16_t*>(p)) << 16);  // bfloat16 -> float32
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t w = k == 0 ? raw.x : k == 1 ? raw.y : k == 2 ? raw.z : raw.w;
      if constexpr (sizeof(T) == 4) {
        a[k] = __uint_as_float(w);
      } else {  // bfloat16 -> float32
        a[2 * k] = __uint_as_float(w << 16);
        a[2 * k + 1] = __uint_as_float(w & 0xffff0000u);
      }
    }
  }
}

// Two float32 values as packed bfloat16 (lo in the low half), nearest even.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(hi), "f"(lo));
  return w;
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&a)[V]) {
  if constexpr (V == 1 && sizeof(T) == 4) {
    *reinterpret_cast<float*>(p) = a[0];
  } else if constexpr (V == 1) {
    uint16_t h;  // float32 -> bfloat16, nearest even
    asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(a[0]));
    *reinterpret_cast<uint16_t*>(p) = h;
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]), __float_as_uint(a[3]));
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16x2(a[0], a[1]), bf16x2(a[2], a[3]), bf16x2(a[4], a[5]),
                                              bf16x2(a[6], a[7]));
  }
}

// f(a, offset, channel) on each of this thread's V-element vectors of the
// group at xb: a holds the vector in float32, offset is its element offset
// from xb, channel its first channel within the group.  The block is laid
// out as rows of `cols` threads, a thread keeping one channel vector and
// stepping through the pixels (no division per element); kInFlight
// elements are loaded before the first f.  V divides cpg.
template <typename T, int V, class F>
__device__ __forceinline__ void for_group(const T* xb, int HW, int C, int cpg, F& f) {
  constexpr int kUnroll = kInFlight / V;
  const int nv = cpg / V;
  const int cols = nv < static_cast<int>(blockDim.x) ? nv : static_cast<int>(blockDim.x);
  const int rows = blockDim.x / cols;
  const int ty = threadIdx.x / cols, tx = threadIdx.x - ty * cols;
  const int first = ty < rows ? ty : HW;  // the threads past the last whole row idle
  for (int j = tx; j < nv; j += cols) {
    for (int p0 = first; p0 < HW; p0 += kUnroll * rows) {
      float a[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int px = p0 + u * rows;
        if (px < HW) load_vec<T, V>(xb + (size_t)px * C + j * V, a[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int px = p0 + u * rows;
        if (px < HW) f(a[u], (size_t)px * C + j * V, j * V);
      }
    }
  }
}

// SiLU in float32: x / (1 + exp(-x)), the exponential IEEE-rounded and the
// division the fast one (2 ulp; the IEEE division calls a slow-path
// routine).  Both keep their relative accuracy for negative x, where SiLU
// is small: no cancellation, unlike x * (1 + tanh(x / 2)) / 2.
__device__ __forceinline__ float silu(float a) { return __fdividef(a, 1.f + expf(-a)); }

// The three passes' per-vector work.
template <int V, bool kSquares>
struct SumOf {  // of the elements, or of their squared distances from mean
  float mean, s;
  __device__ __forceinline__ void operator()(const float (&a)[V], size_t, int) {
#pragma unroll
    for (int e = 0; e < V; ++e) s += kSquares ? (a[e] - mean) * (a[e] - mean) : a[e];
  }
};

template <typename T, int V>
struct Activate {  // silu(x * scale + shift), rounded to T, into act
  const float* gamma;
  const float* beta;
  T* act;  // the group's first element
  float mean, rstd;
  int c0;  // the group's first channel
  __device__ __forceinline__ void operator()(float (&a)[V], size_t off, int c) const {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float sc = rstd * gamma[c0 + c + e];
      a[e] = silu(a[e] * sc + (beta[c0 + c + e] - mean * sc));
    }
    store_vec<T, V>(act + off, a);
  }
};

// Min blocks 1: without it ptxas capped the V = 1 kernels at 48 registers and
// spilled.
template <typename T, int V>
__global__ void __launch_bounds__(kActThreads, 1)
gn_silu_act(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
            T* __restrict__ act, int HW, int C, int G) {
  __shared__ float red[32];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cpg = C / G;
  const int n = HW * cpg;
  const size_t off0 = (size_t)b * HW * C + (size_t)g * cpg;
  const T* xb = x + off0;

  SumOf<V, false> sum{0.f, 0.f};
  for_group<T, V>(xb, HW, C, cpg, sum);
  // The fast division (2 ulp), as in silu: the IEEE one calls a slow-path routine.
  const float mean = __fdividef(block_sum(sum.s, red), static_cast<float>(n));
  SumOf<V, true> sq{mean, 0.f};
  for_group<T, V>(xb, HW, C, cpg, sq);
  const float rstd = rsqrtf(__fdividef(block_sum(sq.s, red), static_cast<float>(n)) + kEps);

  Activate<T, V> activate{gamma, beta, act + off0, mean, rstd, g * cpg};
  for_group<T, V>(xb, HW, C, cpg, activate);
}

template <typename T>
int launch_act(const void* x, const void* gamma, const void* beta, void* act, int B, int HW, int C, int G,
               cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (C / G) % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(act) % 16 == 0;
  auto kernel = vec ? gn_silu_act<T, V> : gn_silu_act<T, 1>;
  kernel<<<B * G, kActThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const float*>(gamma),
                                             static_cast<const float*>(beta), static_cast<T*>(act), HW, C, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias and temb may be null.  act is
// scratch of x's shape and type.  The plan (bm, bn, bk, stages, splits,
// smem bytes, a_vec, b_vec) is the host's (ops/conv3x3.py:launch_plan),
// checked against the compiled configurations.  Returns a cudaError_t (0 on
// success).
int gn_silu_conv3x3_launch(const void* x, const void* w, const void* gamma, const void* beta,
                           const void* bias, const void* temb, void* out, void* act, int B, int H,
                           int W, int Cin, int Cout, int G, int dtype, int bm, int bn, int bk,
                           int stages, int splits, int smem, int a_vec, int b_vec, void* stream) {
  if (!conv3x3_core::dims_ok(B, H, W, Cin, Cout) || G <= 0 || Cin % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = launch_act<float>(x, gamma, beta, act, B, H * W, Cin, G, s);
  else if (dtype == 1)
    err = launch_act<__nv_bfloat16>(x, gamma, beta, act, B, H * W, Cin, G, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;

  const conv3x3_core::Problem p = {
      act, w, static_cast<const float*>(bias), static_cast<const float*>(temb), out,
      B * H * W, H, W, Cin, Cout,
      H * W * Cin, W * Cin, Cin, H * W * Cout, W * Cout, Cout,  // NHWC in and out
      a_vec, b_vec};
  const conv3x3_core::Plan plan = {bm, bn, bk, stages, splits, smem};
  return conv3x3_core::launch(dtype, p, plan, s);
}

const char* gn_silu_conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
