// The GroupNorm -> SiLU pass shared by csrc/gn_silu_conv3x3.cu (TPU kernel 1)
// and csrc/resblock_fused.cu (TPU kernels 2 and 3), for sm_90a.
//
//   act[b, y, x, c] = silu(src[b, y, x, c] * scale[b, c] + shift[b, c])   rounded to Tout
//   scale = rstd[b, g(c)] * gamma[c], shift = beta[c] - mean[b, g(c)] * scale
//
// src is NHWC of Tin, one tensor or (kSplit) the virtual concat cat(xa, xb)
// of Ca + Cb channels, which is never materialised: each channel is read
// from the half it lies in, so a group that straddles channel Ca is exact.
// act is NHWC of Tout with Ca + Cb channels.  Statistics are float32 (two
// passes: the mean, then the mean squared distance from it).
//
// One block per (batch, group).  A thread keeps one channel vector and
// steps through the pixels (no division per element), with kInFlight
// elements loaded before the first is used; vectors are 16 bytes of Tin
// where the group's channels, both halves' widths and the pointers allow it,
// so no vector crosses channel Ca, else one element.
//
// Internal linkage, as csrc/conv3x3_core.cuh: each library that includes
// this header keeps its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace gn_silu {
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

// V elements of T at p (V * sizeof(T) is 16, or V is 1) to float32.
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

// V float32 values to V elements of T at p: one element, or 16 bytes, or
// (four float32 values to bfloat16) 8 bytes.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&a)[V]) {
  if constexpr (V == 1 && sizeof(T) == 4) {
    *reinterpret_cast<float*>(p) = a[0];
  } else if constexpr (V == 1) {
    uint16_t h;  // float32 -> bfloat16, nearest even
    asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(a[0]));
    *reinterpret_cast<uint16_t*>(p) = h;
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "16 bytes of float32");
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]), __float_as_uint(a[3]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2(a[0], a[1]), bf16x2(a[2], a[3]));
  } else {
    static_assert(V == 8, "16 bytes of bfloat16");
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16x2(a[0], a[1]), bf16x2(a[2], a[3]), bf16x2(a[4], a[5]),
                                              bf16x2(a[6], a[7]));
  }
}

// Where channel c of the group (its first channel c0) lies at pixel px of
// one image: one tensor of C channels, or cat(xa, xb).
template <typename T, bool kSplit>
struct Source;

template <typename T>
struct Source<T, false> {
  const T* x;  // the group's first element
  int C;
  __device__ __forceinline__ const T* at(int px, int c) const { return x + (size_t)px * C + c; }
};

template <typename T>
struct Source<T, true> {
  const T* xa;  // the image's first element of each half
  const T* xb;
  int Ca, Cb, c0;
  __device__ __forceinline__ const T* at(int px, int c) const {
    const int ch = c0 + c;
    return ch < Ca ? xa + (size_t)px * Ca + ch : xb + (size_t)px * Cb + (ch - Ca);
  }
};

// f(a, px, c) on each of this thread's V-element vectors of the group: a
// holds the vector in float32, px its pixel, c its first channel within the
// group.  The block is laid out as rows of `cols` threads; V divides cpg.
template <typename T, int V, class S, class F>
__device__ __forceinline__ void for_group(const S& src, int HW, int cpg, F& f) {
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
        if (px < HW) load_vec<T, V>(src.at(px, j * V), a[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int px = p0 + u * rows;
        if (px < HW) f(a[u], px, j * V);
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
  __device__ __forceinline__ void operator()(const float (&a)[V], int, int) {
#pragma unroll
    for (int e = 0; e < V; ++e) s += kSquares ? (a[e] - mean) * (a[e] - mean) : a[e];
  }
};

template <typename Tout, int V>
struct Activate {  // silu(x * scale + shift), rounded to Tout, into act
  const float* gamma;  // the group's first channel
  const float* beta;
  Tout* act;  // the group's first element
  float mean, rstd;
  int C;  // act's channels
  __device__ __forceinline__ void operator()(float (&a)[V], int px, int c) const {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float sc = rstd * gamma[c + e];
      a[e] = silu(a[e] * sc + (beta[c + e] - mean * sc));
    }
    store_vec<Tout, V>(act + (size_t)px * C + c, a);
  }
};

// Min blocks 1: without it ptxas capped the V = 1 kernels at 48 registers and
// spilled.
template <typename Tin, typename Tout, int V, bool kSplit>
__global__ void __launch_bounds__(kActThreads, 1)
gn_silu_act(const Tin* __restrict__ xa, const Tin* __restrict__ xb, int Ca, int Cb, const float* __restrict__ gamma,
            const float* __restrict__ beta, Tout* __restrict__ act, int HW, int G) {
  __shared__ float red[32];
  const int C = Ca + Cb;
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cpg = C / G, c0 = g * cpg;
  const int n = HW * cpg;

  Source<Tin, kSplit> src;
  if constexpr (kSplit) {
    src = {xa + (size_t)b * HW * Ca, xb + (size_t)b * HW * Cb, Ca, Cb, c0};
  } else {
    src = {xa + (size_t)b * HW * C + c0, C};
  }

  SumOf<V, false> sum{0.f, 0.f};
  for_group<Tin, V>(src, HW, cpg, sum);
  // The fast division (2 ulp), as in silu: the IEEE one calls a slow-path routine.
  const float mean = __fdividef(block_sum(sum.s, red), static_cast<float>(n));
  SumOf<V, true> sq{mean, 0.f};
  for_group<Tin, V>(src, HW, cpg, sq);
  const float rstd = rsqrtf(__fdividef(block_sum(sq.s, red), static_cast<float>(n)) + kEps);

  Activate<Tout, V> activate{gamma + c0, beta + c0, act + (size_t)b * HW * C + c0, mean, rstd, C};
  for_group<Tin, V>(src, HW, cpg, activate);
}

// One launch of the pass over B images of HW pixels: src xa (Ca channels)
// or (kSplit) cat(xa, xb) (Ca + Cb channels); G groups.  Returns a
// cudaError_t.
template <typename Tin, typename Tout, bool kSplit>
int launch_act(const void* xa, const void* xb, int Ca, int Cb, const void* gamma, const void* beta, void* act,
               int B, int HW, int G, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(Tin);
  if (!kSplit) Cb = 0;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = ((Ca + Cb) / G) % V == 0 && Ca % V == 0 && Cb % V == 0 && aligned(xa) &&
                   (!kSplit || aligned(xb)) && aligned(act);
  auto kernel = vec ? gn_silu_act<Tin, Tout, V, kSplit> : gn_silu_act<Tin, Tout, 1, kSplit>;
  kernel<<<B * G, kActThreads, 0, stream>>>(static_cast<const Tin*>(xa), static_cast<const Tin*>(xb), Ca, Cb,
                                             static_cast<const float*>(gamma), static_cast<const float*>(beta),
                                             static_cast<Tout*>(act), HW, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gn_silu
