// Fused bias + leaky ReLU with gain: out = scale * leaky_relu(x + bias,
// negative_slope), for sm_90a.
//
// Replaces the TPU kernel `fused_leaky_relu_pallas` of
// conditional_score_diffusion_tpu/ops/pallas_kernels.py (:188, its body
// `_bias_act_kernel`), the counterpart of the XLA op `fused_leaky_relu`
// (ops/fused_act.py:16).  Entry: fused_bias_act_launch.
//
// x and out have any shape, flattened to n elements whose last axis has c
// channels; bias (c,) runs along that axis and is optional.  x, bias and out
// are all float32 or all bfloat16 (T).  Each element is computed in float32:
// h = x + bias, then (h >= 0 ? h : negative_slope * h) * scale, rounded to T
// once.  In float32 that is the JAX function's arithmetic, operation for
// operation (no FMA can form: a sum followed by products).
//
// Design: one grid-stride loop over the elements.  Where c is a multiple of 4
// and x, bias and out are aligned for it, each thread moves 4 elements at a
// time (one 16-byte float4 for float32, one 8-byte load of 4 bfloat16); the 4
// share one row, so their bias index is (i % c) .. +3.  Otherwise every load
// is one scalar.  The bias is indexed in place (a c-element array that stays
// in L1/L2), never broadcast to x's shape as the TPU kernel does; the TPU
// kernel's whole-array VMEM blocks (no grid) are not carried over, so any
// size is taken.  Indices are 32-bit when n fits, else 64-bit.
//
// What bounds it on an H100: 3 operations per element against one read of x
// and one write of out, so it is bound by bytes: the least time is
// (2 * n + c) * sizeof(T) / 3.35 TB/s.  Its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads per SM, then grid-stride

struct Act {
  float slope, scale;
  __device__ __forceinline__ float operator()(float v, float b) const {
    const float h = __fadd_rn(v, b);
    return __fmul_rn(h >= 0.f ? h : __fmul_rn(slope, h), scale);
  }
};

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

// 4 elements of T moved as one load and one store.
template <typename T>
struct Pack4;

template <>
struct Pack4<float> {
  using V = float4;
  static __device__ __forceinline__ void unpack(const V& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ V pack(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
};

template <>
struct Pack4<__nv_bfloat16> {
  using V = uint2;  // 4 bfloat16
  static __device__ __forceinline__ void unpack(const V& v, float* f) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    f[0] = __low2float(lo); f[1] = __high2float(lo); f[2] = __low2float(hi); f[3] = __high2float(hi);
  }
  static __device__ __forceinline__ V pack(const float* f) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    V v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    return v;
  }
};

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
bias_act_scalar_kernel(const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ out, I n, I c,
                       Act act) {
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    const float b = bias ? Cvt<T>::to_f(bias[i % c]) : 0.f;
    out[i] = Cvt<T>::from_f(act(Cvt<T>::to_f(x[i]), b));
  }
}

// n and c are multiples of 4; nv = n / 4 vectors.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
bias_act_vec4_kernel(const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ out, I nv, I c,
                     Act act) {
  using P = Pack4<T>;
  using V = typename P::V;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* bv = reinterpret_cast<const V*>(bias);
  V* ov = reinterpret_cast<V*>(out);
  const I cv = c / 4;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; v < nv; v += stride) {
    float f[4], b[4] = {0.f, 0.f, 0.f, 0.f};
    P::unpack(xv[v], f);
    if (bias) P::unpack(bv[v % cv], b);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = act(f[k], b[k]);
    ov[v] = P::pack(f);
  }
}

unsigned grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool aligned(const void* p, size_t bytes) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, typename I>
void run(const T* x, const T* bias, T* out, int64_t n, int64_t c, Act act, cudaStream_t s) {
  constexpr size_t kVecBytes = 4 * sizeof(T);
  if (c % 4 == 0 && aligned(x, kVecBytes) && aligned(bias, kVecBytes) && aligned(out, kVecBytes))
    bias_act_vec4_kernel<T, I><<<grid_for(n / 4), kThreads, 0, s>>>(x, bias, out, static_cast<I>(n / 4),
                                                                     static_cast<I>(c), act);
  else
    bias_act_scalar_kernel<T, I><<<grid_for(n), kThreads, 0, s>>>(x, bias, out, static_cast<I>(n),
                                                                   static_cast<I>(c), act);
}

template <typename T>
int launch(const void* x, const void* bias, void* out, int64_t n, int64_t c, Act act, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (n + kThreads * static_cast<int64_t>(kMaxBlocks) < (int64_t{1} << 32))
    run<T, uint32_t>(xt, bt, ot, n, c, act, s);
  else
    run<T, uint64_t>(xt, bt, ot, n, c, act, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, bias (nullptr for none) and out: n elements, c channels on the last axis
// (n a multiple of c); dtype: 0 float32, 1 bfloat16.  Returns 0 or a
// cudaError_t.
extern "C" int fused_bias_act_launch(const void* x, const void* bias, void* out, long long n, long long c,
                                     float negative_slope, float scale, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Act act{negative_slope, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, bias, out, n, c, act, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, bias, out, n, c, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fused_bias_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
