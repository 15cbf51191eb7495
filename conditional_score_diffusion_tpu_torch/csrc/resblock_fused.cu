// A whole DDPM resblock in eval mode, and its split-skip decoder variant,
// for sm_90a.
//
// Replaces two TPU kernels of
// conditional_score_diffusion_tpu/ops/fused_block_pallas.py:
//   - `resblock_fused_lowres` (:269, its body `_resblock_kernel` :204):
//     entry resblock_fused_launch with skip == nullptr;
//   - `resblock_fused_lowres_split` (:462, its body `_resblock_split_kernel`
//     :384): entry resblock_fused_launch with a skip tensor, the block on the
//     virtual concat cat(x, skip) (channels [0, Ca) from x, [Ca, Ca+Cb) from
//     skip), which is never materialised.
//
//   h   = conv3x3(silu(GN0(x)), w0) + (b0 + temb)        kept in float32
//   h1  = conv3x3(silu(GN1(h)), w1) + (b1 + bs)
//   res = x (identity) or x @ ws (channel mix), float32 sums
//   out = (res + h1) * res_scale                          rounded to T once
//
// x, skip and out are NHWC, w0/w1 OIHW (PyTorch's conv layout), ws (Cin,
// Cout); x, skip, w0, w1, ws and out are all float32 or all bfloat16 (T);
// gamma/beta/b0/temb/b1/bs are float32.  As in the TPU kernel, GroupNorm
// statistics are float32, each activation is rounded to T before its conv,
// every sum is float32, and h stays float32 between conv0 and GN1.
//
// Four launches on the caller's stream, no allocation (the wrapper passes a
// float32 scratch of 2*B*Cin + 2*B*Cout + B*H*W*Cout):
//   1. gn_stats over x (and skip): one block per (batch, group) takes the
//      group's mean and variance in two float32 passes, reading each channel
//      from the half it lies in, so a group that straddles the concat
//      boundary is exact; it folds GroupNorm's affine into one scale/shift
//      per (batch, channel).
//   2. conv3x3_act, conv0: an implicit GEMM with M = B*H*W pixels (across
//      images), N = Cout, K = 9*Cin.  A block owns 32 pixels x 32 output
//      channels; for each chunk of 16 input channels it gathers the nine
//      taps' activations silu(x*scale+shift) of its pixels into shared
//      memory (0 outside the image: SAME padding applies to the activation),
//      stages the chunk's weights, and accumulates in float32 registers,
//      4 pixels x 4 channels a thread.  Out: float32 h.
//   3. gn_stats over h.
//   4. conv3x3_act, conv1 with the residual: the same GEMM over silu(GN1(h)),
//      then (channel mix) one more K loop over x's channels against ws into
//      a second accumulator, then the residual, the bias and the scale.
//
// What bounds it on an H100: at the flagship sampler's shapes (B=8; 10x10
// and 5x5, 192-576 channels in, 288 out) the work is 2*9*B*H*W*(Cin+Cout)*
// Cout (+ 2*B*H*W*Cin*Cout for a mix shortcut) operations on ~1-4 MB of
// data, so it is bound by operations.  This first version keeps the sums on
// the CUDA cores in float32 for both types, and fills the card only partly:
// a 5x5 block gives 7 x 9 = 63 blocks of 64 threads.  Keeping h in shared
// memory in one persistent launch (clusters, DSMEM) and moving the convs onto
// mma/wgmma are later work; its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kEps = 1e-6f;       // GroupNorm epsilon of the DDPM resblock
constexpr int kTM = 32;             // output pixels per block
constexpr int kTN = 32;             // output channels per block
constexpr int kKC = 16;             // input channels per staged chunk
constexpr int kThreads = 64;        // (kTM / 4) x (kTN / 4): 4 x 4 outputs a thread
// Shared-memory strides in floats: multiples of 4 keep the float4 reads
// aligned; the +4 pads move each channel row and each tap onto other banks.
constexpr int kAStride = kTM + 4;
constexpr int kBStride = kTN + 4;
constexpr int kTapStride = kKC * kAStride + 4;  // == kKC * kBStride + 4
constexpr int kStatsThreads = 256;

static_assert(kAStride == kBStride, "one tap stride serves both tiles");
static_assert(kThreads == (kTM / 4) * (kTN / 4), "4 x 4 outputs a thread");
static_assert(kKC * 9 % 8 == 0, "weight staging reads 8 values a row");

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

// Channel c of pixel pix of the virtual concat cat(xa, xb).
template <typename Tin, bool kSplit>
__device__ __forceinline__ float concat_at(const Tin* __restrict__ xa, const Tin* __restrict__ xb,
                                           int Ca, int Cb, size_t pix, int c) {
  if (kSplit && c >= Ca) return Cvt<Tin>::to_f(xb[pix * Cb + (c - Ca)]);
  return Cvt<Tin>::to_f(xa[pix * Ca + c]);
}

// GroupNorm of cat(xa, xb) (Cb = 0: xa alone) as scale/shift per (b, c):
// GN(v) = v * scale + shift.  One block per (batch, group).
template <typename Tin, bool kSplit>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats(const Tin* __restrict__ xa, const Tin* __restrict__ xb, int Ca, int Cb,
         const float* __restrict__ gamma, const float* __restrict__ beta,
         float* __restrict__ scale, float* __restrict__ shift, int HW, int G) {
  __shared__ float red[32];
  const int C = Ca + Cb;
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cpg = C / G;
  const int n = HW * cpg;
  const size_t pix0 = (size_t)b * HW;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s += concat_at<Tin, kSplit>(xa, xb, Ca, Cb, pix0 + i / cpg, g * cpg + i % cpg);
  const float mean = block_sum(s, red) / n;

  float q = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = concat_at<Tin, kSplit>(xa, xb, Ca, Cb, pix0 + i / cpg, g * cpg + i % cpg) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) / n + kEps);

  for (int c = threadIdx.x; c < cpg; c += blockDim.x) {
    const int ch = g * cpg + c;
    const float sc = rstd * gamma[ch];
    scale[(size_t)b * C + ch] = sc;
    shift[(size_t)b * C + ch] = beta[ch] - mean * sc;
  }
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
  }
}

// 3x3 SAME conv of silu(src * scale + shift), src = cat(xa, xb) of Tin
// (T for conv0, float32 h for conv1), the activation rounded to T.
//   kLast = false (conv0): out (float32) = acc + (bias[o] + bias2[b, o])
//     with bias2 = temb (B, Cout), or nothing when null.
//   kLast = true (conv1): out (T) = (res + (acc + (bias[o] + bias2[o]))) *
//     res_scale with bias2 = the shortcut bias (Cout) or null, and res =
//     cat(ra, rb) @ ws when ws is given, else cat(ra, rb)[o] (Ra + Rb = Cout).
template <typename T, typename Tin, bool kSplit, bool kLast>
__global__ void __launch_bounds__(kThreads)
conv3x3_act(const Tin* __restrict__ xa, const Tin* __restrict__ xb, int Ca, int Cb,
            const float* __restrict__ scale, const float* __restrict__ shift,
            const T* __restrict__ w, const float* __restrict__ bias,
            const float* __restrict__ bias2,
            const T* __restrict__ ra, const T* __restrict__ rb, int Ra, int Rb,
            const T* __restrict__ ws, float res_scale,
            void* __restrict__ out, int M, int H, int W, int Cout) {
  __shared__ __align__(16) float a_s[9 * kTapStride];
  __shared__ __align__(16) float b_s[9 * kTapStride];
  __shared__ int row_b[kTM], row_y[kTM], row_x[kTM];

  const int tid = threadIdx.x;
  const int tm = tid / (kTN / 4);  // pixels m0 + 4*tm .. +3
  const int tn = tid % (kTN / 4);  // output channels n0 + 4*tn .. +3
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int HW = H * W, Cin = Ca + Cb;

  for (int m = tid; m < kTM; m += kThreads) {
    const int row = m0 + m;
    row_b[m] = row < M ? row / HW : -1;
    row_y[m] = (row % HW) / W;
    row_x[m] = row % W;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kKC) {
    // Activations of the nine taps, channel fastest: a warp reads 16
    // contiguous channels of 2 pixels.
    for (int i = tid; i < 9 * kTM * kKC; i += kThreads) {
      const int k = i % kKC, m = (i / kKC) % kTM, tap = i / (kKC * kTM);
      const int c = c0 + k, b = row_b[m];
      const int yy = row_y[m] + tap / 3 - 1, xx = row_x[m] + tap % 3 - 1;
      float v = 0.f;
      if (b >= 0 && c < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const size_t pix = ((size_t)b * H + yy) * W + xx;
        const size_t bc = (size_t)b * Cin + c;
        const float a = fmaf(concat_at<Tin, kSplit>(xa, xb, Ca, Cb, pix, c), scale[bc], shift[bc]);
        v = Cvt<T>::to_f(Cvt<T>::from_f(a / (1.f + __expf(-a))));
      }
      a_s[tap * kTapStride + k * kAStride + m] = v;
    }
    // Weights w[o][c0 + k][tap] -> b_s[tap][k][o - n0].  For one output
    // channel the chunk's 16 x 9 values are contiguous; a warp reads 8 of
    // them for each of 4 output channels, and its stores fall on 32 banks.
    for (int i = tid; i < kTN * kKC * 9; i += kThreads) {
      const int e8 = i & 7, nsub = (i >> 3) & 3, rest = i >> 5;
      const int sector = rest % (kKC * 9 / 8), nquad = rest / (kKC * 9 / 8);
      const int n = nquad * 4 + nsub;
      const int e = sector * 8 + e8;  // k * 9 + tap
      const int k = e / 9, tap = e % 9;
      const int c = c0 + k, o = n0 + n;
      float v = 0.f;
      if (c < Cin && o < Cout) v = Cvt<T>::to_f(w[((size_t)o * Cin + c) * 9 + tap]);
      b_s[tap * kTapStride + k * kBStride + n] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* ap = a_s + tap * kTapStride + tm * 4;
      const float* bp = b_s + tap * kTapStride + tn * 4;
#pragma unroll 8
      for (int k = 0; k < kKC; ++k)
        fma4x4(acc, *reinterpret_cast<const float4*>(ap + k * kAStride),
               *reinterpret_cast<const float4*>(bp + k * kBStride));
    }
    __syncthreads();
  }

  float racc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) racc[i][j] = 0.f;

  if (kLast && ws != nullptr) {
    // Channel-mix shortcut: one more K loop, over cat(ra, rb)'s channels at
    // the output pixel, against ws (Cr, Cout).
    const int Cr = Ra + Rb;
    for (int c0 = 0; c0 < Cr; c0 += kKC) {
      for (int i = tid; i < kTM * kKC; i += kThreads) {
        const int k = i % kKC, m = i / kKC;
        const int c = c0 + k;
        float v = 0.f;
        if (row_b[m] >= 0 && c < Cr) v = concat_at<T, kSplit>(ra, rb, Ra, Rb, (size_t)m0 + m, c);
        a_s[k * kAStride + m] = v;
      }
      for (int i = tid; i < kKC * kTN; i += kThreads) {
        const int n = i % kTN, k = i / kTN;
        const int c = c0 + k, o = n0 + n;
        b_s[k * kBStride + n] = (c < Cr && o < Cout) ? Cvt<T>::to_f(ws[(size_t)c * Cout + o]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k)
        fma4x4(racc, *reinterpret_cast<const float4*>(a_s + k * kAStride + tm * 4),
               *reinterpret_cast<const float4*>(b_s + k * kBStride + tn * 4));
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = tm * 4 + i;
    const int b = row_b[m];
    if (b < 0) continue;
    const size_t row = (size_t)m0 + m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tn * 4 + j;
      if (o >= Cout) continue;
      if (!kLast) {
        const float bt = bias[o] + (bias2 != nullptr ? bias2[(size_t)b * Cout + o] : 0.f);
        static_cast<float*>(out)[row * Cout + o] = acc[i][j] + bt;
      } else {
        const float h1 = acc[i][j] + (bias[o] + (bias2 != nullptr ? bias2[o] : 0.f));
        const float res = ws != nullptr ? racc[i][j] : concat_at<T, kSplit>(ra, rb, Ra, Rb, row, o);
        static_cast<T*>(out)[row * Cout + o] = Cvt<T>::from_f((res + h1) * res_scale);
      }
    }
  }
}

template <typename T, bool kSplit>
int launch(const void* x, const void* skip, int Ca, int Cb, const void* gamma0,
           const void* beta0, int G0, const void* w0, const void* b0, const void* temb,
           const void* gamma1, const void* beta1, int G1, const void* w1, const void* b1,
           const void* ws, const void* bs, float res_scale, void* out, void* scratch,
           int B, int H, int W, int Cout, cudaStream_t stream) {
  const int Cin = Ca + Cb, HW = H * W, M = B * HW;
  float* scale0 = static_cast<float*>(scratch);
  float* shift0 = scale0 + (size_t)B * Cin;
  float* scale1 = shift0 + (size_t)B * Cin;
  float* shift1 = scale1 + (size_t)B * Cout;
  float* h = shift1 + (size_t)B * Cout;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(skip);
  const dim3 grid((M + kTM - 1) / kTM, (Cout + kTN - 1) / kTN);

  gn_stats<T, kSplit><<<B * G0, kStatsThreads, 0, stream>>>(
      xt, st, Ca, Cb, static_cast<const float*>(gamma0), static_cast<const float*>(beta0),
      scale0, shift0, HW, G0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  conv3x3_act<T, T, kSplit, false><<<grid, kThreads, 0, stream>>>(
      xt, st, Ca, Cb, scale0, shift0, static_cast<const T*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(temb),
      nullptr, nullptr, 0, 0, nullptr, 1.f, h, M, H, W, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  gn_stats<float, false><<<B * G1, kStatsThreads, 0, stream>>>(
      h, nullptr, Cout, 0, static_cast<const float*>(gamma1), static_cast<const float*>(beta1),
      scale1, shift1, HW, G1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  conv3x3_act<T, float, kSplit, true><<<grid, kThreads, 0, stream>>>(
      h, nullptr, Cout, 0, scale1, shift1, static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(bs),
      xt, st, Ca, Cb, static_cast<const T*>(ws), res_scale, out, M, H, W, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* skip, int Ca, int Cb, const void* gamma0,
             const void* beta0, int G0, const void* w0, const void* b0, const void* temb,
             const void* gamma1, const void* beta1, int G1, const void* w1, const void* b1,
             const void* ws, const void* bs, float res_scale, void* out, void* scratch,
             int B, int H, int W, int Cout, cudaStream_t stream) {
  if (skip == nullptr)
    return launch<T, false>(x, skip, Ca, 0, gamma0, beta0, G0, w0, b0, temb, gamma1, beta1, G1,
                            w1, b1, ws, bs, res_scale, out, scratch, B, H, W, Cout, stream);
  return launch<T, true>(x, skip, Ca, Cb, gamma0, beta0, G0, w0, b0, temb, gamma1, beta1, G1, w1,
                         b1, ws, bs, res_scale, out, scratch, B, H, W, Cout, stream);
}

}  // namespace

extern "C" {

// skip null: the block kernel on x (Ca channels; Cb is ignored).  skip given:
// the split kernel on cat(x, skip) (Ca + Cb channels).  temb, ws and bs may
// be null (no temb; identity residual, which needs Ca + Cb == Cout).
// dtype: 0 = float32, 1 = bfloat16.  scratch is float32 of
// 2*B*(Ca+Cb) + 2*B*Cout + B*H*W*Cout.  Returns a cudaError_t (0 on success).
int resblock_fused_launch(const void* x, const void* skip, int Ca, int Cb, const void* gamma0,
                          const void* beta0, int G0, const void* w0, const void* b0,
                          const void* temb, const void* gamma1, const void* beta1, int G1,
                          const void* w1, const void* b1, const void* ws, const void* bs,
                          float res_scale, void* out, void* scratch, int B, int H, int W,
                          int Cout, int dtype, void* stream) {
  const int Cin = Ca + (skip != nullptr ? Cb : 0);
  if (B <= 0 || H <= 0 || W <= 0 || Ca <= 0 || (skip != nullptr && Cb <= 0) || Cout <= 0 ||
      G0 <= 0 || G1 <= 0 || Cin % G0 != 0 || Cout % G1 != 0 || (ws == nullptr && Cin != Cout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, skip, Ca, Cb, gamma0, beta0, G0, w0, b0, temb, gamma1, beta1, G1,
                           w1, b1, ws, bs, res_scale, out, scratch, B, H, W, Cout, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, skip, Ca, Cb, gamma0, beta0, G0, w0, b0, temb, gamma1,
                                   beta1, G1, w1, b1, ws, bs, res_scale, out, scratch, B, H, W,
                                   Cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* resblock_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
