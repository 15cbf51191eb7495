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
// are summed in float32 (first down each input column, then across the
// columns) and the output is rounded to T once.  Any channel count and any
// H and W are taken; the caller checks that H and W are even for the
// downsample.
//
// What bounds it on an H100: 4 (up) or 16 (down) multiply-adds per output
// element against one read of x and one write of out, so at every shape of
// the NCSN++ sampler (B=8; 5x5 to 160x160; 6 to 256 channels) it is bound by
// bytes: the least time is (|x| + |out|) / 3.35 TB/s.  The first version
// (one thread per output element, scalar loads and stores, a chain of 64-bit
// divisions per element) reached 15% (up) and 26-31% (down) of that bound at
// the large calls: the load/store units and the index arithmetic, not the
// memory, set its pace.
//
// Design:
//   - A thread owns one vector of N channels (16 bytes where the channel
//     count and both tensors' addresses allow it, else 8, 4 or one element)
//     and a run of RUN pixels along W (2, or 1; the host's
//     `ops/fir.py:launch_plan` chooses both): input pixels for the up, each
//     giving its 2x2 output quad as four vector stores; output pixels for
//     the down.
//   - Along the run it keeps the vertical sums of the overlapping input
//     columns in registers: per step the up loads 3 new vectors (one column
//     of rows t-1, t, t+1) and the down 8 (two columns of 4 rows), where a
//     thread per output loaded 9 (up: 3x3 per quad) and 16.  The run is 2
//     only where the call still has ~750 threads an SM with it; at fewer
//     threads, and with longer runs, the walk's serial steps cost more than
//     the loads it saves (L1 serves the neighbours' overlap as well).
//   - The thread's row, image, run and vector come from its index by three
//     32-bit divisions, once; inside the run every offset is a 32-bit
//     multiply-add within one image, on one 64-bit base per image.
//   - Where a pixel's channels are not a whole number of 32-byte sectors
//     (the 6-channel pyramid calls), RUN is 1: neighbouring threads then
//     take neighbouring pixels, so a warp still reads whole sectors.
//   - No shared memory: the halo rows that neighbouring rows' threads share
//     are read again through L1/L2 (3 reads of x for the up, ~2 for the
//     down), within L2's bandwidth; the large calls run at 65-75% of the
//     byte bound in float32 with this, so L1 misses do not bound them.  The
//     TPU kernel's halo DMA, pre-padding and tile picking exist for VMEM and
//     are not carried over.
// What bounds it now: at the three calls of 30 MB or more, device memory
// (65-75% of the byte bound in float32); at the others, the per-launch
// floor of ~2.5-5 us.  The measured times are in PERF.md (section 6, the
// FIR table).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxVecBytes = 16;
constexpr int64_t kInt32Limit = int64_t(1) << 31;

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

// The unsigned type of one access of N elements of T (16, 8, 4 or 2 bytes).
template <int Bytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

// f = the N elements at p + off as float, in one access, or zeros where !ok
// (outside the image: p + off is then not formed).
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, int off, bool ok, float (&f)[N]) {
  using R = typename Raw<sizeof(T) * N>::type;
  if (ok) {
    const R r = *reinterpret_cast<const R*>(p + off);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = Cvt<T>::to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = 0.f;
  }
}

// The N elements of f, rounded to T, to p in one access.
template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[N]) {
  using R = typename Raw<sizeof(T) * N>::type;
  R r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = Cvt<T>::from_f(f[i]);
  *reinterpret_cast<R*>(p) = r;
}

// d = a * u + b * w, elementwise.
template <int N>
__device__ __forceinline__ void mix(float (&d)[N], float a, const float (&u)[N], float b, const float (&w)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) d[e] = a * u[e] + b * w[e];
}

template <int N>
__device__ __forceinline__ void copy(float (&d)[N], const float (&s)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) d[e] = s[e];
}

// The thread's place: ``rows`` rows an image of ``runs`` runs of ``nvec``
// vectors each, vectors fastest.
struct Place {
  int b, row, run, vec;
};

__device__ __forceinline__ bool place(int rows, int runs, int nvec, int64_t threads, Place& p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= threads) return false;
  const int per_row = runs * nvec;
  const int r = (int)i / per_row;  // the host keeps the thread count below 2^31
  const int j = (int)i - r * per_row;
  p.b = r / rows;
  p.row = r - p.b * rows;
  p.run = j / nvec;
  p.vec = j - p.run * nvec;
  return true;
}

// Input row ty, input columns [RUN * run, RUN * run + RUN) of image b: the
// 2x2 output quad of each.  Per column j the thread keeps e[j] = c3*x[ty-1][j]
// + c1*x[ty][j] (output row 2ty) and o[j] = c2*x[ty][j] + c0*x[ty+1][j]
// (row 2ty+1) for j = tx-1, tx, tx+1.
template <typename T, int N, int RUN>
__global__ void __launch_bounds__(kMaxThreads) fir_up2_kernel(const T* __restrict__ x, T* __restrict__ out,
                                                              int H, int W, int C, int runs, int64_t threads,
                                                              Taps c) {
  Place p;
  if (!place(H, runs, C / N, threads, p)) return;
  const int rowlen = W * C;
  const int ch = p.vec * N;
  const T* xb = x + (int64_t)p.b * H * rowlen;
  T* ob = out + (int64_t)p.b * 4 * H * rowlen;
  const int ty = p.row;
  const int mid = ty * rowlen + ch;
  const bool has_up = ty > 0, has_down = ty + 1 < H;
  const int o0 = 2 * ty * 2 * rowlen + ch;  // output row 2ty
  const int o1 = o0 + 2 * rowlen;           // output row 2ty+1

  auto column = [&](int j, float (&e)[N], float (&o)[N]) {
    const bool in = j >= 0 && j < W;
    const int off = mid + j * C;
    float a[N], m[N], d[N];
    load<T, N>(xb, off - rowlen, in && has_up, a);
    load<T, N>(xb, off, in, m);
    load<T, N>(xb, off + rowlen, in && has_down, d);
    mix(e, c.c3, a, c.c1, m);
    mix(o, c.c2, m, c.c0, d);
  };

  const int tx0 = p.run * RUN;
  float ep[N], op[N], ec[N], oc[N], en[N], on[N], q[N];
  column(tx0 - 1, ep, op);
  column(tx0, ec, oc);
#pragma unroll
  for (int s = 0; s < RUN; ++s) {
    const int tx = tx0 + s;
    if (tx >= W) break;
    column(tx + 1, en, on);
    const int at = 2 * tx * C;
    mix(q, c.c3, ep, c.c1, ec);
    store<T, N>(ob + o0 + at, q);
    mix(q, c.c2, ec, c.c0, en);
    store<T, N>(ob + o0 + at + C, q);
    mix(q, c.c3, op, c.c1, oc);
    store<T, N>(ob + o1 + at, q);
    mix(q, c.c2, oc, c.c0, on);
    store<T, N>(ob + o1 + at + C, q);
    copy(ep, ec);
    copy(ec, en);
    copy(op, oc);
    copy(oc, on);
  }
}

// Output row oy, output columns [RUN * run, RUN * run + RUN) of image b.
// Per input column j the thread keeps v[j] = c3*x[2oy-1][j] + c2*x[2oy][j] +
// c1*x[2oy+1][j] + c0*x[2oy+2][j], for j = 2ox-1 .. 2ox+2.
template <typename T, int N, int RUN>
__global__ void __launch_bounds__(kMaxThreads) fir_down2_kernel(const T* __restrict__ x, T* __restrict__ out,
                                                                int H, int W, int C, int runs, int64_t threads,
                                                                Taps c) {
  const int Ho = H / 2, Wo = W / 2;
  Place p;
  if (!place(Ho, runs, C / N, threads, p)) return;
  const int rowlen = W * C;
  const int ch = p.vec * N;
  const T* xb = x + (int64_t)p.b * H * rowlen;
  T* ob = out + (int64_t)p.b * Ho * Wo * C + p.row * Wo * C + ch;
  const float w[4] = {c.c3, c.c2, c.c1, c.c0};  // for input rows / columns 2t-1 .. 2t+2
  int roff[4];
  bool rok[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int yy = 2 * p.row - 1 + a;
    rok[a] = yy >= 0 && yy < H;
    roff[a] = yy * rowlen + ch;
  }

  auto column = [&](int j, float (&v)[N]) {
    const bool in = j >= 0 && j < W;
    float r[N];
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      load<T, N>(xb, roff[a] + j * C, in && rok[a], r);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] += w[a] * r[e];
    }
  };

  const int ox0 = p.run * RUN;
  float va[N], vb[N], vc[N], vd[N], q[N];
  column(2 * ox0 - 1, va);
  column(2 * ox0, vb);
#pragma unroll
  for (int s = 0; s < RUN; ++s) {
    const int ox = ox0 + s;
    if (ox >= Wo) break;
    column(2 * ox + 1, vc);
    column(2 * ox + 2, vd);
#pragma unroll
    for (int e = 0; e < N; ++e) q[e] = w[0] * va[e] + w[1] * vb[e] + w[2] * vc[e] + w[3] * vd[e];
    store<T, N>(ob + ox * C, q);
    copy(va, vc);
    copy(vb, vd);
  }
}

struct Plan {
  int vec, run, threads, blocks;
};

template <typename T, int N, int RUN>
void launch_run(bool up, const void* x, void* out, int H, int W, int C, int runs, int64_t threads, Taps c,
                const Plan& plan, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (up)
    fir_up2_kernel<T, N, RUN><<<plan.blocks, plan.threads, 0, stream>>>(xp, op, H, W, C, runs, threads, c);
  else
    fir_down2_kernel<T, N, RUN><<<plan.blocks, plan.threads, 0, stream>>>(xp, op, H, W, C, runs, threads, c);
}

template <typename T, int N>
int launch_vec(bool up, const void* x, void* out, int H, int W, int C, int runs, int64_t threads, Taps c,
               const Plan& plan, cudaStream_t stream) {
  switch (plan.run) {
    case 1: launch_run<T, N, 1>(up, x, out, H, W, C, runs, threads, c, plan, stream); break;
    case 2: launch_run<T, N, 2>(up, x, out, H, W, C, runs, threads, c, plan, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(bool up, const void* x, void* out, int H, int W, int C, int runs, int64_t threads, Taps c,
           const Plan& plan, cudaStream_t stream) {
  if (plan.vec * (int)sizeof(T) > kMaxVecBytes) return static_cast<int>(cudaErrorInvalidValue);
  switch (plan.vec) {
    case 1: return launch_vec<T, 1>(up, x, out, H, W, C, runs, threads, c, plan, stream);
    case 2: return launch_vec<T, 2>(up, x, out, H, W, C, runs, threads, c, plan, stream);
    case 4: return launch_vec<T, 4>(up, x, out, H, W, C, runs, threads, c, plan, stream);
    case 8:
      if constexpr (sizeof(T) * 8 <= kMaxVecBytes)
        return launch_vec<T, 8>(up, x, out, H, W, C, runs, threads, c, plan, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Checks the host's plan against the problem (vector width dividing C and
// both addresses, a compiled run, enough threads, 32-bit offsets within an
// image) and launches it.
int dispatch(bool up, const void* x, void* out, int B, int H, int W, int C, float c0, float c1, float c2,
             float c3, int dtype, int vec, int run, int threads_per_block, int blocks, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (!up && (H % 2 != 0 || W % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int item = dtype == 0 ? 4 : 2;
  const uintptr_t align = (uintptr_t)vec * item;
  if (vec <= 0 || run <= 0 || C % vec != 0 || (uintptr_t)x % align != 0 || (uintptr_t)out % align != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t image = (int64_t)H * W * C * (up ? 4 : 1);  // the larger of an image's input and output
  const int64_t rows = (int64_t)B * (up ? H : H / 2), steps = up ? W : W / 2;
  const int64_t runs = (steps + run - 1) / run;
  const int64_t threads = rows * runs * (C / vec);
  if (image >= kInt32Limit || threads >= kInt32Limit) return static_cast<int>(cudaErrorInvalidValue);
  if (threads_per_block <= 0 || threads_per_block > kMaxThreads || (int64_t)blocks * threads_per_block < threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Taps c{c0, c1, c2, c3};
  const Plan plan{vec, run, threads_per_block, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(up, x, out, H, W, C, (int)runs, threads, c, plan, s);
  return launch<__nv_bfloat16>(up, x, out, H, W, C, (int)runs, threads, c, plan, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; vec, run, threads, blocks: the host's plan
// (`ops/fir.py:launch_plan`).  Returns 0 or a cudaError_t.
extern "C" int fir_upsample2_launch(const void* x, void* out, int B, int H, int W, int C, float c0, float c1,
                                    float c2, float c3, int dtype, int vec, int run, int threads, int blocks,
                                    void* stream) {
  return dispatch(true, x, out, B, H, W, C, c0, c1, c2, c3, dtype, vec, run, threads, blocks, stream);
}

extern "C" int fir_downsample2_launch(const void* x, void* out, int B, int H, int W, int C, float c0,
                                      float c1, float c2, float c3, int dtype, int vec, int run, int threads,
                                      int blocks, void* stream) {
  return dispatch(false, x, out, B, H, W, C, c0, c1, c2, c3, dtype, vec, run, threads, blocks, stream);
}

extern "C" const char* fir_resample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
