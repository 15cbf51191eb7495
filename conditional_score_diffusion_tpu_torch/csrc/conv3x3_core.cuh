// The 3x3 SAME stride-1 implicit-GEMM main loop shared by csrc/conv3x3.cu
// (TPU kernels 4 and 5), csrc/gn_silu_conv3x3.cu (TPU kernel 1) and
// csrc/resblock_fused.cu (TPU kernels 2 and 3), for sm_90a.
//
//   out[m, n] = bias[n] (+ temb[b(m), n]) + sum_k A[m, k] * B[k, n]
//   M = B*H*W pixels of all images, packed (no per-image tile, so 4x4, 5x5
//   and 10x10 images waste nothing); N = Cout; K = 9 taps x Cin, flattened
//   as k = tap * Cin + c, so Cin = 6 packs its 54 values into 4 chunks of
//   16 (float32) or one of 64 (bfloat16), not 9 half-empty ones.
//   A[m, k] = x[b, y + dy - 1, x + dx - 1, c] inside the image, 0 outside
//   (the SAME padding; the fused tail passes its activation as x, so the
//   padding applies to the activation).
//   B[k, n] = w in (3, 3, Cin, Cout) order, contiguous.
//
// One block of 256 threads computes a BM x BN tile over a contiguous range
// of BK-wide K chunks.  A and B tiles go through a STAGES-deep ring in
// dynamic shared memory by cp.async (16-byte copies along the channel axis;
// 4-byte float copies, or synchronous bfloat16 element loads, where a row
// is not a whole number of 16-byte vectors); the copies of chunk i+STAGES-1
// are in flight while chunk i is multiplied.
//
// float32 runs on the CUDA cores (TF32 stays off, for parity): a thread owns
// TM x TN outputs (8 x 6 or 8 x 4 in a 128 x {96, 64} tile; 4 x 4 in a
// 512 x 8 tile for Cout <= 8), and reads A as float2 and B as float2 /
// float4 from shared memory on conflict-free strides.  Two blocks share an
// SM (<= 128 registers a thread); an 8 x 8 tile (128 x 128) needed 168-203
// registers, held one block an SM and ran slower at every shape measured.
// bfloat16 runs on the tensor cores: mma.sync.m16n8k16 with float32
// accumulators, operands by ldmatrix (B transposed on the fly from its
// [k][n] tile), 8 warps of 32 rows over a 64 x {128, 96} or 128 x {64, 16}
// tile, BK = 64.  The 64-row tiles give the small problems of the sampler's
// tails twice the blocks of 128-row ones; 128 x {96, 128, 192} tiles,
// and 4-warp blocks with 64 x 48 warp tiles, were no faster on the card.
// Rows and pixels are decomposed once per block; a chunk costs one
// division (k -> tap, channel).
//
// Split-K: where the tiles are fewer than the SMs, the host plan splits the
// K chunks over `splits` blocks of one thread-block cluster (<= 8).  Each
// block leaves its float32 partial tile in its own shared memory; after a
// cluster barrier, block r sums row slice r of every rank's tile through
// distributed shared memory in rank order 0..splits-1 (deterministic, one
// launch, no scratch), adds bias and temb once, and stores.  Unsplit tiles
// take the same epilogue on their own shared memory.
//
// Two template arguments serve the whole resblock and leave the other
// entries' kernels as they were: OutT, the output's type (the block's conv0
// stores float32 h from a bfloat16 loop), and the parameter's type,
// FoldProblem for the block's conv1: K runs on past the 9 taps into a
// tenth, centred tap that reads the block's input at the output pixel (the
// channel-mix shortcut, against its rows of B, in the same accumulator),
// and the epilogue adds the shortcut bias and the identity residual and
// applies the rescale.
//
// Indices are 32-bit: the wrappers refuse tensors of 2**31 elements or more.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace conv3x3_core {
// Internal linkage: each library that includes this header keeps its own
// copy.  (As shared inline templates, the two libraries' launch_gemm<C>
// would share one once-per-device attribute flag in a process, and the
// second library's kernel would launch without its shared-memory attribute.)
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxSplits = 8;  // blocks of a portable cluster

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One copy of BYTES bytes from global to shared memory, zeros where !valid
// (src is then not read).  16 and 4 bytes go by cp.async; 2 bytes (a lone
// bfloat16) synchronously.
template <int BYTES>
__device__ __forceinline__ void copy_unit(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
  } else if constexpr (BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 4 : 0));
  } else {
    static_assert(BYTES == 2, "copy units are 16, 4 or 2 bytes");
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- tile configurations ----------------------------------------------------
// The host plan (ops/conv3x3.py:launch_plan) repeats these numbers and the
// C entries check that the two agree.

template <int BN_>
struct CfgF32 {
  using T = float;
  static constexpr int BN = BN_;
  static constexpr bool kNarrow = BN_ == 8;
  static constexpr int BM = kNarrow ? 512 : 128, BK = 16, STAGES = kNarrow ? 3 : 4;
  static constexpr int kMinBlocks = kNarrow ? 1 : 2;  // blocks an SM holds: <= 128 registers a thread
  static constexpr int THR_N = kNarrow ? 2 : 16, THR_M = kThreads / THR_N;
  static constexpr int TM = BM / THR_M, TN = BN / THR_N;
  static constexpr int VB = TN % 4 == 0 ? 4 : 2;  // B read from shared memory as float4 or float2
  static constexpr int A_LD = BK + 4;             // +4: rows tm and tm+1 of a warp on other banks
  static constexpr int B_LD = BN;
  static constexpr int kStageBytes = (BM * A_LD + BK * B_LD) * 4;
  static_assert(TN % VB == 0 && BM % THR_M == 0, "tile");
};

template <int BM_, int BN_>
struct CfgBF16 {
  using T = __nv_bfloat16;
  static constexpr int BN = BN_;
  static constexpr int BM = BM_, BK = 64, STAGES = 3, kMinBlocks = 2;
  static constexpr int WARPS_M = BM / 32, WARPS_N = 8 / WARPS_M;  // 8 warps, 32 rows each
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;  // m16 and n8 tiles of a warp
  static constexpr int A_LD = BK + 8;              // 80-byte rows: ldmatrix conflict free
  static constexpr int B_LD = BN + 8;
  static constexpr int kStageBytes = (BM * A_LD + BK * B_LD) * 2;
  static_assert(WN % 8 == 0, "tile");
};

template <class C>
struct Smem {
  static constexpr int C_LD = C::BN + 4;  // the float32 output tile of the epilogue
  static constexpr int kPipe = C::STAGES * C::kStageBytes;
  static constexpr int kTile = C::BM * C_LD * 4;
  static constexpr int kBytes = kPipe > kTile ? kPipe : kTile;
};

// ---- the problem --------------------------------------------------------------

struct Problem {
  const void* x;
  const void* w;        // (3, 3, Cin, Cout)
  const float* bias;    // (Cout,) or null
  const float* temb;    // (B, Cout) or null
  void* out;
  int M, H, W, Cin, Cout;
  int xsb, xsh, xsw, osb, osh, osw;  // element strides of (b, h, w); channels contiguous
  int a_vec, b_vec;  // 16-byte copies of A along channels, of B along output channels
  int K, splits, nchunks;  // set by launch_gemm
};

// The whole-resblock's conv1, the kernel's parameter where it folds the
// shortcut (kFold): with `mix`, K runs on past the 9 taps into a tenth,
// centred tap of Ca + Cb channels, cat(ra, rb) at the output pixel (NHWC,
// rb null where Cb is 0), against the shortcut's rows of B; without it the
// epilogue adds cat(ra, rb)[m, n] (the identity residual).  bias2 (Cout,)
// or null joins bias, and the sum is scaled by res_scale.  A type of its
// own, so the other kernels keep their parameter: with these fields
// appended to Problem, nvcc compiled the other kernels into other code
// (slower at Cin = 6); with them here, their SASS is unchanged.
struct FoldProblem : Problem {
  const void* ra;
  const void* rb;
  int Ca, Cb, mix;
  const float* bias2;
  float res_scale;
};

// What both C entries check first: positive sizes, 32-bit indices.
inline bool dims_ok(int B, int H, int W, int Cin, int Cout) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return false;
  const long m = (long)B * H * W;
  return m * (Cin > Cout ? Cin : Cout) < (1L << 31) && 9L * Cin * Cout < (1L << 31);
}

// ---- per-type arithmetic ------------------------------------------------------

template <class C>
struct MathF32 {
  struct Acc {
    float v[C::TM][C::TN];
  };
  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc.v[i][j] = 0.f;
  }
  // Output column of a thread's j-th value.
  static __device__ __forceinline__ int col(int tn, int j) {
    return (j / C::VB) * C::VB * C::THR_N + tn * C::VB + j % C::VB;
  }
  static __device__ __forceinline__ void mma_stage(Acc& acc, const float* As, const float* Bs) {
    const int tn = threadIdx.x % C::THR_N, tm = threadIdx.x / C::THR_N;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 2) {
      float b[2][C::TN];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* brow = Bs + (kk + q) * C::B_LD;
#pragma unroll
        for (int j = 0; j < C::TN; j += C::VB) {
          if constexpr (C::VB == 4) {
            const float4 v = *reinterpret_cast<const float4*>(brow + col(tn, j));
            b[q][j] = v.x, b[q][j + 1] = v.y, b[q][j + 2] = v.z, b[q][j + 3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(brow + col(tn, j));
            b[q][j] = v.x, b[q][j + 1] = v.y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(As + (tm + C::THR_M * i) * C::A_LD + kk);
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc.v[i][j] = fmaf(a.y, b[1][j], fmaf(a.x, b[0][j], acc.v[i][j]));
      }
    }
  }
  static __device__ __forceinline__ void store(const Acc& acc, float* tile) {
    const int tn = threadIdx.x % C::THR_N, tm = threadIdx.x / C::THR_N;
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) tile[(tm + C::THR_M * i) * Smem<C>::C_LD + col(tn, j)] = acc.v[i][j];
  }
};

template <class C>
struct MathBF16 {
  struct Acc {
    float v[C::MT][C::NT][4];
  };
  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
  }
  static __device__ __forceinline__ void mma_stage(Acc& acc, const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp % C::WARPS_M) * C::WM, wn = (warp / C::WARPS_M) * C::WN;
#pragma unroll
    for (int ks = 0; ks < C::BK; ks += 16) {
      uint32_t a[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const __nv_bfloat16* p = As + (wm + mt * 16 + (lane & 15)) * C::A_LD + ks + (lane >> 4) * 8;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[mt][0]), "=r"(a[mt][1]), "=r"(a[mt][2]), "=r"(a[mt][3])
                     : "r"(smem_u32(p)));
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        uint32_t b0, b1;
        const __nv_bfloat16* p = Bs + (ks + (lane & 15)) * C::B_LD + wn + nt * 8;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(smem_u32(p)));
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          float* d = acc.v[mt][nt];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
              " {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]), "r"(b0), "r"(b1));
        }
      }
    }
  }
  static __device__ __forceinline__ void store(const Acc& acc, float* tile) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp % C::WARPS_M) * C::WM, wn = (warp / C::WARPS_M) * C::WN;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int r = wm + mt * 16 + (lane >> 2), c = wn + nt * 8 + (lane & 3) * 2;
        tile[r * Smem<C>::C_LD + c] = acc.v[mt][nt][0];
        tile[r * Smem<C>::C_LD + c + 1] = acc.v[mt][nt][1];
        tile[(r + 8) * Smem<C>::C_LD + c] = acc.v[mt][nt][2];
        tile[(r + 8) * Smem<C>::C_LD + c + 1] = acc.v[mt][nt][3];
      }
  }
};

template <class C>
using Math = typename std::conditional<std::is_same<typename C::T, float>::value, MathF32<C>, MathBF16<C>>::type;

// ---- the A and B loaders ------------------------------------------------------

// A thread's share of the A tile: RPT rows (kThreads apart) x KPT
// consecutive k values of each chunk.  The rows' pixels are decomposed once
// per block; a chunk costs one division (k -> tap, channel), after which the
// copies step through the channels and taps.
template <class C>
struct ARows {
  static constexpr int TPR = C::BM >= kThreads ? 1 : kThreads / C::BM;  // threads per row
  static constexpr int RPT = C::BM >= kThreads ? C::BM / kThreads : 1;  // rows per thread
  static constexpr int KPT = C::BK / TPR;                                // k values per thread
  static_assert(TPR * C::BM == kThreads * RPT && KPT * TPR == C::BK, "A rows");
  int row0, kseg;
  int base[RPT], y[RPT], x[RPT];

  __device__ __forceinline__ void init(const Problem& p, int m0) {
    row0 = threadIdx.x / TPR;
    kseg = (threadIdx.x % TPR) * KPT;
    const int HW = p.H * p.W;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int m = m0 + row0 + r * kThreads;
      if (m < p.M) {
        const int b = m / HW, rem = m - b * HW;
        y[r] = rem / p.W;
        x[r] = rem - y[r] * p.W;
        base[r] = b * p.xsb + y[r] * p.xsh + x[r] * p.xsw;
      } else {
        y[r] = -4, x[r] = 0, base[r] = 0;  // every tap falls outside
      }
    }
  }

  // This thread's U-element units of `chunk` into As (zeros outside the
  // image and past K).  U divides Cin.
  template <int U, typename T>
  __device__ __forceinline__ void load(const Problem& p, int chunk, T* As) const {
    const T* xp = static_cast<const T*>(p.x);
    const int k = chunk * C::BK + kseg;
    int tap = k / p.Cin, c = k - tap * p.Cin;
#pragma unroll
    for (int e = 0; e < KPT; e += U) {
      const bool kin = k + e < p.K;
      const int ty = tap / 3, dy = ty - 1, dx = tap - ty * 3 - 1;
      const int off = dy * p.xsh + dx * p.xsw + c;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const bool valid = kin && static_cast<unsigned>(y[r] + dy) < static_cast<unsigned>(p.H) &&
                           static_cast<unsigned>(x[r] + dx) < static_cast<unsigned>(p.W);
        copy_unit<U * sizeof(T)>(As + (row0 + r * kThreads) * C::A_LD + kseg + e, valid ? xp + base[r] + off : xp,
                                 valid);
      }
      c += U;
      if (c >= p.Cin) c = 0, ++tap;
    }
  }
};

// The same for the whole-resblock's conv1 (kFold): k past the 9 taps is the
// tenth, centred tap (see FoldProblem), which steps through its Ca + Cb
// channels without wrapping; a chunk may hold both.  U also divides Ca and
// Cb.
template <class C>
struct ARowsFold : ARows<C> {
  using Base = ARows<C>;
  int pix[Base::RPT];  // the row's pixel, -1 past M

  __device__ __forceinline__ void init(const Problem& p, int m0) {
    Base::init(p, m0);
#pragma unroll
    for (int r = 0; r < Base::RPT; ++r) {
      const int m = m0 + this->row0 + r * kThreads;
      pix[r] = m < p.M ? m : -1;
    }
  }

  template <int U, typename T>
  __device__ __forceinline__ void load(const FoldProblem& p, int chunk, T* As) const {
    const T* xp = static_cast<const T*>(p.x);
    const T* ra = static_cast<const T*>(p.ra);
    const T* rb = static_cast<const T*>(p.rb);
    const int k = chunk * C::BK + this->kseg;
    int tap = min(k / p.Cin, 9), c = k - tap * p.Cin;
#pragma unroll
    for (int e = 0; e < Base::KPT; e += U) {
      const bool kin = k + e < p.K;
      T* dst = As + this->row0 * C::A_LD + this->kseg + e;
      if (tap == 9) {
#pragma unroll
        for (int r = 0; r < Base::RPT; ++r) {
          const bool valid = kin && pix[r] >= 0;
          const T* src = !valid ? xp : c < p.Ca ? ra + pix[r] * p.Ca + c : rb + pix[r] * p.Cb + (c - p.Ca);
          copy_unit<U * sizeof(T)>(dst + r * kThreads * C::A_LD, src, valid);
        }
      } else {
        const int ty = tap / 3, dy = ty - 1, dx = tap - ty * 3 - 1;
        const int off = dy * p.xsh + dx * p.xsw + c;
#pragma unroll
        for (int r = 0; r < Base::RPT; ++r) {
          const bool valid = kin && static_cast<unsigned>(this->y[r] + dy) < static_cast<unsigned>(p.H) &&
                             static_cast<unsigned>(this->x[r] + dx) < static_cast<unsigned>(p.W);
          copy_unit<U * sizeof(T)>(dst + r * kThreads * C::A_LD, valid ? xp + this->base[r] + off : xp, valid);
        }
      }
      c += U;
      if (c >= p.Cin && tap < 9) c = 0, ++tap;
    }
  }
};

template <class C, int U>
struct BLoader {
  static constexpr int NG = C::BN / U;  // n groups per k row
  static constexpr int UNITS = C::BK * NG;

  template <typename T>
  __device__ __forceinline__ static void load(const Problem& p, int n0, int chunk, T* Bs) {
    const T* w = static_cast<const T*>(p.w);
#pragma unroll
    for (int u0 = 0; u0 < UNITS; u0 += kThreads) {
      const int u = u0 + threadIdx.x;
      if (UNITS % kThreads != 0 && u >= UNITS) break;
      const int kr = u / NG, ng = u % NG;
      const int k = chunk * C::BK + kr, n = n0 + ng * U;
      const bool valid = k < p.K && n < p.Cout;
      copy_unit<U * sizeof(T)>(Bs + kr * C::B_LD + ng * U, valid ? w + k * p.Cout + n : w, valid);
    }
  }
};

// Elements of a 16-byte copy unit; the scalar unit is one element (a 4-byte
// cp.async for float32, a synchronous 2-byte load for bfloat16).
template <typename T>
struct Units {
  static constexpr int kVec = 16 / sizeof(T);
};

// ---- the kernel ---------------------------------------------------------------

// OutT: the output's type, T's or (the whole-resblock's conv0 in bfloat16)
// float32.  P: Problem, or FoldProblem for the whole-resblock's conv1.
template <class C, typename OutT, class P>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks) conv3x3_gemm(const P p) {
  constexpr bool kFold = std::is_same<P, FoldProblem>::value;
  using T = typename C::T;
  using M_ = Math<C>;
  constexpr int VEC = Units<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + C::STAGES * C::BM * C::A_LD;

  const int split = blockIdx.x % p.splits;
  const int m0 = (blockIdx.x / p.splits) * C::BM, n0 = blockIdx.y * C::BN;
  const int c_begin = split * p.nchunks / p.splits, c_end = (split + 1) * p.nchunks / p.splits;
  const int nk = c_end - c_begin;

  typename std::conditional<kFold, ARowsFold<C>, ARows<C>>::type rows;
  rows.init(p, m0);
  auto load_stage = [&](int slot, int chunk) {
    T* a = As + slot * C::BM * C::A_LD;
    T* b = Bs + slot * C::BK * C::B_LD;
    if (p.a_vec) rows.template load<VEC>(p, chunk, a);
    else rows.template load<1>(p, chunk, a);
    if (p.b_vec) BLoader<C, VEC>::load(p, n0, chunk, b);
    else BLoader<C, 1>::load(p, n0, chunk, b);
  };

  typename M_::Acc acc;
  M_::zero(acc);

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, c_begin + s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    const int slot = it % C::STAGES;
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int next = it + C::STAGES - 1;
    if (next < nk) load_stage(next % C::STAGES, c_begin + next);
    cp_async_commit();
    M_::mma_stage(acc, As + slot * C::BM * C::A_LD, Bs + slot * C::BK * C::B_LD);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: the partial tile to shared memory, then row slice `split` of
  // the sum over the cluster's tiles, rank by rank, + bias + temb (kFold:
  // + bias + bias2, + the identity residual, x res_scale).
  float* tile = reinterpret_cast<float*>(smem);
  M_::store(acc, tile);
  cg::cluster_group cluster = cg::this_cluster();
  if (p.splits > 1) cluster.sync();
  else __syncthreads();

  constexpr int C_LD = Smem<C>::C_LD;
  constexpr int NQ = C::BN / 4;  // float4 column groups
  const int slice = (C::BM + p.splits - 1) / p.splits;
  const int r0 = split * slice, r1 = min(C::BM, r0 + slice);
  const int HW = p.H * p.W;
  OutT* out = static_cast<OutT*>(p.out);
  const bool vec_out = p.Cout % 4 == 0;
  for (int idx = threadIdx.x; idx < (r1 - r0) * NQ; idx += kThreads) {
    const int r = r0 + idx / NQ, q = (idx % NQ) * 4;
    const int m = m0 + r, n = n0 + q;
    if (m >= p.M || n >= p.Cout) continue;
    // Every rank's partial first (the loads overlap), then their sum in rank order.
    float4 part[kMaxSplits];
#pragma unroll
    for (int rank = 0; rank < kMaxSplits; ++rank)
      if (rank < p.splits)
        part[rank] = *reinterpret_cast<const float4*>(
            (p.splits > 1 ? cluster.map_shared_rank(tile, rank) : tile) + r * C_LD + q);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int rank = 0; rank < kMaxSplits; ++rank)
      if (rank < p.splits) s.x += part[rank].x, s.y += part[rank].y, s.z += part[rank].z, s.w += part[rank].w;
    const int b = m / HW, rem = m - b * HW;
    OutT* o = out + b * p.osb + (rem / p.W) * p.osh + (rem % p.W) * p.osw + n;
    float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n + e >= p.Cout) break;
      if constexpr (kFold) {
        const int ch = n + e;
        v[e] += p.bias[ch] + (p.bias2 != nullptr ? p.bias2[ch] : 0.f);
        if (!p.mix) {
          const T* ra = static_cast<const T*>(p.ra);
          const T* rb = static_cast<const T*>(p.rb);
          v[e] += Cvt<T>::to_f(ch < p.Ca ? ra[m * p.Ca + ch] : rb[m * p.Cb + (ch - p.Ca)]);
        }
        v[e] *= p.res_scale;
      } else {
        if (p.bias != nullptr) v[e] += p.bias[n + e];
        if (p.temb != nullptr) v[e] += p.temb[b * p.Cout + n + e];
      }
    }
    if (vec_out) {
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<uint32_t*>(&lo);
        pk.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(o) = pk;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < p.Cout) o[e] = Cvt<OutT>::from_f(v[e]);
    }
  }
  if (p.splits > 1) cluster.sync();  // no block leaves while another reads its tile
}

// ---- the host side ------------------------------------------------------------

// The plan the host computed, checked against the compiled configuration.
struct Plan {
  int bm, bn, bk, stages, splits, smem;
};

template <class C>
bool plan_matches(const Plan& plan) {
  return plan.bm == C::BM && plan.bn == C::BN && plan.bk == C::BK && plan.stages == C::STAGES &&
         plan.splits >= 1 && plan.splits <= kMaxSplits && plan.smem == Smem<C>::kBytes;
}

// One launch of the main loop: grid (M tiles x splits, N tiles), clusters of
// `splits` blocks along x.  Returns a cudaError_t.
template <class C, typename OutT, class P>
int launch_gemm(P p, const Plan& plan, cudaStream_t stream) {
  if (!plan_matches<C>(plan)) return static_cast<int>(cudaErrorInvalidValue);
  p.K = 9 * p.Cin;
  if constexpr (std::is_same<P, FoldProblem>::value) {
    if (p.mix) p.K += p.Ca + p.Cb;
  }
  p.nchunks = (p.K + C::BK - 1) / C::BK;
  p.splits = plan.splits;
  if (p.splits > p.nchunks) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv3x3_gemm<C, OutT, P>;
  constexpr int smem = Smem<C>::kBytes;
  static unsigned long long attribute_set = 0;  // once per instantiation and device (bit = ordinal)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attribute_set & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.M + C::BM - 1) / C::BM) * p.splits, (p.Cout + C::BN - 1) / C::BN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the tile width to the compiled configurations of T (OutT
// and P as for conv3x3_gemm).
template <typename T, typename OutT = T, class P = Problem>
int launch_typed(const P& p, const Plan& plan, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    switch (plan.bn) {
      case 96: return launch_gemm<CfgF32<96>, OutT, P>(p, plan, stream);
      case 64: return launch_gemm<CfgF32<64>, OutT, P>(p, plan, stream);
      case 8: return launch_gemm<CfgF32<8>, OutT, P>(p, plan, stream);
      default: break;
    }
  } else {
    switch (plan.bn) {
      case 128: return launch_gemm<CfgBF16<64, 128>, OutT, P>(p, plan, stream);
      case 96: return launch_gemm<CfgBF16<64, 96>, OutT, P>(p, plan, stream);
      case 64: return launch_gemm<CfgBF16<128, 64>, OutT, P>(p, plan, stream);
      case 16: return launch_gemm<CfgBF16<128, 16>, OutT, P>(p, plan, stream);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same on the element type code: 0 float32, 1 bfloat16.
inline int launch(int dtype, const Problem& p, const Plan& plan, cudaStream_t stream) {
  if (dtype == 0) return launch_typed<float>(p, plan, stream);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(p, plan, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace conv3x3_core
