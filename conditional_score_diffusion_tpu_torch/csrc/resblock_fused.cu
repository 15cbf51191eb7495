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
// x, skip and out are NHWC; x, skip, the packed weights and out are all
// float32 or all bfloat16 (T); gamma/beta/b0/temb/b1/bs are float32.  As in
// the TPU kernel, GroupNorm statistics are float32, each activation is
// rounded to T before its conv, every sum is float32, and h stays float32
// between conv0 and GN1.  The weights come packed by the host, once per
// weight: w0 as (3, 3, Cin, Cout); w1 as (3, 3, Cout, Cout) with, for a
// channel-mix shortcut, ws (Cin, Cout) stacked under it along K.
//
// Four launches on the caller's stream, no allocation (the wrapper passes
// the scratch a0, h, a1):
//   1. gn_silu_act (csrc/gn_silu_act.cuh) over cat(x, skip): one block per
//      (batch, group), float32 statistics in two passes, each channel read
//      from the half it lies in (a group that straddles channel Ca is
//      exact); writes a0 = silu(GN0(.)) in T once per element.
//   2. conv0 on the 3x3 main loop of csrc/conv3x3_core.cuh: M = B*H*W pixels
//      of all images, K = 9*Cin, N = Cout; epilogue + b0 + temb[b], stored
//      as float32 h.
//   3. gn_silu_act over h (float32 in, T out): a1 = silu(GN1(h)).
//   4. conv1 on the main loop with the shortcut folded into K: K = 9*Cout,
//      plus, for the channel mix, Ca + Cb more columns that read cat(x,
//      skip) at the output pixel (a tenth, centred tap) against ws's rows
//      of the packed B, so one accumulator holds conv1 + mix.  Epilogue:
//      + b1 (+ bs), + cat(x, skip)[m, n] for the identity residual, x
//      res_scale, rounded to T.
//
// What bounds it on an H100: at the flagship sampler's sites (B=8; 10x10
// and 5x5, 192-576 channels in, 288 out) the work is 2*9*B*H*W*(Cin+Cout)*
// Cout (+ 2*B*H*W*Cin*Cout for a mix shortcut) operations, 0.6-3.4 GFLOP,
// on ~1-4 MB of data: bound by operations on paper (a few microseconds on
// the tensor cores in bfloat16, 10-50 us on the CUDA cores in float32), in
// practice by filling 132 SMs with 200-800 pixels and by the fixed cost of
// four dependent launches.  An earlier version of this file ran 31x slower
// than cuDNN's convs in bfloat16: 63 blocks of 64 threads at 5x5, the
// activation recomputed for every tap and N tile, bfloat16 summed on the
// CUDA cores, synchronous scalar loads, the shortcut a second K loop.  This
// design puts both convs on the main loop that the 3x3 conv and the fused
// tail share: all pixels packed into M, K split over a thread-block cluster
// and reduced in rank order through distributed shared memory where the
// tiles are fewer than the SMs (deterministic, no float atomics), cp.async
// with 16-byte copies, mma.sync with float32 accumulators in bfloat16; each
// activation is computed once, by a GroupNorm pass, and the shortcut costs
// K chunks.  Measured so (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W),
// a call at those sites takes 1.06-1.33x cuDNN's two convs and the
// shortcut's matmul in bfloat16 and 0.52-0.87x in float32: in bfloat16 the
// two GroupNorm passes and the four dependent launches are what the
// library's bare convs do not pay.

#include "conv3x3_core.cuh"
#include "gn_silu_act.cuh"

namespace {

template <typename T>
int launch_block(const void* x, const void* skip, int Ca, int Cb, const void* gamma0, const void* beta0, int G0,
                 const void* w0, const void* b0, const void* temb, const void* gamma1, const void* beta1, int G1,
                 const void* w1, const void* b1, int mix, const void* bs, float res_scale, void* out, void* a0,
                 void* h, void* a1, int B, int H, int W, int Cout, const conv3x3_core::Plan& plan0,
                 const conv3x3_core::Plan& plan1, int a_vec0, int b_vec0, int a_vec1, int b_vec1,
                 cudaStream_t stream) {
  const int Cin = Ca + Cb, HW = H * W, M = B * HW;
  int err = skip != nullptr
                ? gn_silu::launch_act<T, T, true>(x, skip, Ca, Cb, gamma0, beta0, a0, B, HW, G0, stream)
                : gn_silu::launch_act<T, T, false>(x, nullptr, Ca, 0, gamma0, beta0, a0, B, HW, G0, stream);
  if (err != 0) return err;

  conv3x3_core::Problem p0 = {};
  p0.x = a0, p0.w = w0, p0.bias = static_cast<const float*>(b0), p0.temb = static_cast<const float*>(temb);
  p0.out = h;
  p0.M = M, p0.H = H, p0.W = W, p0.Cin = Cin, p0.Cout = Cout;
  p0.xsb = HW * Cin, p0.xsh = W * Cin, p0.xsw = Cin, p0.osb = HW * Cout, p0.osh = W * Cout, p0.osw = Cout;
  p0.a_vec = a_vec0, p0.b_vec = b_vec0;
  err = conv3x3_core::launch_typed<T, float>(p0, plan0, stream);
  if (err != 0) return err;

  err = gn_silu::launch_act<float, T, false>(h, nullptr, Cout, 0, gamma1, beta1, a1, B, HW, G1, stream);
  if (err != 0) return err;

  conv3x3_core::FoldProblem p1 = {};
  static_cast<conv3x3_core::Problem&>(p1) = p0;
  p1.x = a1, p1.w = w1, p1.bias = static_cast<const float*>(b1), p1.temb = nullptr, p1.out = out;
  p1.Cin = Cout;
  p1.xsb = HW * Cout, p1.xsh = W * Cout, p1.xsw = Cout;
  p1.a_vec = a_vec1, p1.b_vec = b_vec1;
  p1.ra = x, p1.rb = skip, p1.Ca = Ca, p1.Cb = Cb, p1.mix = mix;
  p1.bias2 = static_cast<const float*>(bs), p1.res_scale = res_scale;
  return conv3x3_core::launch_typed<T, T, conv3x3_core::FoldProblem>(p1, plan1, stream);
}

}  // namespace

extern "C" {

// skip null: the block kernel on x (Ca channels; Cb must be 0).  skip given:
// the split kernel on cat(x, skip) (Ca + Cb channels).  temb and bs may be
// null.  mix 1: w1 is the packed [w1 ; ws] of (9*Cout + Ca + Cb, Cout);
// mix 0: w1 is (9*Cout, Cout) and the residual is the identity, which needs
// Ca + Cb == Cout.  a0 (B*H*W*(Ca+Cb) of T), h (B*H*W*Cout float32) and a1
// (B*H*W*Cout of T) are scratch.  dtype: 0 = float32, 1 = bfloat16.  The
// two plans (bm, bn, bk, stages, splits, smem bytes, a_vec, b_vec) are the
// host's (ops/conv3x3.py:launch_plan) for conv0 and for conv1 with the
// folded shortcut, checked against the compiled configurations.  Returns a
// cudaError_t (0 on success).
int resblock_fused_launch(const void* x, const void* skip, int Ca, int Cb, const void* gamma0, const void* beta0,
                          int G0, const void* w0, const void* b0, const void* temb, const void* gamma1,
                          const void* beta1, int G1, const void* w1, const void* b1, int mix, const void* bs,
                          float res_scale, void* out, void* a0, void* h, void* a1, int B, int H, int W, int Cout,
                          int dtype, int bm0, int bn0, int bk0, int stages0, int splits0, int smem0, int a_vec0,
                          int b_vec0, int bm1, int bn1, int bk1, int stages1, int splits1, int smem1, int a_vec1,
                          int b_vec1, void* stream) {
  if (skip == nullptr) Cb = 0;
  const int Cin = Ca + Cb;
  if (!conv3x3_core::dims_ok(B, H, W, Cin, Cout) || (skip != nullptr && Cb <= 0) || G0 <= 0 || G1 <= 0 ||
      Cin % G0 != 0 || Cout % G1 != 0 || (mix == 0 && Cin != Cout) ||
      (9L * Cout + Cin) * Cout >= (1L << 31) || b0 == nullptr || b1 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const conv3x3_core::Plan plan0 = {bm0, bn0, bk0, stages0, splits0, smem0};
  const conv3x3_core::Plan plan1 = {bm1, bn1, bk1, stages1, splits1, smem1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_block<float>(x, skip, Ca, Cb, gamma0, beta0, G0, w0, b0, temb, gamma1, beta1, G1, w1, b1,
                               mix != 0, bs, res_scale, out, a0, h, a1, B, H, W, Cout, plan0, plan1, a_vec0,
                               b_vec0, a_vec1, b_vec1, s);
  if (dtype == 1)
    return launch_block<__nv_bfloat16>(x, skip, Ca, Cb, gamma0, beta0, G0, w0, b0, temb, gamma1, beta1, G1, w1,
                                       b1, mix != 0, bs, res_scale, out, a0, h, a1, B, H, W, Cout, plan0, plan1,
                                       a_vec0, b_vec0, a_vec1, b_vec1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* resblock_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
