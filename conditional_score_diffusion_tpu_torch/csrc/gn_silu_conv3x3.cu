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
//   1. gn_silu_act (csrc/gn_silu_act.cuh, shared with the whole-resblock
//      kernels): one block per (batch, group) takes the group's mean and
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
#include "gn_silu_act.cuh"

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
    err = gn_silu::launch_act<float, float, false>(x, nullptr, Cin, 0, gamma, beta, act, B, H * W, G, s);
  else if (dtype == 1)
    err = gn_silu::launch_act<__nv_bfloat16, __nv_bfloat16, false>(x, nullptr, Cin, 0, gamma, beta, act, B, H * W,
                                                                    G, s);
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
