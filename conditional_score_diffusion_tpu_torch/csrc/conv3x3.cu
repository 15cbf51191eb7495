// 3x3 SAME stride-1 convolution (+ bias) for sm_90a: the forward of every
// 3x3 stride-1 conv of the flagship train step and, with the weights rotated
// by 180 degrees and Cin/Cout swapped, its input gradient.
//
// Replaces the TPU kernels `conv3x3_pallas`
// (conditional_score_diffusion_tpu/ops/conv_pallas.py:198; pallas_call :90 in
// `_conv3x3_pallas_fwd_impl` :76) and `conv3x3_hmajor` (:144; pallas_call
// :159), the same conv on an (H, W, B, C) layout.
//
//   out[b, y, x, o] = bias[o] + sum_{dy, dx, i} in[b, y + dy - 1, x + dx - 1, i] * w[dy, dx, i, o]
//   in outside the image is 0 (the SAME padding, by bounds checks: no padded copy)
//
// Layout: channels are contiguous; an element (b, y, x, c) of `in` is at
// b * xsb + y * xsh + x * xsw + c, and of `out` at b * osb + y * osh + x * osw
// + c.  NHWC is (xsb, xsh, xsw) = (H*W*C, W*C, C); (H, W, B, C), the TPU
// kernel 5's layout, is (C, W*B*C, B*C): one kernel serves both.  `w` is
// (3, 3, Cin, Cout) contiguous (the wrapper repacks PyTorch's OIHW), `bias`
// float32 or null.  in, w and out are all float32 or all bfloat16; the sums
// are float32 and the output is rounded once.
//
// What bounds it on an H100 at the train step's shapes (B=16, float32):
// 2*9*M*Cin*Cout operations on a few MB, so operations: 67 TFLOP/s on the
// CUDA cores (TF32 stays off for parity), ~1 ms at 160x160x96 -> 96 (68
// GFLOP).  At 20x20 and below the work is 0.6-2.4 GFLOP in a handful of
// 128-pixel tiles: there the bound is filling 132 SMs, not the FMAs.
//
// Design (csrc/conv3x3_core.cuh): an implicit GEMM over all images' pixels
// with taps and channels flattened into K, a 4-stage cp.async ring, 8 x 6
// (or 8 x 4) outputs a thread in float32 and mma.sync in bfloat16, and
// split-K over a thread-block cluster reduced through distributed shared
// memory where the tiles do not fill one wave.  The host computes the plan
// (tile, stages, splits, copy widths; ops/conv3x3.py:launch_plan)
// and this entry checks it against the compiled configurations.

#include "conv3x3_core.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias may be null.  Strides are in
// elements; the channel stride is 1.  The plan (bm, bn, bk, stages, splits,
// smem bytes, a_vec, b_vec) must be one the core compiles.
// Returns a cudaError_t (0 on success).
int conv3x3_launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                   int Cin, int Cout, int xsb, int xsh, int xsw, int osb, int osh, int osw, int dtype,
                   int bm, int bn, int bk, int stages, int splits, int smem, int a_vec, int b_vec,
                   void* stream) {
  if (!conv3x3_core::dims_ok(B, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const conv3x3_core::Problem p = {
      x, w, static_cast<const float*>(bias), nullptr, out,
      B * H * W, H, W, Cin, Cout,
      xsb, xsh, xsw, osb, osh, osw,
      a_vec, b_vec};
  const conv3x3_core::Plan plan = {bm, bn, bk, stages, splits, smem};
  return conv3x3_core::launch(dtype, p, plan, static_cast<cudaStream_t>(stream));
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
