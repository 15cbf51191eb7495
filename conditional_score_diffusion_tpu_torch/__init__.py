"""PyTorch/CUDA port of `conditional_score_diffusion_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps
the name of its counterpart there (`sde/ve.py`, `models/layers.py`,
`sampling/pc.py`, ...) and the public functions keep its NHWC layout.  This
package imports `torch` and `numpy` only, never JAX nor anything of the JAX
package; what it needs from there is copied.

The slices ported so far are the flagship CMDE conditional PC sampler
(`ddpm_paired`, multi-speed VE SDE, conditional reverse diffusion +
Langevin, in float32 or bfloat16 compute), the NCSN++ DF2K direct 4x
sampler (`ncsnpp_KxSR` under VS-CMDE) and the flagship trainer (`losses/`,
`training/`, `main.py --mode train`), with seven TPU kernels as CUDA
kernels: the fused GroupNorm+SiLU+conv3x3 tail (`ops/fused_tail.py`), the
whole resblock and its split-skip variant (`ops/fused_block.py`), the
factor-2 FIR upsample and downsample (`ops/fir.py`) and the 3x3 conv with
its input gradient, in NHWC and (H, W, B, C) (`ops/conv3x3.py`), sources in
`csrc/`.
"""
