"""PyTorch/CUDA port of `conditional_score_diffusion_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps
the name of its counterpart there (`sde/ve.py`, `models/layers.py`,
`sampling/pc.py`, ...) and the public functions keep its NHWC layout.  This
package imports `torch` and `numpy` only, never JAX nor anything of the JAX
package; what it needs from there is copied.

The slice ported so far is the flagship CMDE conditional PC sampler
(`ddpm_paired`, multi-speed VE SDE, conditional reverse diffusion +
Langevin) with the fused GroupNorm+SiLU+conv3x3 resblock tail as a CUDA
kernel (`ops/fused_tail.py`, `csrc/gn_silu_conv3x3.cu`).
"""
