#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases, each printing its own line with its seconds:

1. device: needs a CUDA device (exits non-zero without one); prints the card's
   name and power limit as nvidia-smi gives them, and the TF32 switches
   (both off: the port runs float32 as float32).
2. build: builds the five kernel sources (csrc/gn_silu_conv3x3.cu,
   csrc/resblock_fused.cu, csrc/fir_resample.cu, csrc/conv3x3.cu,
   csrc/fused_bias_act.cu; the first, second and fourth include the shared
   3x3 main loop csrc/conv3x3_core.cuh, the first two the GroupNorm+SiLU
   pass csrc/gn_silu_act.cuh) with nvcc, in parallel, each with its seconds
   and its ptxas lines.
3. kernel: each kernel against its plain PyTorch version at the shapes its
   path gives it, float32 and bfloat16 (2e-2 of the largest magnitude;
   float32 1e-4, the FIR kernels 1e-5): the fused tail at the flagship's
   20x20x192, 10x10x288, 5x5x288, with and without temb; the whole-resblock
   kernels at the flagship's six sites (block 10x10 192->288 with the NIN
   shortcut, 10x10 288->288, 5x5 288->288; split 5x5 288+288, 10x10
   288+288, 10x10 288+192 -> 288, where a 15-channel group straddles the
   concat), with and without temb and once with skip_rescale; then each
   one's time, its plain version's, a library yardstick's and its bound
   (B=8), and the kernel / library ratio.  Every time is the device's: CUDA
   events around calls enqueued behind a `torch.cuda._sleep` (`time_ms`).  The same three kernels at the NCSN++ block variant's
   sites (tails at 20x20x128 to 5x5x256, float32 timed; blocks with the
   1x1-conv shortcut and skip_rescale, splits 256+256 and 256+128, checked
   only).  The FIR
   upsample and downsample at the 20 shapes of one NCSN++ forward (5x5 to
   160x160, 6 to 256 channels; a non-symmetric kernel at two of them),
   timed with their operands out of L2 (calls rotated over copies of 100 MB
   or more, `rotated`) beside their plain versions, the depthwise cuDNN
   call and the bound, and L2-resident (one input over and over); then
   at inputs 4 bytes off an aligned address, 3 channels and odd H and W
   (`FIR_EXTRA_CASES`).  The 3x3 conv (kernel 4) at the 27 distinct forward and dx shapes
   of the flagship train step (B=16, 160x160x6 to 5x5x288; counted on the
   meta device), timed beside its plain version, F.conv2d and the bound;
   its autograd input gradient against F.conv2d's at two shapes; kernel 5's
   (H, W, B, C) entry at two shapes.  The fused tail at the texture64
   harness's shapes (B=16: 16x16x128, 8x8x128, 4x4x192; counted on the meta
   device), timed.  The whole-resblock kernels at the trained texture64
   model's block sites with fused_block on (B=16, 8x8 and 4x4; counted on
   the meta device against `TEXTURE64_BLOCK_SHAPES`), float32 and
   bfloat16, with and without temb, checked.  The fused bias + leaky ReLU
   (kernel 8) at (16, 64, 64,
   64) and (8, 160, 160, 96) with a bias and the default slope and gain, and
   at (3, 5, 7, 6) without a bias and with slope 0.1, gain 1.0 (float32
   within 1e-6 of the largest magnitude, bfloat16 within two bfloat16 steps
   of each element), timed beside its plain three-op chain and its byte
   bound; no single PyTorch call computes it, so its library time is null.
4. agreement: the same weights with the kernels on and off: the float32
   tail path and the flagship block path (fused_block and fused_tail) in
   float32 and in bfloat16 compute; the NCSN++ path with the FIR kernels
   against their plain versions, and its block variant (fused_tail,
   fused_block) against the path without them, both float32.  Each: the
   score on the sampler's own input at t = 0.5, a 3-step sample and the raw
   network output on the clean batch; float32 at 1e-4, bfloat16 as
   `agreement` says (2e-2).  After the samplers, the train step with kernel
   4 on and off (`train_agreement`), and the trained texture64 EMA's score
   with the fused tail on and off, then with fused_block and fused_tail on
   against both off (`texture64_agreement`: float32 1e-4; bfloat16 compute,
   the tensor-core paths, by norm 2e-2; the block and tail launches of one
   forward counted exactly).
5. main (the flagship block path): texture160 test batch 0 (8 images, y =
   8x SR degradation), the full-width ddpm_paired with seeded N(0, 0.02)
   weights, bfloat16 compute through `get_score_fn(compute_dtype=...)` ->
   `get_conditional_score_fn` -> `get_pc_conditional_sampler` (as the JAX
   bench composes it), fused_block and fused_tail on, 20 of the recipe's
   1000 steps (its time per evaluation does not depend on the count).  Each
   kernel's launch counter, set to 0 just before, must read exactly its
   count per forward x 2 x 20 just after.
6. main (the float32 tail path): the same batch and weights, float32,
   fused_tail only, through `get_conditional_sampling_fn`, 10 steps; the
   tail's counter must read 17 x 2 x 10.
7. main (the NCSN++ path): the DF2K direct 4x recipe on texture160
   (`texture160_kxsr_ncsnpp`): the first 8 test pairs (the recipe's eval
   batch of 32 cut to 8), x 160x160 and y the committed 40x40 LQ images;
   the full-width ncsnpp_KxSR (nf=64, ch_mult (1,1,2,2,4,4), 32.1 M
   parameters) with seeded N(0, 0.02) weights; the multi-speed VE SDE with
   sigma_y as the VS-CMDE schedule leaves it (sigma_y,max 138.6); float32
   through `get_conditional_sampling_fn`, 20 steps; the FIR counters must
   read 15 x 2 x 20 each.  Then one backward through the same model at
   B=1 (`ncsnpp_backward`): finite gradients equal by norm to those with
   every FIR call on its plain version, and the FIR kernels launched only
   on the input pyramid, none in the backward.
8. main (the trainer path): `Trainer(texture160_sr_cmde_conv3x3)
   .fit(max_steps=10)`: the texture160 train split, batch 16, float32,
   dropout 0.1, the DDPM init, every 3x3 stride-1 conv and its input
   gradient on kernel 4; train_loss finite, one eval_loss on the EMA (4
   batches of the test split: the val split is not sent to the card),
   a checkpoint restored exactly into a new trainer; kernel 4's counter
   exactly (89 + 88) x 10 + 72 x 4, the tail's 17 x 4, every other 0.
   Then the same for 3 steps with the policy off (every counter 0).  Each
   prints ms per step and images/s over the sustained window, the peak
   memory, and one step split by CUDA events.
9. main (the --mode test harness, new; in a child process, see below):
   `run_test` with the recipe
   `texture64_sr_cmde_test` on test batch 0 (16 images, y = 4x SR
   degradation): the trained texture64 EMA (13,644,550 parameters, the
   committed torch file), draws 2, 3, 4 at snr 0.15, 1000 steps, float32
   with TF32 off, fused_tail on; the tail's counter must read (its calls per
   forward, counted on the meta device) x 2 x 1000 x 3, every other 0.  Each
   draw's metrics and seconds, the batch means and ms per score evaluation;
   the means held against the JAX harness's on the same checkpoint and
   batch (`HARNESS_JAX`).  Then `run_evaluation_pipeline` on the tree it
   wrote, its metrics printed; each draw's PSNR from the 8-bit PNGs, with
   the rounding's 1/12 level^2 taken out of each image's MSE, within 0.1 dB
   of the harness's (the raw difference printed beside it).
10. main (the paper's four other estimators, new): VS-CMDE (``ours_DV``),
   slow VS-CMDE (``ours_slowDV``), CDiffE (``song``) and CDE (``sr3``), each
   on its texture160 recipe with the flagship U-Net at full width (CDE:
   `ddpm_paired_SR3`, one VE SDE, y clean), seeded N(0, 0.02) weights,
   texture160 test batch 0 (B=8): the bfloat16 sampler with fused_block and
   fused_tail, 10 steps, sigma_y for VS-CMDE as its schedule leaves it at
   ``reach_target_steps``, after an untimed 2-step run; kernels 1-3 counted
   exactly (calls per forward on the meta device, `forward_calls`, which
   must be the flagship's, at the sites phase 3 checked).  For CDE and
   VS-CMDE first the kernels on against off as in phase 4.  Then
   `Trainer.fit(3)`, B=16, float32, kernel 4 on, first checked against its
   plain version at each train-step shape phase 3 did not check (CDE's
   3-channel output conv: forward 96->3, dx 3->96): finite train_loss,
   kernel 4 counted exactly, VS-CMDE's logged sigma_min_y / sigma_max_y at
   every step equal to `sigma_y_at_step`.
11. main (the unconditional VE NCSN++, new): `texture160_unconditional_ncsnpp`
   (`unconditional_pkl_config(128)` on texture160: NCSN++ nf=128, FIR,
   BigGAN resblocks), B=8, float32, seeded weights: the FIR kernels against
   their plain versions at the path's six shapes (`FIR_REL_TOL`) and on a
   3-step sample (1e-4) whose FIR counters read their calls per forward
   x 2 x 3; `get_sampling_fn` with reverse_diffusion + langevin, 10 steps,
   the FIR counters at their calls per forward x 2 x 10; 3-step runs of
   ancestral_sampling and ald; `show_evolution` on 5 steps, (5, 8, 128,
   128, 3), its last frame the final x of the same run without frames
   (1e-6), consecutive frames different; `Trainer.fit(3)` through
   `unpaired_PKLDataset` at B=8 (every FIR call carries a gradient and
   takes its plain version: counters 0).
12. main (DDPM++ under VP and sub-VP, new): `cifar10_vp_config` at 32px,
   B=64, seeded weights: euler_maruyama + none, 10 steps (after an untimed
   2-step run); 3-step runs with
   langevin and (VP) ancestral_sampling (sub-VP refuses it, as JAX does);
   one Langevin step's size against (snr |z| / |score|)^2 2 alpha with
   alpha = alphas[timestep] under VP (1e-5); a loss and backward with finite
   gradients; no kernel runs, so every counter reads 0.
13. main (the trained texture64 Haar pyramid, new; in a child process):
   ``main.py --mode
   multi_scale_test --config texture64_multiscale_master`` in-process: the
   two VS-CMDE detail scales (16px DC -> 32px -> 64px, ddpm_paired nf=48)
   with their converted EMA files, sigma_y at each checkpoint's step,
   texture64 test batch 0 (B=8), 2000 steps a scale, float32, kernels off
   as JAX runs it; every counter 0; its PSNR and SSIM against the final
   GT within `PYRAMID_BAND` (set from the JAX chain's spread over seeds
   42-44 on the same checkpoints and batch), its zero-detail control at
   JAX's (1e-4).  Then the _block variant (kernels 1-3) against it on a
   3-step chain: final images at 1e-4, launches exact.
14. main (the celebA-HQ-160 sequential chains on texture160, new): scales
   40 (nf 96), 80 (nf 96) and 160 (nf 64), random weights read from EMA
   files: the Haar chain (ddpm_paired on the detail bands) kernels on
   against off over 3 steps a scale, then its _block variant over 10 steps
   a scale, ms per score evaluation per scale; the bicubic chain
   (ddpm_2xSR) on per-scale LQ/GT files made from the texture160 test split
   with the port's bicubic resize, its _block variant over 3 steps a scale.
   Kernels 1-3 counted exactly (their calls per forward of each scale on
   the meta device, `chain_sites`, whose sites the kernel phase checked
   against the plain versions with the DDPM's groups: `check_chain_sites`).
15. main (the direct 8x ddpm_KxSR, new): nf 96, ch_mult (1,1,2,2,3,3),
   random weights, the first 8 texture160 test images, y their 20px
   bicubic LQ: kernels on against off (`agreement`), then 5 steps with
   fused_block and fused_tail, the flagship's calls per forward.
16. main (the GaussianBubbles toy through the CLI, new; in a child
   process): ``main.py --mode
   train --config toy_gaussian_bubbles`` in-process (the FCN, 10,000 steps
   of B=256, the ``2D`` callback every 2,000 steps at its full 500 steps),
   ms per step over the sustained windows; then 4,000 PC samples (500
   steps) from the last checkpoint's EMA, scored as
   `scripts/head_to_head.py` scores them (`eval/toy.py`): mode mass max
   deviation and energy distance in `TOY_BAND` (set from the JAX run's
   spread over three seeds); no callback failure logged; no kernel runs.
17. main (the paired callback at full length, new; in a child process):
   a `Trainer` on
   `texture64_sr_cmde` with the committed EMA, float32 with the fused tail
   (the harness's knobs), its ``paired`` callback fired once: 1000 steps
   on the first 8 test images; the tail counted exactly (its calls per
   forward x 2 x 1000); the PSNR of the grid's sample column against its
   ground-truth column in `PAIRED_BAND` (set from the JAX callback on the
   same checkpoint and images over three keys).
18. main (the NCSN++ DF2K direct 4x trainer, new): `texture160_kxsr_ncsnpp`
   at full width (nf 64, ch_mult (1,1,2,2,4,4), attention at 20/10/5),
   B=16, float32, the texture160 train split with its 4x LQ file written
   to a temp dir: `Trainer.fit(12)` with ``CSDT_PROFILE_DIR`` set (the
   trace of steps 3-5 written there); finite losses and gradient norms,
   the EMA moved, the Fourier W unchanged, a checkpoint restored exactly,
   the FIR downsample kernel counted exactly on the raw input's pyramid
   (5 a step: no gradient flows there; every other FIR call takes the
   plain version); ms per step, the window's device time by kernel, and
   the plain FIR's share of it (`profile_train_step.py`:
   `recording_upfirdn`, `plain_fir_ms`).  Then its ``KxSR`` callback once
   at ``visualization_p_steps = 10``: FIR kernels 6-7 counted exactly, the
   grid against the same callback with the plain FIR at 1e-4.
   Every phase's trainer must have recorded no callback failure.
19. main (the probability-flow ODE sampler, new): JAX's analytic test on
   the card (VE sigma 0.01-10, N = 200, 2048 x 1 samples from the exact
   score of N(1.5, 0.5^2): each sample the exact flow of its prior draw at
   1e-4, mean and std within 0.08 of the flow's), then
   `texture160_unconditional_ncsnpp` with ``sampling.method = "ode"``
   through `get_sampling_fn` (B = 8, 128px, float32, seeded weights): the
   score evaluations counted by a hook on the model, each FIR counter at
   6 x that count; the same prior with every FIR call on its plain
   version: where both took the same steps the samples at 1e-4 of their
   scale, else by norm at 1e-3; ms per evaluation and seconds.
20. main (bits/dim, new): JAX's analytic N(0, 1) test (within 0.1);
   `evaluate_bpd` on the same NCSN++, the texture160 test split through
   `unpaired_PKLDataset` at 128px, one batch of 1 (cut from the recipe's
   eval batch and JAX's 8 batches): bpd and z finite, every FIR counter 0
   (every call carries a gradient), score evaluations, seconds, peak
   memory; the reverse-mode divergence against `torch.func.jvp` on the
   plain path at one (x, t), 1e-4 relative; one divergence of the
   texture64 Haar DDPM with fused_block and fused_tail on (B = 1): kernels
   1-3 at 0 launches, the value the knobs-off one's at 1e-5.
21. main (inpainting and colorization, new; every SDE cut from 1000 to 10
   steps): `get_inpainting_fn` on the NCSN++, texture160 test batch 0 (B =
   8, 128px), a random square mask of coverage 0.25: the known pixels the
   data's at 1e-6, the FIR counters at 6 x 2 x 10; `get_pc_colorizer`
   (reverse_diffusion + langevin, snr 0.15) on the batch's grayscale: its
   decoupled gray channel the input's at 1e-4 of the output's largest
   magnitude, the FIR counters exact;
   `HaarMultiScaleTask.inpaint_hf` on `texture64_haar_multiscale_unconditional_block`
   (DDPM nf 128, 32x32x12 coefficients, random weights) with the DC band of
   texture64 test batch 0 (B = 8): kernels 1-3 against plain at its sites
   no earlier phase checked, kernels on against off over 3 steps (1e-4,
   launches exact), then 10 steps with the output's DC the input's at 1e-5
   and every counter at its calls per forward x 2 x 10.
22. main (the paper's other inverse problems, new; `configs/inverse_problems.py`):
   the texture twins of the inpainting and colorization recipes (128px,
   nf 96, on the texture160 GT images), the edges2shoes recipe (64px, nf
   128, on a PNG tree of texture64 images and their 4x SR degradation) and
   the MRI->PET recipes (96px one-channel slices, nf 96; [96, 96, 16]
   volumes through ddpm3D_paired), on trees written to a temp dir.  Kernels
   1-3 per forward of each _block twin on the meta device against
   `INVERSE_TWINS`, each against its plain version at the sites no earlier
   phase checked (down to 3x3), each timed; per 2-D twin, kernels on
   against off (`agreement`, float32 1e-4), then the conditional PC sampler
   at B = 8 for 20 of its 1000 steps, every counter exact; `Trainer.fit(3)`
   of all five twins at their recipes' train batches (25, 25, 50, 32, 4
   volumes), finite losses, kernels 1-3 at 0 under the gradient; `run_test`
   on the inpainting twin (test batch 0 of 25, draws 1 and 2, 10 steps),
   then the evaluation pipeline on its tree, whose masks re-rolled from
   the PNG numbers must be the batch's; the ``paired3D`` callback on the
   3-D twin at its 100 steps; ``--mode compute_dataset_statistics`` on the
   texture64 recipe (200 batches), its mean.npy (32, 32, 9) against a
   float64 host recomputation at 1e-5.
23. main (the score_sde baselines, new; `configs/score_sde.py`): the texture
   twins of `configs/ve/ncsnv2/celeba.py` (ncsnv2_64, 64px), `bedroom.py`
   (ncsnv2_128, 128px), `configs/ve/ncsn/cifar10_124.py` (ncsn, 32px),
   `configs/ve/cifar10_ncsnpp.py` (the discrete-VE NCSN++, 32px, FIR) and
   `configs/vp/ddpm/cifar10.py` (the discrete DDPM, 32px), each at full
   width with seeded N(0, 0.02) weights, their data flat PNG folders
   written to a temp dir (the first 1,280 texture64 train images; the
   texture160 train images resized to 128px once) and read by the
   ``image`` datamodule.  The FIR kernels against plain at the NCSN++
   twin's 6 shapes (counted on the meta device), timed as in phase 3, and
   on against off on a 3-step sample of its sampler; each twin's sampler
   (ALD for the NCSN twins, reverse diffusion + Langevin, ancestral
   sampling) at B = 8 for about 20 score evaluations, the FIR counters
   exact; `Trainer.fit` at each recipe's train batch (3 steps; 2 for the
   128px twin, its batch halved until the step fits in the card's memory),
   finite losses, every counter 0 (the NCSN++ train step's FIR calls carry
   a gradient); then ``main.py --mode train --config
   configs/ve/ncsnv2/celeba.py --data_path <twin dir>`` in-process for 2
   steps (the path table's recipe, its n_iters cut by wrapping the table
   entry for the call).
24. main (the celebA multi-scale recipes and the Haar-flow trainer, new;
   `configs/srflow.py`, `configs/extra.py`): the texture160 train images
   written as celebA JPEGs, the recipes' Haar trees built from them by
   `data/builder.py` (celebA 160 / 80 / 40, celebaHQ 128),
   and celebA's fixed split in symbolic links for ``bicubic_multiscale``
   (the test images past file 162,770), the builds' seconds and each
   datamodule's ms a batch; kernels 1-3 per forward of the seven recipes'
   _block variants against `MULTISCALE_PER_FORWARD` (meta device) and
   against plain at the 17 sites no earlier phase checked (down to 2x2 at
   384 channels), timed; ``main.py --mode train --config
   configs/ve/srflow/celebA/haar/config_40.py`` in-process for 2 steps
   (``ddpm_paired`` nf 128, B=128), `Trainer.fit(2)` of
   `celeba_bicubic_config(160)` (``ddpm_SR`` nf 128 at 160px, B=32) and
   `haarflow_config(128)` (``ddpm`` nf 128 on 12 channels at 64x64,
   B=32), each batch halved only where the step does not fit; both celebA
   master files by path (the bicubic one chained in the bicubic space it
   needs; its file names none, and JAX's default, haar, cannot chain it)
   with random weights, kernels on against off over 3 steps a scale, then
   ``--mode multi_scale_test`` by path over 10 steps a scale, every launch
   at its count.
25. agreement / main (the perceptual metrics, new; `eval/inception.py`,
   `eval/lpips.py`, `eval/fid.py`): seeded synthetic weights written as
   the reference files; Inception taps 0-3 and LPIPS of 8 texture160 test
   images on the card (float32, TF32 off) against the CPU in float64
   (1e-4), FID and joint FID from both (1e-3), timed; then the evaluation
   pipeline with ``CSDT_INCEPTION_WEIGHTS`` / ``CSDT_LPIPS_ALEXNET`` /
   ``CSDT_LPIPS_LIN`` set reports ``lpips``, ``fid``, ``joint_fid`` and
   ``best_25_lpips_ids``.
26. main (data parallelism, new; `parallel/`): the flagship trainer
   (`texture160_sr_cmde_conv3x3`, B=16, kernel 4) `Trainer.fit(4)` under a
   one-rank NCCL group (``file://`` rendezvous) against the same fit
   without one, cuDNN held to its deterministic algorithms: losses, params,
   EMA and the all-reduced eval loss bit for bit; kernel 4's launches
   equal; the profiler window on steps 3-4 attributed by
   `profiling.attribute` (family table printed), its ``conv3x3_gemm``
   launches equal to the counter's increase over those steps and its device
   total within 2% of ``key_averages()``; ms per step each way.
27. main (sharded sampling, new): the bfloat16 flagship sampler, 2 steps at
   B=8, through `parallel.shard_sampling_fn` at world 1 against the plain
   call: samples bit for bit, kernels 1-3 at equal counts.
28. setup / agreement (reference checkpoints, new;
   `models/reference_checkpoint.py`): the flagship ``ddpm_paired`` with
   seeded weights written as a reference Lightning ``.ckpt`` whose
   ``hyper_parameters`` cannot be imported, loaded onto the card: its state
   dict equal to `convert.py`'s of the same arrays, then float32 with
   kernels 1-3 on against off (``agreement``, 1e-4) at their counts.
29. main (the host batch, new; `data/native.py`): 16 texture160 images,
   GT up 1 and a 20px LQ up 8, with flips, through the C++ path and numpy:
   bit for bit, ms a batch each way.
30. result: a JSON line of the kernels (with each one's launches on the
   paths of phases 10-29), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

The step counts of the paths without a quality band (5-8, 10-12, 14, 18,
21-24) are cut short; the time per evaluation or step does not depend on
them.  The quality-gated phases keep their full length and are host-bound,
so they run in three child processes of this script (`Child`: phase 9;
16; 17 and 13), started after phase 10 and joined before
phase 22, while this process runs phases 11, 12, 14, 15 and 18-21, none of
which times a kernel.  Their lines are printed when they are joined; the
host times of phases 9-21 are taken with four processes on the card.
Every phase's progress also goes to stderr with the run's seconds.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import gc
import itertools
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from conditional_score_diffusion_tpu_torch import main as cli  # noqa: E402
from conditional_score_diffusion_tpu_torch.configs import (  # noqa: E402
    cifar10_vp_config,
    texture160_direct_8x_block_config,
    texture160_direct_8x_config,
    texture160_kxsr_ncsnpp_block_config,
    texture160_kxsr_ncsnpp_config,
    texture160_sr_cmde_bf16_block_config,
    texture160_sr_cmde_config,
    texture160_sr_cde_config,
    texture160_sr_cdiffe_config,
    texture160_sr_cmde_conv3x3_config,
    texture160_sr_vscmde_config,
    texture160_sr_vscmde_slow_config,
    texture160_unconditional_ncsnpp_config,
    texture64_haar_multiscale_unconditional_block_config,
    texture64_haar_multiscale_unconditional_config,
    texture64_multiscale_master_block_config,
    texture64_multiscale_master_config,
    texture64_sr_cmde_config,
    texture64_sr_cmde_test_config,
)
from conditional_score_diffusion_tpu_torch.configs.texture160_kxsr_ncsnpp import (  # noqa: E402
    train_config as texture160_kxsr_ncsnpp_train_config,
)
from conditional_score_diffusion_tpu_torch.configs.inverse_problems import (  # noqa: E402
    texture160_colorization_cmde_block_config,
    texture160_inpainting_cmde_block_config,
    texture64_i2i_cmde_block_config,
    texture_mri_to_pet_3d_config,
    texture_mri_to_pet_slices_block_config,
    write_texture64_paired,
    write_texture_mri_to_pet,
)
from conditional_score_diffusion_tpu_torch.configs import score_sde  # noqa: E402
from conditional_score_diffusion_tpu_torch.configs.score_sde import (  # noqa: E402
    texture128_ncsnv2_bedroom_config,
    texture32_ddpm_cifar10_vp_config,
    texture32_ncsn_cifar10_124_config,
    texture32_ncsnpp_cifar10_smld_config,
    texture64_ncsnv2_celeba_config,
    write_twin_folders,
)
from conditional_score_diffusion_tpu_torch.configs.multiscale import (  # noqa: E402
    texture160_sequential_master_config,
    write_texture160_sequential_data,
)
from conditional_score_diffusion_tpu_torch.configs.extra import haarflow_config  # noqa: E402
from conditional_score_diffusion_tpu_torch.configs.srflow import celeba_bicubic_config, celeba_haar_config  # noqa: E402
from conditional_score_diffusion_tpu_torch.data import sr_multiscale  # noqa: E402
from conditional_score_diffusion_tpu_torch.data.builder import create_dataset, create_haar_dataset  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval import inception as fid_inception  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval import lpips as lpips_metric  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval.fid import fid_from_activations, joint_fid_from_activations  # noqa: E402
from conditional_score_diffusion_tpu_torch.data.degradations import (  # noqa: E402
    bicubic_lq_images,
    grayscale,
    random_square_mask,
)
from conditional_score_diffusion_tpu_torch.data.pkl_datasets import (  # noqa: E402
    PKLDataModule,
    iter_test_batches,
    load_pkl_images,
)
from conditional_score_diffusion_tpu_torch.data import create_datamodule, statistics  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval import bpd as bpd_eval  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval import multiscale  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval.harness import load_model, output_dir, run_test, save_png  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval import pipeline as eval_pipeline  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval.metrics import ConsistencyUnavailable, get_consistency_fn  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval.metrics import psnr as psnr_fn  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval.toy import sample_toy  # noqa: E402
from conditional_score_diffusion_tpu_torch.eval.pipeline import load_images, numbered, run_evaluation_pipeline  # noqa: E402
from conditional_score_diffusion_tpu_torch.models import create_model, init_model_random, layers  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.layers import legacy_num_groups  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.wrappers import (  # noqa: E402
    get_conditional_score_fn,
    get_model_fn,
    get_score_fn,
)
from conditional_score_diffusion_tpu_torch.ops import conv3x3, fir, fused_act, fused_block, fused_tail  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops.fused_tail import conv3x3_nhwc  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops.resize import full_float32  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops.upfirdn import setup_kernel  # noqa: E402
from conditional_score_diffusion_tpu_torch.profile_sampler import plain_versions, sampler_sde  # noqa: E402
from conditional_score_diffusion_tpu_torch.profile_train_step import (  # noqa: E402
    kernel_ms,
    plain_fir_ms,
    recording_upfirdn,
)
from conditional_score_diffusion_tpu_torch import parallel, profiling  # noqa: E402
from conditional_score_diffusion_tpu_torch.data import native  # noqa: E402
from conditional_score_diffusion_tpu_torch.models import reference_checkpoint  # noqa: E402
from conditional_score_diffusion_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from conditional_score_diffusion_tpu_torch.losses import build_loss_fn  # noqa: E402
from conditional_score_diffusion_tpu_torch.sampling import (  # noqa: E402
    get_conditional_sampling_fn,
    get_corrector,
    get_inpainting_fn,
    get_likelihood_fn,
    get_ode_sampler,
    get_pc_colorizer,
    get_pc_conditional_sampler,
    get_sampling_fn,
)
from conditional_score_diffusion_tpu_torch.sampling.controllable import decouple  # noqa: E402
from conditional_score_diffusion_tpu_torch.sampling.likelihood import get_div_fn  # noqa: E402
from conditional_score_diffusion_tpu_torch.sde import VESDE, VPSDE, batch_mul, build_sde, is_multispeed  # noqa: E402
from conditional_score_diffusion_tpu_torch.sde.factory import is_conditional_config  # noqa: E402
from conditional_score_diffusion_tpu_torch.training import callbacks  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.tasks import create_task  # noqa: E402
from conditional_score_diffusion_tpu_torch.ops.haar import get_hf_coefficients, haar_forward  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_eval_weights,
    save_ema,
)
from conditional_score_diffusion_tpu_torch.training.schedules import is_decreasing_variance, sigma_y_at_step  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.state import create_train_state  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.steps import make_train_step  # noqa: E402
from conditional_score_diffusion_tpu_torch.training.trainer import Trainer, read_scalars, to_device  # noqa: E402

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12
SLEEP_CYCLES_PER_S = 1.98e9  # `torch.cuda._sleep` spins SM clock cycles; 1.98 GHz is the H100's top clock
BATCH, GROUPS = 8, 32
# Gated tails of one flagship forward: (H, C, calls per forward) with the
# tail alone (the float32 tail path) and with the whole-block kernels on.
TAIL_SHAPES = [(20, 192, 5, 5), (10, 288, 5, 0), (5, 288, 7, 0)]
# Whole-block sites of one flagship forward: (kernel, H, Ca, Cb, Cout, calls).
BLOCK_SHAPES = [
    ("resblock_fused", 10, 192, 0, 288, 1),  # down_4_0, NIN shortcut
    ("resblock_fused", 10, 288, 0, 288, 1),  # down_4_1
    ("resblock_fused", 5, 288, 0, 288, 4),  # down_5_0, down_5_1, mid_block0, mid_block1
    ("resblock_fused_split", 5, 288, 288, 288, 3),  # up_5_0 .. up_5_2
    ("resblock_fused_split", 10, 288, 288, 288, 2),  # up_4_0, up_4_1
    ("resblock_fused_split", 10, 288, 192, 288, 1),  # up_4_2: a group straddles channel 288
]
# Launches per forward on each path, counted from `DDPM._down_plan` /
# `_up_plan` (tests/test_torch_fused_block_model.py counts them again on the
# meta device): with the tail alone it fires on the 17 blocks at 20x20 and
# below; with the block kernels on, the 12 blocks at 10x10 and below take
# those, and the tail keeps the 5 at 20x20.
PER_FORWARD_TAIL_PATH = {"gn_silu_conv3x3": 17}
PER_FORWARD_BLOCK_PATH = {"resblock_fused": 6, "resblock_fused_split": 6, "gn_silu_conv3x3": 5}
# Kernels 1-3 at the sites of the NCSN++ recipe with fused_tail and
# fused_block on (texture160_kxsr_ncsnpp_block; 32 groups everywhere):
# the tails (H, C), and the blocks with their 1x1-conv shortcut and
# skip_rescale (kernel, H, Ca, Cb, Cout).  Checked, not timed: that variant
# is held by `agreement`, the NCSN++ main path runs the FIR kernels alone.
NCSNPP_TAIL_SHAPES = [(20, 128), (10, 128), (5, 256), (10, 256), (20, 256)]
NCSNPP_BLOCK_SHAPES = [
    ("resblock_fused", 10, 128, 0, 256),  # down_4_0, 1x1-conv shortcut
    ("resblock_fused", 10, 256, 0, 256),  # down_4_1
    ("resblock_fused", 5, 256, 0, 256),  # down_5_*, mid_block*
    ("resblock_fused_split", 5, 256, 256, 256),  # up_5_*
    ("resblock_fused_split", 10, 256, 256, 256),  # up_4_0, up_4_1
    ("resblock_fused_split", 10, 256, 128, 256),  # up_4_2: a 12-channel group straddles channel 256
]
# Kernels 2-3 at the sites of the trained texture64 model with fused_block
# on (B=16; `texture64_agreement` runs it so): (kernel, H, Ca, Cb, Cout,
# calls per forward), counted on the meta device by `forward_calls`.
TEXTURE64_BLOCK_SHAPES = [
    ("resblock_fused", 8, 128, 0, 128, 2),
    ("resblock_fused", 4, 128, 0, 192, 1),  # NIN shortcut
    ("resblock_fused", 4, 192, 0, 192, 3),
    ("resblock_fused_split", 4, 192, 192, 192, 2),
    ("resblock_fused_split", 4, 192, 128, 192, 1),  # a 10-channel group straddles channel 192
    ("resblock_fused_split", 8, 192, 128, 128, 1),
    ("resblock_fused_split", 8, 128, 128, 128, 2),
]
# FIR calls of one NCSN++ forward, B=8: (kernel, H, C, calls).  Down: each
# BigGAN down block resamples h and x, the input pyramid its 6 channels;
# up: the same in the BigGAN up blocks and the output pyramid.
FIR_SHAPES = [
    ("fir_downsample2", 160, 64, 2), ("fir_downsample2", 80, 64, 2), ("fir_downsample2", 40, 128, 2),
    ("fir_downsample2", 20, 128, 2), ("fir_downsample2", 10, 256, 2),
    ("fir_downsample2", 160, 6, 1), ("fir_downsample2", 80, 6, 1), ("fir_downsample2", 40, 6, 1),
    ("fir_downsample2", 20, 6, 1), ("fir_downsample2", 10, 6, 1),
    ("fir_upsample2", 5, 256, 2), ("fir_upsample2", 10, 256, 2), ("fir_upsample2", 20, 128, 2),
    ("fir_upsample2", 40, 128, 2), ("fir_upsample2", 80, 64, 2),
    ("fir_upsample2", 5, 6, 1), ("fir_upsample2", 10, 6, 1), ("fir_upsample2", 20, 6, 1),
    ("fir_upsample2", 40, 6, 1), ("fir_upsample2", 80, 6, 1),
]
FIR_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ASYMMETRIC_FIR = (1.0, 2.0, 5.0, 0.5)  # a non-symmetric 4-tap kernel, checked at one shape each
# FIR calls the NCSN++ path does not make, checked all the same: (kernel, B,
# H, W, C, offset in bytes of the input's data from an aligned address).
# At 4 bytes the vector narrows (float32 to one element, bfloat16 to two);
# 3 channels; odd H and W (the upsample takes them).
FIR_EXTRA_CASES = [
    ("fir_upsample2", 8, 40, 40, 128, 4), ("fir_downsample2", 8, 80, 80, 64, 4),
    ("fir_upsample2", 8, 20, 20, 6, 4), ("fir_downsample2", 8, 20, 20, 6, 4),
    ("fir_upsample2", 8, 20, 20, 3, 0), ("fir_downsample2", 8, 20, 20, 3, 0),
    ("fir_upsample2", 8, 15, 13, 64, 0), ("fir_upsample2", 2, 7, 9, 6, 0), ("fir_upsample2", 3, 5, 7, 3, 0),
]
# Timing with the operands out of L2 (`rotated`): the H100's L2 holds 50 MB,
# and every FIR call of the path but the two 65 MB ones fits in it.
L2_SAFE_BYTES = 100e6
MAX_COPIES = 128  # more than the 113 calls of one `time_ms`
PER_FORWARD_NCSNPP_PATH = {"fir_upsample2": 15, "fir_downsample2": 15}
# The FIR launches of one NCSN++ forward that carries a gradient: only the
# raw input's pyramid (160 to 10, 6 channels) needs none, so only its 5
# downsamples launch a kernel; every other call takes its plain version.
NCSNPP_GRAD_FORWARD = {"fir_upsample2": 0, "fir_downsample2": 5}
STEPS = 20  # the bfloat16 block path and the NCSN++ path, cut from their 1000 to keep the run short
TAIL_PATH_STEPS = 10  # the float32 tail path, cut from 1000 likewise
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Kernels on against off, bfloat16 compute (see `agreement`).
BF16_AGREE_TOL = 2e-2

# The flagship train step at full width, B=16, float32 (the trainer path):
# kernel 4 carries every 3x3 stride-1 conv, (forward, dx) launches per step
# (tests/test_torch_conv3x3.py counts them again on the meta device): 89
# convs (conv_in, 2 per down and mid block, 3 per split up block, 5 upsample
# convs, conv_out), and their input gradients but conv_in's.  An eval
# forward (the EMA loss, B=8) leaves the 17 gated tails' conv1 to the fused
# tail.
TRAIN_BATCH = 16
CONV_PER_TRAIN_STEP = (89, 88)
CONV_PER_EVAL_FORWARD = 72
TRAIN_STEPS = 10  # Trainer.fit on the new path
TRAIN_OFF_STEPS = 3  # the same with the policy off
TRAIN_AGREE_STEPS = 3
EVAL_BATCHES = 4  # the recipe's eval.max_val_batches
# Kernel 4 on against off in the train step: loss 1e-5, each gradient by
# norm 1e-4, each tensor's 3-step update of params and EMA by norm 2e-3, as
# tests/test_torch_train.py holds the port against JAX.  The CPU test also
# holds each element at 1e-6 of its tensor's scale outside the small
# gradients; at full width Adam's per-element amplification of rounding
# (updates ~lr*sign(g) at first, then the ratio of an element's gradients)
# broke that even with 40% of the elements excluded (1.2e-5, NVIDIA H100
# 80GB HBM3, 700.00 W), so here the element numbers are printed, not gated.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_UPDATE_TOL, TRAIN_PARAM_TOL = 1e-5, 1e-4, 2e-3, 1e-6
SMALL_GRAD, NOISE_LEVEL = 1e-2, 1e-6
HMAJOR_SHAPES = [(20, 192, 192), (5, 288, 288)]  # (H, Cin, Cout) of the (H, W, B, C) entry
ROTATION_SHAPES = [(40, 96, 192), (10, 288, 192)]  # the autograd dx against F.conv2d's

# The fused bias + leaky ReLU (kernel 8), which no path calls: (shape, with
# bias, negative_slope, scale); float32 within 1e-6 of the largest
# magnitude, bfloat16 within two bfloat16 steps of each element.
FUSED_ACT_SHAPES = [
    ((16, 64, 64, 64), True, 0.2, 2**0.5),
    ((8, 160, 160, 96), True, 0.2, 2**0.5),
    ((3, 5, 7, 6), False, 0.2, 2**0.5),
    ((3, 5, 7, 6), True, 0.1, 1.0),
]
FUSED_ACT_F32_TOL, FUSED_ACT_BF16_STEPS = 1e-6, 2

# The --mode test harness on the trained texture64 checkpoint: test batch 0
# of 16, draws 2, 3, 4, 1000 steps, float32, the fused tail on.  The JAX
# harness's batch-0 means on the same checkpoint and batch
# (artifacts/texture64_run/.../test_metrics/0_4.pkl, copied here because
# artifacts/ is not sent to the card), each with the band the port's means
# must fall in: PSNR and consistency in dB, SSIM absolute, diversity
# relative.
HARNESS_BATCH, HARNESS_STEPS, HARNESS_DRAWS = 16, 1000, [2, 3, 4]
HARNESS_JAX = {"psnr": 35.634047190348305, "ssim": 0.874427596728007, "consistency": 53.10198720296224,
               "diversity": 4.192732334136963}
HARNESS_BAND = {"psnr": 0.5, "ssim": 0.015, "consistency": 1.5, "diversity": 0.2 * 4.192732334136963}
# The pipeline's PSNR from the 8-bit PNG tree against the harness's from the
# float samples, in dB.  Rounding to 8 bits adds 1/12 level^2 (a uniform
# error's variance) to each image's MSE, which lowers a 48 dB image's PSNR by
# ~0.2 dB and batch 0's mean by ~0.12 (NVIDIA H100 80GB HBM3, 700.00 W); so
# the check removes that term from each image's MSE read back from the PNGs
# and holds the result at 0.1 dB, and prints the raw difference beside it.
PIPELINE_PSNR_TOL = 0.1
QUANTIZATION_MSE = 1.0 / 12.0  # level^2
TEXTURE64_AGREE_TOL = 1e-4

# The paper's four other estimators on the texture160 flagship recipes:
# their bfloat16 samplers with fused_block and fused_tail (the flagship's
# kernel calls per forward, `PER_FORWARD_BLOCK_PATH`), cut to 20 of 1000
# steps; CDE and VS-CMDE also with the kernels on against off; Trainer.fit
# for 5 steps with kernel 4.  Then the unconditional VE NCSN++ (FIR kernels)
# and DDPM++ under VP and sub-VP (no kernel), each at its recipe's full width.
ESTIMATORS = [
    ("ours_DV", texture160_sr_vscmde_config),
    ("ours_slowDV", texture160_sr_vscmde_slow_config),
    ("song", texture160_sr_cdiffe_config),
    ("sr3", texture160_sr_cde_config),
]
ESTIMATOR_AGREEMENT = ("sr3", "ours_DV")
ESTIMATOR_STEPS, ESTIMATOR_TRAIN_STEPS = 10, 3
WARMUP_STEPS = 2  # an untimed sample before each estimator's and VP's timed one
UNCOND_BATCH, UNCOND_STEPS, UNCOND_SHORT, UNCOND_EVOLUTION, UNCOND_TRAIN_STEPS = 8, 10, 3, 5, 3
VP_BATCH, VP_STEPS, VP_SHORT = 64, 10, 3
FIR_AGREE_TOL = 1e-4
EVOLUTION_TOL = 1e-6  # the same kernels on the same inputs: only a library's choice of algorithm may differ
# FIR calls of one unconditional NCSN++ forward (128px, B=8; BigGAN down at
# 128/64/32, up at 16/32/64, h and x each), none at the DF2K path's shapes.
PER_FORWARD_UNCOND_PATH = {"fir_upsample2": 6, "fir_downsample2": 6}

# The multi-scale chains (``--mode multi_scale_test``), B=8, float32.  The
# trained texture64 Haar pyramid at the JAX chain's 2000 steps per scale,
# kernels off as in JAX; its batch-0 PSNR and SSIM must fall in the band
# set from the JAX chain's own spread on the same checkpoints and batch (3
# draws, seeds 42-44, on a CPU: `PYRAMID_JAX`): their range widened by half
# its width on each side, at least PSNR +-0.5 dB and SSIM +-0.015 around
# their mean.  Its zero-detail control is pure math: JAX's at 1e-4.
PYRAMID_STEPS, PYRAMID_SHORT = 2000, 3
PYRAMID_JAX = {"psnr": [25.26880645751953, 24.430906295776367, 24.8092098236084],
               "ssim": [0.3762507140636444, 0.31682971119880676, 0.3698098659515381],
               "dc_only_psnr": 35.33884048461914, "dc_only_ssim": 0.8255559802055359}
PYRAMID_BAND = {"psnr": (24.011956214904785, 25.687756538391113), "ssim": (0.28711920976638794, 0.40596121549606323)}
DC_ONLY_TOL = 1e-4
# The celebA-HQ-160 sequential chains on texture160 (random weights): the
# Haar chain timed over `CHAIN_STEPS` per scale, the bicubic chain
# (ddpm_2xSR) over `BICUBIC_STEPS`; kernels on against off over
# `PYRAMID_SHORT` steps per scale (final images, 1e-4 of their largest
# magnitude); the direct 8x ddpm_KxSR sampler over `DIRECT8X_STEPS`.
CHAIN_STEPS, BICUBIC_STEPS, DIRECT8X_STEPS = 10, 3, 5
CHAIN_AGREE_TOL = 1e-4
# Kernels 1-3 calls per forward of each scale of the chains' _block variants
# (counted on the meta device by `forward_calls`): the pyramid's (both
# scales: tails at 16x16x48, blocks at 8x8) and the sequential chains' (each
# of 40, 80, 160, Haar and bicubic alike).  The direct 8x sampler makes the
# flagship's calls (`flagship_block_path_calls`).
PYRAMID_PER_FORWARD = {"gn_silu_conv3x3": 5, "resblock_fused": 4, "resblock_fused_split": 3}
SEQUENTIAL_PER_FORWARD = {"gn_silu_conv3x3": 5, "resblock_fused": 6, "resblock_fused_split": 6}
# Their sites, B=8, none of them a site of an earlier path: the tails (H, C)
# and the blocks (kernel, H, Ca, Cb, Cout), each with the DDPM's GroupNorm
# groups (`legacy_num_groups`: 16 groups of 3 at C = 48 and of 9 at 144,
# else 32 groups of C / 32: 3 to 12 channels a group).  The resblocks' conv1
# is Cout -> Cout; the 12-channel conv_out is no kernel's (in JAX neither).
CHAIN_TAIL_SHAPES = [(16, 48), (20, 96), (20, 128)]
CHAIN_BLOCK_SHAPES = [
    ("resblock_fused", 8, 48, 0, 96),  # pyramid: NIN shortcut, 16 groups of 3 in
    ("resblock_fused", 8, 96, 0, 96),
    ("resblock_fused_split", 8, 96, 48, 96),  # 144 in: 16 groups of 9, one straddling channel 96
    ("resblock_fused_split", 8, 96, 96, 96),
    ("resblock_fused", 10, 96, 0, 96),  # scale 40
    ("resblock_fused", 5, 96, 0, 192),
    ("resblock_fused", 5, 192, 0, 192),
    ("resblock_fused_split", 5, 192, 96, 192),
    ("resblock_fused_split", 5, 192, 192, 192),
    ("resblock_fused_split", 10, 96, 96, 96),
    ("resblock_fused_split", 10, 192, 96, 96),
    ("resblock_fused", 10, 96, 0, 192),  # scale 80
    ("resblock_fused", 10, 192, 0, 192),
    ("resblock_fused_split", 10, 192, 96, 192),
    ("resblock_fused_split", 10, 192, 192, 192),
    ("resblock_fused", 10, 128, 0, 128),  # scale 160
    ("resblock_fused", 5, 128, 0, 256),
    ("resblock_fused", 5, 256, 0, 256),
    ("resblock_fused_split", 5, 256, 128, 256),
    ("resblock_fused_split", 5, 256, 256, 256),
    ("resblock_fused_split", 10, 128, 128, 128),
    ("resblock_fused_split", 10, 256, 128, 128),  # 384 in: 12-channel groups
]

# The GaussianBubbles toy trained by the CLI (phase 16): its 4,000-sample
# metrics (`eval/toy.py`, `scripts/head_to_head.py:sample_metrics`) must lie
# in the band set from the JAX run's spread over three seeds
# (`tests/_torch_port_toy_band.py`, seeds 0-2, 10,000 steps each, on a CPU):
# the range widened by half its width on each side, never narrower than
# ground truth against itself (0.0125 / 0.00219), nor below 0.
TOY_JAX = {"mode_mass_maxdev": [0.006249999999999978, 0.006500000000000006, 0.024249999999999994],
           "energy_distance_vs_gt": [0.001677393913269043, 0.00353848934173584, 0.00428318977355957]}
TOY_BAND = {"mode_mass_maxdev": (0.0, 0.03325), "energy_distance_vs_gt": (0.0003744959831237793, 0.005586087703704834)}
# The full-length paired callback on the texture64 EMA (phase 17): the PSNR
# of its 8 samples against their ground truth, in the band set from the
# JAX callback on the same checkpoint and images over three keys
# (`tests/_torch_port_paired_band.py`, steps 1-3, on a CPU): the range
# widened by half its width on each side, at least the harness's +-0.5 dB
# around the mean (38.46665).
PAIRED_IMAGES = 8
PAIRED_JAX = [38.542591932595236, 38.441330877546804, 38.41601926013445]
PAIRED_BAND = (37.966647356758834, 38.966647356758834)
# The NCSN++ DF2K direct 4x trainer (phase 18).
NCSNPP_TRAIN_STEPS = 12
PROFILE_STEPS = 3  # CSDT_PROFILE_STEPS: the trace covers steps 3-5 (10 steps wrote 229 MiB)
KXSR_VIZ_STEPS = 10  # the KxSR callback's training.visualization_p_steps
KXSR_GRID_TOL = 1e-4  # the callback's grid, FIR kernels against the plain FIR

# The other samplers (phases 19-21), float32, seeded N(0, 0.02) weights.
# Phase 19: the probability-flow ODE, first JAX's analytic test
# (`tests/test_sampling.py:201-206`: VE sigma 0.01-10, N = 200, 2048 x 1
# samples of N(1.5, 0.5^2), eps 1e-4), each sample against the exact flow
# of its prior draw at 1e-4 and the mean and std within 0.08 of where the
# flow takes the zero-mean prior (JAX's target mean sits 0.075 above it, so
# its gate fails for a third of the prior draws: seed 0 on the card gave
# 1.41187); then the
# unconditional NCSN++ through `get_sampling_fn` (B = 8, 128px), each FIR
# kernel at its calls per forward x the score evaluations; the same prior
# with the plain FIR: where the step counts agree the samples at 1e-4 of
# their scale, else by norm at 1e-3.
ODE_ANALYTIC_SHAPE, ODE_ANALYTIC_TOL = (2048, 1), 0.08
ODE_AGREE_TOL, ODE_NORM_TOL = 1e-4, 1e-3
# Phase 20: bits/dim.  JAX's analytic N(0, 1) test (within 0.1 of
# log2(sqrt(2 pi e)) + 8); `evaluate_bpd` on the texture160 test split at
# 128px cut to one batch (`BPD_MAX_BATCHES`, of JAX's 8) of one image
# (`BPD_BATCH`, of the recipe's eval batch), every FIR call on its plain
# version (all carry a gradient); the reverse-mode divergence against
# `torch.func.jvp` at one (x, t), 1e-4 relative; kernels 1-3 off under a
# gradient on the Haar DDPM (B = 1), the divergence equal to the one with
# the knobs off at 1e-5.
BPD_BATCH, BPD_MAX_BATCHES = 1, 1
DIV_JVP_TOL, DIV_KNOBS_TOL = 1e-4, 1e-5
# Phase 21: inpainting and colorization, every SDE cut from 1000 steps to
# `PROJECTED_STEPS`: the NCSN++ on texture160 test batch 0 (B = 8) with a
# random square mask of coverage 0.25 (JAX `configs/inverse_problems.py:92`),
# the colorizer on its grayscale; `inpaint_hf` on the texture64 Haar DDPM's
# DC band (test batch 0, B = 8) with fused_block and fused_tail, kernels on
# against off over `PYRAMID_SHORT` steps first.  The colorizer's gray
# channel is held at `GRAY_TOL` of the output's largest magnitude: the
# round trip through the orthonormal basis rounds relative to the whole
# pixel, and the random network's chroma reaches ~1e3.
PROJECTED_STEPS, MASK_COVERAGE = 10, 0.25
KNOWN_TOL, GRAY_TOL, DC_TOL = 1e-6, 1e-4, 1e-5

# Phase 22: the paper's other inverse problems on their texture twins
# (`configs/inverse_problems.py`), each at its recipe's full width.  Kernels
# 1-3 per forward of each ``_block`` twin at B=8 (`forward_calls` on the
# meta device; tests/test_torch_inverse_recipes.py counts them again): with
# the block kernels on, the tail keeps the blocks at 16x16 (12x12) and the
# whole-block kernels take the levels at 10x10 and below.  Inpainting and
# colorization share the 128px U-Net (nf 96, ch_mult (1,1,2,2,3,3)); the
# image-to-image U-Net is 64px (nf 128, ch_mult (1,1,2,2)); the MRI->PET
# slices' is 96px of one channel (nf 96), down to 3x3.  The 3-D twin's
# volumes reach no kernel.
SITES_128 = {
    ("gn_silu_conv3x3", 16, 192): 5,
    ("resblock_fused", 8, 192, 0, 288): 1,  # NIN shortcut
    ("resblock_fused", 8, 288, 0, 288): 1,
    ("resblock_fused", 4, 288, 0, 288): 4,
    ("resblock_fused_split", 4, 288, 288, 288): 3,
    ("resblock_fused_split", 8, 288, 288, 288): 2,
    ("resblock_fused_split", 8, 288, 192, 288): 1,  # a 15-channel group straddles channel 288
}
SITES_I2I = {
    ("gn_silu_conv3x3", 16, 256): 5,
    ("resblock_fused", 8, 256, 0, 256): 4,
    ("resblock_fused_split", 8, 256, 256, 256): 3,
}
SITES_MRI = {
    ("gn_silu_conv3x3", 12, 192): 5,
    ("resblock_fused", 6, 192, 0, 288): 1,
    ("resblock_fused", 6, 288, 0, 288): 1,
    ("resblock_fused", 3, 288, 0, 288): 4,
    ("resblock_fused_split", 3, 288, 288, 288): 3,
    ("resblock_fused_split", 6, 288, 288, 288): 2,
    ("resblock_fused_split", 6, 288, 192, 288): 1,
}
# (label, recipe, whether its data is a tree the phase writes, sites)
INVERSE_TWINS = [
    ("inpainting", texture160_inpainting_cmde_block_config, False, SITES_128),
    ("colorization", texture160_colorization_cmde_block_config, False, SITES_128),
    ("image-to-image", texture64_i2i_cmde_block_config, True, SITES_I2I),
    ("MRI->PET slices", texture_mri_to_pet_slices_block_config, True, SITES_MRI),
]
INVERSE_STEPS, INVERSE_TRAIN_STEPS = 20, 3  # each sampler cut from 1000 steps
INVERSE_HARNESS_STEPS = 10  # the inpainting harness's, cut from 20 in PR 18 to make room for phases 24-25
INVERSE_HARNESS_DRAWS, PAIRED3D_STEPS, STATS_BATCHES, STATS_TOL = [1, 2], 100, 200, 1e-5

# Phase 23: the score_sde baselines on their texture twins (configs/score_sde.py):
# (label, recipe, Trainer.fit steps at the recipe's train batch).
SCORE_SDE_TWINS = [
    ("NCSNv2 64px (ve/ncsnv2/celeba)", texture64_ncsnv2_celeba_config, 3),
    ("NCSNv2 128px (ve/ncsnv2/bedroom)", texture128_ncsnv2_bedroom_config, 2),
    ("NCSN 32px (ve/ncsn/cifar10_124)", texture32_ncsn_cifar10_124_config, 3),
    ("NCSN++ SMLD 32px (ve/cifar10_ncsnpp)", texture32_ncsnpp_cifar10_smld_config, 3),
    ("DDPM 32px (vp/ddpm/cifar10)", texture32_ddpm_cifar10_vp_config, 3),
]
# FIR calls of one forward of the discrete-VE NCSN++ twin (32px, B=8): the
# BigGAN down blocks at 32/16/8 and up blocks at 4/8/16, h and x each; its
# residual input pyramid resamples through the fused FIR conv (plain).
# The other twins call no kernel.
SCORE_SDE_FIR_PER_FORWARD = {"fir_upsample2": 6, "fir_downsample2": 6}
SCORE_SDE_EVALS, SCORE_SDE_BATCH, SCORE_SDE_SHORT, SCORE_SDE_CLI_STEPS = 20, 8, 3, 2
SCORE_SDE_CLI_RECIPE = "configs/ve/ncsnv2/celeba.py"

# Phase 24: the celebA multi-scale recipes (`configs/srflow.py`: Haar space
# and bicubic) and the Haar-flow trainer (`configs/extra.py`) at full width,
# on the texture160 images written as celebA.  Kernels 1-3 calls per forward
# of each recipe's _block variant at B=8 (meta device; the CPU tests count
# them again), and the sites among them no earlier phase checked: the
# Haar-flow U-Net's 8x8 to 2x2 levels at up to 384 channels, celebA's
# 10x10 / 5x5 blocks at 256 and 384.
MULTISCALE_RECIPES = [
    ("celebA haar 40", lambda: celeba_haar_config(40)),
    ("celebA haar 80", lambda: celeba_haar_config(80)),
    ("celebA haar 160", lambda: celeba_haar_config(160)),
    ("celebA bicubic 40", lambda: celeba_bicubic_config(40)),
    ("celebA bicubic 80", lambda: celeba_bicubic_config(80)),
    ("celebA bicubic 160", lambda: celeba_bicubic_config(160)),
    ("haarflow 128", lambda: haarflow_config(128)),
]
_SCALE_40 = {"gn_silu_conv3x3": 5, "resblock_fused": 6, "resblock_fused_split": 6}
MULTISCALE_PER_FORWARD = {
    "celebA haar 40": _SCALE_40, "celebA haar 80": _SCALE_40,
    "celebA haar 160": {"gn_silu_conv3x3": 7, "resblock_fused": 5, "resblock_fused_split": 4},
    "celebA bicubic 40": _SCALE_40, "celebA bicubic 80": _SCALE_40, "celebA bicubic 160": _SCALE_40,
    "haarflow 128": {"gn_silu_conv3x3": 5, "resblock_fused": 8, "resblock_fused_split": 9},
}
MULTISCALE_NEW_SITES = [
    ("gn_silu_conv3x3", 16, 256),
    ("resblock_fused", 2, 384, 0, 384), ("resblock_fused", 4, 256, 0, 384), ("resblock_fused", 4, 384, 0, 384),
    ("resblock_fused", 5, 256, 0, 384), ("resblock_fused", 5, 384, 0, 384), ("resblock_fused", 10, 128, 0, 256),
    ("resblock_fused", 10, 256, 0, 256),
    ("resblock_fused_split", 2, 384, 384, 384), ("resblock_fused_split", 4, 384, 256, 384),
    ("resblock_fused_split", 4, 384, 384, 384), ("resblock_fused_split", 5, 384, 256, 384),
    ("resblock_fused_split", 5, 384, 384, 384), ("resblock_fused_split", 8, 384, 256, 256),
    ("resblock_fused_split", 10, 256, 128, 256), ("resblock_fused_split", 10, 256, 256, 256),
    ("resblock_fused_split", 10, 384, 256, 256),
]
MULTISCALE_CLI_RECIPE = "configs/ve/srflow/celebA/haar/config_40.py"
MULTISCALE_MASTERS = [  # (label, recipe file, the coordinate space its chain needs)
    ("celebA haar", "configs/ve/srflow/celebA/haar/master_config.py", "haar"),
    ("celebA bicubic", "configs/ve/srflow/celebA/bicubic/reduce_max_only/master_config.py", "bicubic"),
]
MULTISCALE_TRAIN_STEPS, HAARFLOW_IMAGES, CELEBA_JPEG_QUALITY = 2, 256, 95
# Phase 25: the perceptual metrics on seeded synthetic weights written as the
# reference files (pytorch-fid's InceptionV3, torchvision's AlexNet
# features, lpips' heads): the card (float32, TF32 off) against the same
# modules on the CPU in float64 on the first 8 texture160 test images.
PERCEPTUAL_IMAGES, PERCEPTUAL_TOL, FID_TOL = 8, 1e-4, 1e-3

WRAPPERS = {
    "gn_silu_conv3x3": fused_tail.gn_silu_conv3x3,
    "resblock_fused": fused_block.resblock_fused,
    "resblock_fused_split": fused_block.resblock_fused_split,
    "fir_upsample2": fir.fir_upsample2,
    "fir_downsample2": fir.fir_downsample2,
    "conv3x3": conv3x3.conv3x3,
    "conv3x3_hmajor": conv3x3.conv3x3_hmajor,
    "fused_leaky_relu": fused_act.fused_leaky_relu_kernel,
}


START = time.perf_counter()
CHILD_TIMEOUT_S = 900  # a child's phases take ~250 s; one that hangs fails the run instead of stalling it


def phase(name, t0, msg=""):
    print(f"[{name}] {time.perf_counter() - t0:.3f} s {msg}".rstrip(), flush=True)
    # the run's progress on stderr, so a run cut at its time limit shows where it was
    print(f"chip_smoke pid {os.getpid()} at {time.perf_counter() - START:.1f} s: [{name}] {msg[:100]}",
          file=sys.stderr, flush=True)


class Child:
    """Phases run in order in a child process of this script (``chip_smoke.py
    --child <dir>``) while this process goes on with others.

    The quality-gated phases are host-bound (the device busy ~0.13 of their
    time), so they share the card with this process at little cost to
    each.  ``calls`` is [(function name, args), ...]; the child loads the
    kernels this process built, runs the calls with their own launch
    counters and gates, and pickles their results.  `join` prints the
    child's output and returns the results, or raises if the child failed;
    `stop` kills it if it still runs."""

    def __init__(self, label, calls):
        self.label = label
        self.directory = tempfile.mkdtemp(prefix="chip_smoke_child_")
        with open(os.path.join(self.directory, "calls.pkl"), "wb") as f:
            pickle.dump(calls, f)
        self.log = open(os.path.join(self.directory, "stdout.log"), "w")
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", self.directory],
                                     stdout=self.log, cwd=REPO)
        print(f"[child] {self.label}: pid {self.proc.pid}, {[name for name, _ in calls]}", flush=True)

    def join(self):
        try:
            rc = self.proc.wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        self.stop()
        with open(os.path.join(self.directory, "stdout.log")) as f:
            sys.stdout.write(f.read())
        if rc != 0:
            raise RuntimeError(f"{self.label}: the child process exited with {rc} (None: killed after"
                               f" {CHILD_TIMEOUT_S} s)")
        with open(os.path.join(self.directory, "results.pkl"), "rb") as f:
            results = pickle.load(f)
        shutil.rmtree(self.directory, ignore_errors=True)
        return results

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def child_main(directory):
    """The child's side of `Child`: exits by itself if its parent dies."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(2)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for load in (fused_tail.load_library, fused_block.load_library, fir.load_library, conv3x3.load_library,
                 fused_act.load_library):
        if load().build_seconds:
            raise RuntimeError("a child built a kernel: the parent builds them all before it starts children")
    with open(os.path.join(directory, "calls.pkl"), "rb") as f:
        calls = pickle.load(f)
    results = [globals()[name](*args) for name, args in calls]
    with open(os.path.join(directory, "results.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


def time_ms(fn, iters=100, warmup=10):
    """Mean device time of one call, by CUDA events around ``iters`` calls.

    The calls are enqueued behind a `torch.cuda._sleep` that lasts longer
    than their enqueue (measured on 3 calls, x2, + 0.2 ms), so the start
    event fires when the queue is full and the events time the device's
    back-to-back work, not the host's ~25-40 us of Python per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        fn()
    enqueue_s = (time.perf_counter() - t) / 3 * iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * enqueue_s + 2e-4) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ratio(row):
    """Record and format the kernel's time over the library call's."""
    row["library_ratio"] = row["ms"] / row["library_ms"]
    return f", kernel / library {row['library_ratio']:.2f}"


def dname(dtype):
    return str(dtype).replace("torch.", "")


def itemsize(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def bound(flops, nbytes, dtype):
    """Least time in ms: operations over the type's peak rate, or bytes over
    the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(label, got, want, dtype, tol=REL_TOL):
    """Raise unless ``got`` is ``want`` within ``tol[dtype]`` of the largest
    magnitude of ``want``; returns the largest difference."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != dtype:
        raise RuntimeError(f"{label}: kernel output {got.shape} {got.dtype}, want {want.shape} {dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = err <= tol[dtype] * scale
    print(
        f"  {label}: max_abs_err {err:.3e} rel {err / scale:.3e} tol rel {tol[dtype]:.0e}"
        f" {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise RuntimeError(f"{label}: kernel disagrees with its plain version")
    return err


# ---- the fused tail -------------------------------------------------------


def tail_inputs(h, c, dtype, seed, batch=BATCH):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(batch, h, h, c, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
    w = (torch.randn(c, c, 3, 3, generator=g, device="cuda") / (9 * c) ** 0.5).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
    beta = 0.1 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    temb = torch.randn(batch, c, generator=g, device="cuda")
    return x, w, gamma, beta, bias, temb


def tail_work(h, c, dtype, batch=BATCH):
    """Operations and bytes of one tail call: x and w read once, out
    written once, the float32 vectors read once."""
    return 2 * 9 * batch * h * h * c * c, itemsize(dtype) * (2 * batch * h * h * c + 9 * c * c) + 4 * 3 * c


def check_tail():
    """The tail kernel against plain at its shapes; returns per-shape rows."""
    rows = []
    for h, c, calls_tail_path, calls_block_path in TAIL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (False, True):
                x, w, gamma, beta, bias, temb = tail_inputs(h, c, dtype, seed=h * c)
                temb = temb if with_temb else None
                got = fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias, temb=temb)
                want = fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias, temb=temb)
                err = check_close(f"tail {h}x{h}x{c} {dname(dtype)} temb={with_temb}", got, want, dtype)
                if with_temb:
                    continue
                flops, nbytes = tail_work(h, c, dtype)
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                row = dict(
                    shape=f"{BATCH}x{h}x{h}x{c}", dtype=dname(dtype),
                    calls_per_forward_tail_path=calls_tail_path,
                    calls_per_forward_block_path=calls_block_path,
                    max_abs_err=err, gflop=flops / 1e9, bound_ms=bound_ms, bound_by=bound_by,
                    ms=time_ms(lambda: fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias)),
                    plain_ms=time_ms(lambda: fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias)),
                    # no single PyTorch call computes GN+SiLU+conv: cuDNN's conv alone
                    library_ms=time_ms(lambda: conv3x3_nhwc(x, w, bias.to(dtype))),
                )
                print(
                    f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                    f" cuDNN conv only {row['library_ms']:.4f} ms{ratio(row)},"
                    f" bound {bound_ms:.4f} ms ({bound_by}), {flops / row['ms'] / 1e9:.2f} TFLOP/s",
                    flush=True,
                )
                rows.append(row)
    return rows


# ---- the whole-resblock kernels ------------------------------------------


def block_inputs(h, ca, cb, cout, dtype, seed, with_temb=True, batch=BATCH):
    """Seeded inputs of one block call, as the model hands them over."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    cin = ca + cb
    x = (r(batch, h, h, ca) * 1.5 + 0.3).to(dtype)
    skip = (r(batch, h, h, cb) - 0.5).to(dtype) if cb else None
    kw = dict(
        gamma0=1.0 + 0.1 * r(cin), beta0=0.1 * r(cin), num_groups0=GROUPS,
        w0=(r(cout, cin, 3, 3) / math.sqrt(9 * cin)).to(dtype), b0=0.1 * r(cout),
        temb_proj=r(batch, cout) if with_temb else None,
        gamma1=1.0 + 0.1 * r(cout), beta1=0.1 * r(cout), num_groups1=GROUPS,
        w1=(r(cout, cout, 3, 3) / math.sqrt(9 * cout)).to(dtype), b1=0.1 * r(cout),
        shortcut_w=(r(cin, cout) / math.sqrt(cin)).to(dtype) if cin != cout else None,
        shortcut_b=0.1 * r(cout) if cin != cout else None,
    )
    return x, skip, kw


def block_call(x, skip, kw, plain=False):
    if skip is None:
        fn = fused_block.resblock_fused_plain if plain else fused_block.resblock_fused
        return fn(x, **kw)
    fn = fused_block.resblock_fused_split_plain if plain else fused_block.resblock_fused_split
    return fn(x, skip, **kw)


def block_work(h, ca, cb, cout, dtype):
    """Operations and bytes of one call: two 3x3 convs and, with a NIN
    shortcut, its product; x (and skip), the weights and the float32
    vectors and temb read once, out written once."""
    cin, px = ca + cb, BATCH * h * h
    mix = cin != cout
    flops = 2 * 9 * px * (cin + cout) * cout + (2 * px * cin * cout if mix else 0)
    nbytes = itemsize(dtype) * (px * cin + 9 * cout * (cin + cout) + (cin * cout if mix else 0) + px * cout)
    nbytes += 4 * (2 * cin + 4 * cout + BATCH * cout + (cout if mix else 0))
    return flops, nbytes


def check_blocks():
    """The block and split kernels against plain at their six sites; returns
    per-shape rows."""
    rows = []
    for i, (name, h, ca, cb, cout, calls) in enumerate(BLOCK_SHAPES):
        label = f"{name} {h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}"
        for dtype in (torch.float32, torch.bfloat16):
            variants = [(True, False), (False, False)] + ([(True, True)] if i == 0 else [])
            for with_temb, rescale in variants:
                x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb), with_temb=with_temb)
                kw["skip_rescale"] = rescale
                err = check_close(
                    f"{label} {dname(dtype)} temb={with_temb} skip_rescale={rescale}",
                    block_call(x, skip, kw), block_call(x, skip, kw, plain=True), dtype,
                )
                if not (with_temb and not rescale):
                    continue
                flops, nbytes = block_work(h, ca, cb, cout, dtype)
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                xin = x if skip is None else torch.cat([x, skip], dim=-1)
                ws = kw["shortcut_w"]

                def library():  # no single PyTorch call computes the block
                    conv3x3_nhwc(conv3x3_nhwc(xin, kw["w0"]), kw["w1"])
                    if ws is not None:
                        torch.matmul(xin, ws)

                row = dict(
                    kernel=name, shape=f"{BATCH}x{h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}",
                    dtype=dname(dtype), calls_per_forward=calls, max_abs_err=err, gflop=flops / 1e9,
                    bound_ms=bound_ms, bound_by=bound_by,
                    ms=time_ms(lambda: block_call(x, skip, kw)),
                    plain_ms=time_ms(lambda: block_call(x, skip, kw, plain=True)),
                    library_ms=time_ms(library),
                )
                print(
                    f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                    f" cuDNN convs + matmul {row['library_ms']:.4f} ms{ratio(row)},"
                    f" bound {bound_ms:.4f} ms ({bound_by}), {flops / row['ms'] / 1e9:.2f} TFLOP/s",
                    flush=True,
                )
                rows.append(row)
    return rows


def forward_calls(config, batch, inputs=None):
    """Counter of the kernel wrappers' calls in one eval forward of
    ``config``'s model on the meta device, by (kernel, *shape): the fused
    tail by (H, Cout), the whole-block kernels by (H, Ca, Cb, Cout), the FIR
    kernels by their input's (H, W, C).  ``inputs``: the model's input on the
    meta device (default square at the recipe's image size: {"x", "y"} for a
    conditional model, one tensor for an unconditional one)."""
    calls = collections.Counter()

    def record(name, key, out_shape):
        def fn(x, *args, **kwargs):
            calls[(name, *key(x, args, kwargs))] += 1
            return torch.empty(out_shape(x, args, kwargs), device=x.device, dtype=x.dtype)

        return fn

    cout = lambda x, a, k: (*x.shape[:-1], k["w0"].shape[0])  # noqa: E731
    patches = [
        (layers, "gn_silu_conv3x3", lambda x, a, k: (x.shape[1], a[0].shape[0]),
         lambda x, a, k: (*x.shape[:-1], a[0].shape[0])),
        (layers, "resblock_fused", lambda x, a, k: (x.shape[1], x.shape[-1], 0, k["w0"].shape[0]), cout),
        (layers, "resblock_fused_split", lambda x, a, k: (x.shape[1], x.shape[-1], a[0].shape[-1], k["w0"].shape[0]),
         cout),
        (fir, "fir_upsample2", lambda x, a, k: tuple(x.shape[1:]),
         lambda x, a, k: (x.shape[0], 2 * x.shape[1], 2 * x.shape[2], x.shape[3])),
        (fir, "fir_downsample2", lambda x, a, k: tuple(x.shape[1:]),
         lambda x, a, k: (x.shape[0], x.shape[1] // 2, x.shape[2] // 2, x.shape[3])),
    ]
    real = [(mod, name, getattr(mod, name)) for mod, name, *_ in patches]
    for mod, name, key, out_shape in patches:
        setattr(mod, name, record(name, key, out_shape))
    try:
        model = create_model(config, "meta")
        if inputs is None:
            s = config.data.image_size
            x = torch.empty(batch, s, s, 3, device="meta")
            inputs = {"x": x, "y": x} if is_conditional_config(config) else x
        with torch.no_grad():
            model(inputs, torch.empty(batch, device="meta"))
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
    return calls


def per_name(calls):
    """A `forward_calls` counter summed by kernel."""
    out = collections.Counter()
    for (name, *_), n in calls.items():
        out[name] += n
    return dict(out)


def sites(calls, *names):
    """The entries of a `forward_calls` counter for ``names``; with one name,
    keyed by the shape alone."""
    picked = {k: n for k, n in calls.items() if k[0] in names}
    return {k[1:]: n for k, n in picked.items()} if len(names) == 1 else picked


def flagship_block_path_calls():
    """`forward_calls` of one forward of the bfloat16 block path, from the
    site tables the kernel phase checks: `BLOCK_SHAPES`, and the tails
    `TAIL_SHAPES` gives that path."""
    calls = collections.Counter({(name, *shape): n for name, *shape, n in BLOCK_SHAPES})
    calls.update({("gn_silu_conv3x3", h, c): n for h, c, _, n in TAIL_SHAPES if n})
    return calls


def check_texture64_blocks():
    """The block and split kernels against plain at the trained texture64
    model's sites (B=16; a NIN shortcut, and a 10-channel group straddling
    the concat at 4x4 192+128), float32 and bfloat16, with and without
    temb; checked, not timed: no main path runs them."""
    for name, h, ca, cb, cout, _ in TEXTURE64_BLOCK_SHAPES:
        label = f"texture64 {name} {HARNESS_BATCH}x{h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}"
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (True, False):
                x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb) + 2, with_temb=with_temb,
                                           batch=HARNESS_BATCH)
                check_close(f"{label} {dname(dtype)} temb={with_temb}",
                            block_call(x, skip, kw), block_call(x, skip, kw, plain=True), dtype)


def check_ncsnpp_sites():
    """Kernels 1-3 against plain at the NCSN++ block variant's sites; the
    tail timed in float32 (that variant's type); returns the tail's rows."""
    rows = []
    for h, c in NCSNPP_TAIL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, gamma, beta, bias, _ = tail_inputs(h, c, dtype, seed=h * c + 1)
            err = check_close(
                f"NCSN++ tail {h}x{h}x{c} {dname(dtype)}",
                fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias),
                fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias), dtype,
            )
            if dtype != torch.float32:
                continue
            flops, nbytes = tail_work(h, c, dtype)
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            row = dict(
                shape=f"{BATCH}x{h}x{h}x{c}", dtype=dname(dtype), site="NCSN++ block variant", max_abs_err=err,
                gflop=flops / 1e9, bound_ms=bound_ms, bound_by=bound_by,
                ms=time_ms(lambda: fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias)),
                plain_ms=time_ms(lambda: fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias)),
                library_ms=time_ms(lambda: conv3x3_nhwc(x, w, bias)),
            )
            print(f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cuDNN conv only"
                  f" {row['library_ms']:.4f} ms{ratio(row)}, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
            rows.append(row)
    for name, h, ca, cb, cout in NCSNPP_BLOCK_SHAPES:
        label = f"NCSN++ {name} {h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}"
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (True, False):
                x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb) + 1, with_temb=with_temb)
                kw["skip_rescale"] = True
                check_close(
                    f"{label} {dname(dtype)} temb={with_temb} skip_rescale=True",
                    block_call(x, skip, kw), block_call(x, skip, kw, plain=True), dtype,
                )
    return rows


# ---- the FIR resampling kernels ---------------------------------------------


def fir_library(name, x):
    """The one PyTorch call that computes the same resampling with [1,3,3,1]:
    a depthwise 4x4 transposed conv (stride 2) for the upsample, a depthwise
    4x4 conv (stride 2, padding 1) for the downsample, on the NCHW view."""
    C = x.shape[-1]
    k = torch.from_numpy(setup_kernel(fir.FIR_KERNEL, 4.0 if name == "fir_upsample2" else 1.0))
    w = k.to(x.device, x.dtype)[None, None].repeat(C, 1, 1, 1)
    xc = x.permute(0, 3, 1, 2)
    if name == "fir_upsample2":
        out = F.conv_transpose2d(xc, w, stride=2, padding=1, groups=C)
    else:
        out = F.conv2d(xc, w, stride=2, padding=1, groups=C)
    return out.permute(0, 2, 3, 1)


def rotated(fn, x, nbytes):
    """``fn`` on ceil(100 MB / ``nbytes``) copies of ``x`` (at most
    `MAX_COPIES`) in turn, each output kept until its copy's next turn.
    Every copy has one turn first (so the allocator holds every output's
    memory before a timing: a device allocation inside one stalls it), then
    the L2 is flushed.  A timed call then finds its input and output out of
    L2: 100 MB of other calls' traffic has passed since the copy's last
    turn, or (calls under 0.8 MB, whose 128 copies hold less) the copy has
    had no turn since the flush (`time_ms` makes 113 calls)."""
    n = min(MAX_COPIES, math.ceil(L2_SAFE_BYTES / nbytes))
    xs = [x.clone() for _ in range(n)]
    outs = [fn(t) for t in xs]
    torch.empty(int(L2_SAFE_BYTES) // 4, device=x.device).zero_()  # evicts the copies from L2
    turn = itertools.count()

    def call():
        i = next(turn) % n
        outs[i] = fn(xs[i])

    return call


def check_fir(yardsticks=True, shapes=FIR_SHAPES):
    """Both FIR kernels against plain at the 20 shapes of one NCSN++
    forward (or ``shapes``: (kernel, H, C, calls per forward)), float32
    (1e-5 of the largest magnitude) and bfloat16 (2e-2),
    and with a non-symmetric kernel at two shapes; returns per-shape rows
    with times (CUDA events over 100 calls): ``ms`` with the operands out of
    L2 (`rotated`), beside the plain version, the library call (both
    rotated too) and the bound; ``l2_ms`` one input and output address
    over and over (L2-resident up to 50 MB).  Without
    ``yardsticks`` the plain version and the library call are not timed."""
    rows = []
    for name, h, c, calls in shapes:
        kernel, plain = WRAPPERS[name], getattr(fir, f"{name}_plain")
        out_h = 2 * h if name == "fir_upsample2" else h // 2
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(h * c)
            x = (torch.randn(BATCH, h, h, c, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
            label = f"{name} {BATCH}x{h}x{h}x{c} {dname(dtype)}"
            err = check_close(label, kernel(x), plain(x), dtype, FIR_REL_TOL)
            if (h, c) in ((20, 6), (10, 256)):
                check_close(f"{label} k={ASYMMETRIC_FIR}", kernel(x, ASYMMETRIC_FIR), plain(x, ASYMMETRIC_FIR),
                            dtype, FIR_REL_TOL)
            taps = 4 if name == "fir_upsample2" else 16
            out_elems = BATCH * out_h * out_h * c
            flops = 2 * taps * out_elems
            nbytes = itemsize(dtype) * (BATCH * h * h * c + out_elems)
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            row = dict(
                kernel=name, shape=f"{BATCH}x{h}x{h}x{c}", dtype=dname(dtype), calls_per_forward=calls,
                max_abs_err=err, gflop=flops / 1e9, mbytes=nbytes / 1e6, bound_ms=bound_ms, bound_by=bound_by,
                ms=time_ms(rotated(kernel, x, nbytes)), l2_ms=time_ms(lambda: kernel(x)),
            )
            msg = (f"    time: kernel {row['ms']:.4f} ms ({nbytes / row['ms'] / 1e6:.1f} GB/s), L2-resident"
                   f" {row['l2_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if yardsticks:
                row["library_max_abs_err"] = (fir_library(name, x).float() - plain(x).float()).abs().max().item()
                row["plain_ms"] = time_ms(rotated(plain, x, nbytes))
                row["library_ms"] = time_ms(rotated(lambda t: fir_library(name, t), x, nbytes))
                msg += (f", plain {row['plain_ms']:.4f} ms, depthwise cuDNN {row['library_ms']:.4f} ms"
                        f" (max diff {row['library_max_abs_err']:.1e}){ratio(row)}")
            print(msg, flush=True)
            rows.append(row)
    return rows


def offset_input(shape, dtype, offset, seed):
    """A contiguous NHWC input whose data starts ``offset`` bytes past an
    allocation's (aligned) start."""
    skip = offset // itemsize(dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = (torch.randn(math.prod(shape) + skip, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
    return buf[skip:].view(shape)


def check_fir_cases():
    """The FIR kernels against plain at `FIR_EXTRA_CASES` (inputs at an
    offset, 3 channels, odd H and W), both types, at `FIR_REL_TOL`; an
    offset input narrows the plan's vector to 4 bytes."""
    for name, b, h, w, c, offset in FIR_EXTRA_CASES:
        kernel, plain = WRAPPERS[name], getattr(fir, f"{name}_plain")
        for dtype in (torch.float32, torch.bfloat16):
            x = offset_input((b, h, w, c), dtype, offset, seed=h * w + c)
            plan = fir.launch_plan(b, h, w, c, dtype, (x.data_ptr(), 0), down=name == "fir_downsample2")
            if offset and plan.vec * itemsize(dtype) != 4:
                raise RuntimeError(f"{name} at a {offset}-byte offset: plan {plan}, expected 4-byte vectors")
            check_close(f"{name} {b}x{h}x{w}x{c} {dname(dtype)} offset {offset} B, {plan}", kernel(x), plain(x),
                        dtype, FIR_REL_TOL)


def check_fir_sites(calls, label, batch):
    """Both FIR kernels against plain at each (H, W, C) of a `forward_calls`
    counter, float32 and bfloat16, at `FIR_REL_TOL`; checked, not timed."""
    for name, h, w, c in sorted(k for k in calls if k[0] in ("fir_upsample2", "fir_downsample2")):
        kernel, plain = WRAPPERS[name], getattr(fir, f"{name}_plain")
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(h * c + 3)
            x = (torch.randn(batch, h, w, c, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
            check_close(f"{label} {name} {batch}x{h}x{w}x{c} {dname(dtype)}", kernel(x), plain(x), dtype,
                        FIR_REL_TOL)


# ---- the 3x3 conv (kernels 4 and 5) ------------------------------------------


def conv_call_shapes(config, batch=TRAIN_BATCH):
    """Counter of the kernel-4 calls of one train step on the meta device, by
    (phase, H, Cin, Cout), phase 'forward' or 'dx'."""
    calls = collections.Counter()
    phase = ["forward"]
    real = conv3x3._conv3x3_nhwc

    def record(x, w, bias):
        calls[(phase[0], x.shape[1], x.shape[3], w.shape[0])] += 1
        return torch.empty(*x.shape[:-1], w.shape[0], device=x.device, dtype=x.dtype)

    conv3x3._conv3x3_nhwc = record
    try:
        model = create_model(config, "meta").train()
        s = config.data.image_size
        x = torch.empty(batch, s, s, 3, device="meta")
        out = model({"x": x, "y": x}, torch.empty(batch, device="meta"))
        phase[0] = "dx"
        sum(v.sum() for v in as_outputs(out).values()).backward()
    finally:
        conv3x3._conv3x3_nhwc = real
    return calls


def conv_inputs(h, cin, cout, dtype, seed, batch=TRAIN_BATCH):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(batch, h, h, cin, generator=g, device="cuda") * 1.5 + 0.3).to(dtype)
    w = (torch.randn(cout, cin, 3, 3, generator=g, device="cuda") / math.sqrt(9 * cin)).to(dtype)
    bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
    return x, w, bias


def conv_work(h, cin, cout, dtype, batch=TRAIN_BATCH):
    """Operations and bytes of one call: x, w (and the float32 bias) read
    once, out written once."""
    px = batch * h * h
    return 2 * 9 * px * cin * cout, itemsize(dtype) * (px * cin + 9 * cin * cout + px * cout) + 4 * cout


def conv_library(x, w, bias):
    """The one PyTorch call: `F.conv2d` on the NCHW view, in x's dtype."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, None if bias is None else bias.to(x.dtype), padding=1)


def time_conv_row(row, h, cin, cout, dtype, kernel, plain, library, batch=TRAIN_BATCH):
    """Add the bound and the kernel's, plain version's and library call's
    times (CUDA events; 10 calls at 80x80 and up, 50 below) to ``row``."""
    flops, nbytes = conv_work(h, cin, cout, dtype, batch)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    iters = 10 if h >= 80 else 50
    row.update(
        gflop=flops / 1e9, bound_ms=bound_ms, bound_by=bound_by,
        ms=time_ms(kernel, iters, warmup=2), plain_ms=time_ms(plain, iters, warmup=2),
        library_ms=time_ms(library, iters, warmup=2),
    )
    print(
        f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, F.conv2d {row['library_ms']:.4f} ms"
        f"{ratio(row)},"
        f" bound {bound_ms:.4f} ms ({bound_by}), {flops / row['ms'] / 1e9:.2f} TFLOP/s",
        flush=True,
    )
    return row


def check_conv_shapes(shapes, seed=1000, site=None):
    """Kernel 4 against its plain version at each (phase, H, Cin, Cout) of
    ``shapes`` (B=16), float32 and bfloat16 (the dx conv is the forward
    entry on the output gradient with rotated weights, no bias), timed;
    returns the rows (tagged with ``site`` where one is given)."""
    rows = []
    for i, ((ph, h, cin, cout), calls) in enumerate(sorted(shapes.items())):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, bias = conv_inputs(h, cin, cout, dtype, seed=seed + i)
            b = bias if ph == "forward" else None
            label = f"conv3x3 {ph} {TRAIN_BATCH}x{h}x{h}x{cin}->{cout} {dname(dtype)}" + (f" ({site})" if site else "")
            err = check_close(label, conv3x3.conv3x3(x, w, b), conv3x3.conv3x3_plain(x, w, b), dtype)
            row = dict(phase=ph, shape=f"{TRAIN_BATCH}x{h}x{h}x{cin}->{cout}", dtype=dname(dtype),
                       calls_per_step=calls, max_abs_err=err, **({"site": site} if site else {}))
            rows.append(time_conv_row(
                row, h, cin, cout, dtype, lambda: conv3x3.conv3x3(x, w, b),
                lambda: conv3x3.conv3x3_plain(x, w, b), lambda: conv_library(x, w, b),
            ))
    return rows


def check_conv(shapes):
    """Kernel 4 at every distinct forward and dx shape of the flagship's
    train step (`check_conv_shapes`); its autograd dx against F.conv2d's at
    two shapes; kernel 5's (H, W, B, C) entry at two shapes.  Returns (conv
    rows, hmajor rows)."""
    rows = check_conv_shapes(shapes)
    for h, cin, cout in ROTATION_SHAPES:
        x, w, bias = conv_inputs(h, cin, cout, torch.float32, seed=h * cin)
        g = torch.randn(TRAIN_BATCH, h, h, cout, device="cuda")
        xk = x.clone().requires_grad_()
        conv3x3.conv3x3(xk, w, bias).backward(g)
        xr = x.clone().requires_grad_()
        conv_library(xr, w, bias).permute(0, 2, 3, 1).backward(g)
        check_close(f"conv3x3 autograd dx {TRAIN_BATCH}x{h}x{h}x{cin}->{cout} float32 (against F.conv2d's)",
                    xk.grad, xr.grad, torch.float32)
    hmajor_rows = []
    for h, cin, cout in HMAJOR_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, bias = conv_inputs(h, cin, cout, dtype, seed=7 * h + cin)
            xt = x.permute(1, 2, 0, 3).contiguous()
            label = f"conv3x3_hmajor {h}x{h}x{TRAIN_BATCH}x{cin}->{cout} {dname(dtype)}"
            err = check_close(label, conv3x3.conv3x3_hmajor(xt, w, bias), conv3x3.conv3x3_hmajor_plain(xt, w, bias), dtype)
            row = dict(shape=f"{h}x{h}x{TRAIN_BATCH}x{cin}->{cout}", dtype=dname(dtype), max_abs_err=err)
            hmajor_rows.append(time_conv_row(
                row, h, cin, cout, dtype, lambda: conv3x3.conv3x3_hmajor(xt, w, bias),
                lambda: conv3x3.conv3x3_hmajor_plain(xt, w, bias),
                lambda: conv_library(xt.permute(2, 0, 1, 3), w, bias),
            ))
    return rows, hmajor_rows


def conv_sums(rows, dtype, key="calls_per_step"):
    """Sums over one train step's calls at ``dtype``: forward, dx and both."""
    out = {}
    for part in ("forward", "dx", None):
        rs = [r for r in rows if r["dtype"] == dname(dtype) and (part is None or r["phase"] == part)]
        out[part or "step"] = {k: sum(r[k] * r[key] for r in rs) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return out


# ---- the trainer path -----------------------------------------------------


def train_configs(off=False):
    config = texture160_sr_cmde_conv3x3_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    if off:
        config.model.conv_dispatch = "none"
    return config


def by_norm(got, want):
    return ((got - want).norm() / want.norm()).item()


def train_agreement():
    """One train step from the same state, batch and seed with the policy on
    and off (float32, TF32 off, dropout 0.1 drawn alike), then two more:
    loss, each gradient by norm, and each tensor's update of params and EMA
    after 3 steps by norm (see TRAIN_PARAM_TOL).  Weights N(0, 0.02) and biases too
    (so no tensor's scale is 0), warmup 0 (lr 2e-4 from the first step)."""
    t = time.perf_counter()
    configs = {"on": train_configs(), "off": train_configs(off=True)}
    for c in configs.values():
        c.optim.warmup = 0
    models = {"on": init_model_random(configs["on"], seed=configs["on"].seed, device="cuda")}
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():
        for name, p in models["on"].named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=g)
    models["off"] = create_model(configs["off"], "cuda")
    models["off"].load_state_dict(models["on"].state_dict())
    start = {n: p.detach().clone() for n, p in models["off"].named_parameters()}
    batch = to_device(next(PKLDataModule(configs["on"]).train_iterator()), torch.device("cuda"))
    states = {k: create_train_state(configs[k], m.train()) for k, m in models.items()}
    steps = {k: make_train_step(configs[k], m) for k, m in models.items()}
    grads_off, result = [], {}
    for i in range(TRAIN_AGREE_STEPS):
        metrics = {k: steps[k](states[k], batch) for k in ("on", "off")}
        grads = {k: {n: p.grad for n, p in models[k].named_parameters()} for k in ("on", "off")}
        grads_off.append({n: g.clone() for n, g in grads["off"].items()})
        if i == 0:
            loss_on, loss_off = (float(metrics[k]["loss"]) for k in ("on", "off"))
            top = max(g.norm().item() for g in grads["off"].values())
            errs = {n: (grads["on"][n] - g).norm().item() / max(g.norm().item(), NOISE_LEVEL * top)
                    for n, g in grads["off"].items()}
            result.update(loss_on=loss_on, loss_off=loss_off, loss_rel_err=abs(loss_on - loss_off) / abs(loss_off),
                          grad_norm_on=float(metrics["on"]["grad_norm"]), grad_norm_off=float(metrics["off"]["grad_norm"]),
                          worst_grad_norm_rel_err=max(errs.values()), worst_grad_tensor=max(errs, key=errs.get))
    noise = set()
    for step_grads in grads_off:
        top = max(g.abs().max().item() for g in step_grads.values())
        noise |= {n for n, g in step_grads.items() if g.abs().max().item() < NOISE_LEVEL * top}
    worst_update, worst_param, excluded, total = 0.0, 0.0, 0, 0
    for label, got_of, want_of in (
        ("params", dict(models["on"].named_parameters()), dict(models["off"].named_parameters())),
        ("ema", states["on"].ema.params, states["off"].ema.params),
    ):
        for n, want in want_of.items():
            want, got = want.detach(), got_of[n].detach()
            total += want.numel()
            if n in noise:
                excluded += want.numel()
                continue
            worst_update = max(worst_update, by_norm(got - start[n], want - start[n]))
            small = torch.zeros_like(want, dtype=torch.bool)
            for step_grads in grads_off:
                gr = step_grads[n].abs()
                small |= gr < SMALL_GRAD * gr.max()
            excluded += int(small.sum())
            err = torch.where(small, 0.0, (got - want).abs()).max().item()
            worst_param = max(worst_param, err / want.abs().max().item())
    result.update(worst_update_norm_rel_err=worst_update, worst_param_rel_err=worst_param,
                  excluded_elements=excluded, elements=total, noise_tensors=sorted(noise))
    ok = (result["loss_rel_err"] <= TRAIN_LOSS_TOL and result["worst_grad_norm_rel_err"] <= TRAIN_GRAD_TOL
          and worst_update <= TRAIN_UPDATE_TOL)
    phase(
        "agreement", t,
        f"train step, conv3x3_kernel on vs off (B={TRAIN_BATCH}, float32): loss {loss_on:.6f} vs {loss_off:.6f}"
        f" (rel {result['loss_rel_err']:.3e}, tol {TRAIN_LOSS_TOL:.0e}); grad_norm {result['grad_norm_on']:.6f} vs"
        f" {result['grad_norm_off']:.6f}; worst gradient by norm {result['worst_grad_norm_rel_err']:.3e}"
        f" ({result['worst_grad_tensor']}, tol {TRAIN_GRAD_TOL:.0e}); after {TRAIN_AGREE_STEPS} steps: worst update"
        f" by norm {worst_update:.3e} (tol {TRAIN_UPDATE_TOL:.0e}); worst element {worst_param:.3e} of its scale"
        f" (printed, not gated; the CPU test's {TRAIN_PARAM_TOL:.0e}), with {excluded} of {total} elements of params"
        f" and EMA excluded as small-gradient or in the {len(noise)} rounding-noise tensors {'ok' if ok else 'FAIL'}",
    )
    if not ok:
        raise RuntimeError("the train step with kernel 4 disagrees with the step without it")
    return result


def step_split(trainer):
    """One step of ``trainer`` split by CUDA events: the host making a batch
    and copying it over, forward + loss, backward, optimizer + EMA."""
    it = trainer.datamodule.train_iterator()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = to_device(trainer.task.prepare_batch(next(it)), trainer.device)
    torch.cuda.synchronize()
    data_ms = (time.perf_counter() - t0) * 1e3
    events = []
    trainer.train_step(trainer.state, batch, events=events)
    torch.cuda.synchronize()
    fwd, bwd, opt = (events[i].elapsed_time(events[i + 1]) for i in range(3))
    return dict(data_ms=data_ms, forward_loss_ms=fwd, backward_ms=bwd, optimizer_ema_ms=opt)


def run_trainer(label, config, steps, expected, evals, restore=True):
    """`Trainer(config).fit(max_steps=steps)` with every kernel counter at 0
    just before and read just after; the scalars, the launches, a checkpoint
    restored into a new trainer, one step's split and the peak memory."""
    with tempfile.TemporaryDirectory() as log_path:
        trainer = Trainer(config, log_path)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in WRAPPERS.values():
            fn.launches = 0
        t = time.perf_counter()
        history = trainer.fit(max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        scalars = read_scalars(os.path.join(log_path, "scalars.jsonl"))
        last = {tag: (value, step) for tag, value, step in scalars}
        losses = [v for tag, v, _ in scalars if tag == "train_loss"]
        sigma_y = {(tag, step): v for tag, v, step in scalars if tag in ("sigma_min_y", "sigma_max_y")}
        result = dict(
            path=label, steps=steps, wall_s=wall, peak_gib=peak, launches=launches, expected_launches=expected,
            train_loss=losses, eval_loss=history["eval_loss"],
            ms_per_step=last["ms_per_step"][0], train_imgs_per_sec=last["train_imgs_per_sec"][0],
            window_steps=int(last["window_steps"][0]),
        )
        ok = all(math.isfinite(v) for v in losses + [v for _, v in history["eval_loss"]])
        ok = ok and len(history["eval_loss"]) == evals and not trainer.callback_failures
        result["callback_failures"] = dict(trainer.callback_failures)
        if is_decreasing_variance(config):  # VS-CMDE logs sigma_y as its schedule gives it, at every log
            logged = sorted({step for _, step in sigma_y})
            schedule = {s: sigma_y_at_step(config, s) for s in logged}
            result["sigma_y"] = {s: {"sigma_min_y": sigma_y[("sigma_min_y", s)], "sigma_max_y": sigma_y[("sigma_max_y", s)]}
                                 for s in logged}
            ok = ok and logged == list(range(1, steps + 1)) and all(
                (sigma_y[("sigma_min_y", s)], sigma_y[("sigma_max_y", s)]) == schedule[s] for s in logged)
        if restore:
            again = Trainer(config, os.path.join(log_path, "restored"), checkpoint_path=trainer.ckpt.directory)
            a, b = trainer.state, again.state
            same = (a.step == b.step == steps and a.ema.num_updates == b.ema.num_updates
                    and a.scheduler.last_epoch == b.scheduler.last_epoch
                    and all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
                    and all(torch.equal(a.ema.params[n], b.ema.params[n]) for n in a.ema.params)
                    and all(torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k])
                            for p, q in zip(a.model.parameters(), b.model.parameters())
                            for k in ("exp_avg", "exp_avg_sq", "step")))
            result["checkpoint_restored_exactly"] = same
            ok = ok and same
            del again
        result.update(step_split(trainer))
    phase(
        "main", t,
        f"{label}: Trainer.fit({steps}) {wall:.3f} s wall; sustained window of {result['window_steps']} steps:"
        f" {result['ms_per_step']:.3f} ms/step, {result['train_imgs_per_sec']:.3f} images/s; peak {peak:.3f} GiB;"
        f" train_loss {['%.5f' % v for v in losses]}, eval_loss {history['eval_loss']};"
        f" checkpoint restored exactly: {result.get('checkpoint_restored_exactly', 'not checked')};"
        + (f" sigma_y as scheduled at steps 1-{steps}: last {result['sigma_y'][steps]};" if "sigma_y" in result else "")
        + f" one step: data {result['data_ms']:.3f} ms (host), forward+loss {result['forward_loss_ms']:.3f} ms,"
        f" backward {result['backward_ms']:.3f} ms, optimizer+EMA {result['optimizer_ema_ms']:.3f} ms;"
        f" launches {launches} (expected {expected}) {'ok' if ok and launches == expected else 'FAIL'}",
    )
    if not ok:
        raise RuntimeError(f"{label}: losses not finite, eval, checkpoint or sigma_y wrong")
    if launches != expected:
        raise RuntimeError(f"{label}: launches {launches}, expected {expected}")
    return result


# ---- model paths ------------------------------------------------------------


def score_fn(model, sde, compute_dtype=None):
    """The conditional score as the JAX bench composes it."""
    raw = get_score_fn(sde, model, conditional=True, train=False, continuous=True, compute_dtype=compute_dtype)
    return get_conditional_score_fn(raw, "x")


def pc_sampler(config, sde, eps, shape, p_steps):
    s = config.sampling
    return get_pc_conditional_sampler(
        sde, shape, s.predictor, s.corrector, snr=s.snr, p_steps=p_steps,
        c_steps=s.n_steps_each, denoise=s.noise_removal, eps=eps,
    )


def as_outputs(out):
    """A network's output as a dict: a paired model's as it is, one tensor
    (CDE's score of x) under the key ``x``."""
    return out if isinstance(out, dict) else {"x": out}


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def norm_rel_err(got, want):
    return ((got - want).norm() / want.norm()).item()


def agreement(label, config_on, config_off, model, batch, compute_dtype, tol, plain_off=False):
    """The same weights with the kernels on (``config_on``) and off
    (``config_off``, and with ``plain_off`` every kernel call site on its
    plain version): the score on the sampler's own input at t = 0.5 (x_t
    and y_t drawn from the SDE's marginals), a 3-step sample, and the raw
    network output on the clean batch.

    Float32: all three on against off, largest difference over largest
    magnitude, at ``tol``.

    Bfloat16: the two paths round at other places, and this network turns
    one bfloat16 step anywhere into ~1e-2 at its output; the kernel path
    differs from itself with the plain versions as much as from the unfused
    path (``*_floor`` below), so the largest single difference measures the
    network, not the kernels.  The score is held by norm (||on - off|| /
    ||off||) at ``tol``, the sample as in float32, and the raw output against
    the float32 network: the kernel path no further from it than the
    unfused path (norm, within 10%).  Every other difference is reported.
    """
    t = time.perf_counter()
    model_off = create_model(config_off, "cuda")
    model_off.load_state_dict(model.state_dict())
    sde, eps = sampler_sde(config_on)
    vec_t = torch.full((BATCH,), 0.5, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    sdes = sde if is_multispeed(sde) else {"x": sde}  # one SDE (CDE): y enters clean
    x_t, y_t = (
        sdes[k].marginal_prob(batch[k], vec_t)[0]
        + batch_mul(sdes[k].marginal_prob(batch[k], vec_t)[1], torch.randn(batch[k].shape, generator=g, device="cuda"))
        if k in sdes else batch[k]
        for k in ("x", "y")
    )
    short = pc_sampler(config_on, sde, eps, tuple(batch["x"].shape), p_steps=3)
    inputs, labels = {"x": batch["x"], "y": batch["y"]}, vec_t * 999

    def run(m):
        score = score_fn(m, sde, compute_dtype)(x_t, y_t, vec_t)
        sample, _ = short(torch.Generator(device="cuda").manual_seed(1), score_fn(m, sde, compute_dtype), batch["y"])
        return score, sample, as_outputs(get_model_fn(m, compute_dtype=compute_dtype)(inputs, labels))

    score_on, s_got, raw_on = run(model)
    with plain_versions() if plain_off else contextlib.nullcontext():
        score_off, s_want, raw_off = run(model_off)
    r = dict(
        path=label, tol=tol,
        score_rel_err=rel_err(score_on, score_off), score_norm_rel_err=norm_rel_err(score_on, score_off),
        sample_rel_err=rel_err(s_got, s_want),
        raw_forward_rel_err=max(rel_err(raw_on[k], raw_off[k]) for k in raw_on),
    )
    msg = (
        f"score rel err {r['score_rel_err']:.3e} (norm {r['score_norm_rel_err']:.3e}), 3-step sample rel err"
        f" {r['sample_rel_err']:.3e}, raw forward rel err {r['raw_forward_rel_err']:.3e}"
    )
    if compute_dtype is None:
        ok = max(r["score_rel_err"], r["sample_rel_err"], r["raw_forward_rel_err"]) <= tol
        msg += f" (tol {tol:.0e})"
    else:
        with plain_versions():
            score_plain = score_fn(model, sde, compute_dtype)(x_t, y_t, vec_t)
            raw_plain = as_outputs(get_model_fn(model, compute_dtype=compute_dtype)(inputs, labels))
        ref = as_outputs(get_model_fn(model_off)(inputs, labels))  # the float32 network
        r.update(
            score_floor_rel_err=rel_err(score_on, score_plain),
            score_floor_norm_rel_err=norm_rel_err(score_on, score_plain),
            raw_forward_floor_rel_err=max(rel_err(raw_on[k], raw_plain[k]) for k in raw_on),
            raw_on_vs_float32=max(norm_rel_err(raw_on[k], ref[k]) for k in raw_on),
            raw_off_vs_float32=max(norm_rel_err(raw_off[k], ref[k]) for k in raw_on),
        )
        ok = (
            r["score_norm_rel_err"] <= tol
            and r["sample_rel_err"] <= tol
            and r["raw_on_vs_float32"] <= 1.1 * r["raw_off_vs_float32"]
        )
        msg += (
            f"; the kernel path against its plain versions: score rel err {r['score_floor_rel_err']:.3e}"
            f" (norm {r['score_floor_norm_rel_err']:.3e}), raw forward rel err {r['raw_forward_floor_rel_err']:.3e};"
            f" raw forward against the float32 network (norm): on {r['raw_on_vs_float32']:.3e},"
            f" off {r['raw_off_vs_float32']:.3e} (tol: score norm and sample {tol:.0e}, on <= 1.1x off)"
        )
    phase("agreement", t, f"{label}: kernels on vs off: {msg} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the kernel path disagrees with the unfused path")
    return r


def run_sampler(label, sample, per_forward, steps, shape=(BATCH, 160, 160, 3), evals_per_step=2):
    """Run ``sample()`` with every kernel counter at 0; check the counts
    (``per_forward`` x ``evals_per_step`` x ``steps``) and the samples'
    shape and values."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in WRAPPERS.values():
        fn.launches = 0
    t = time.perf_counter()
    samples = sample()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    expected = {name: per_forward.get(name, 0) * evals_per_step * steps for name in WRAPPERS}
    finite = bool(torch.isfinite(samples).all())
    result = dict(
        path=label, steps=steps, wall_s=wall, images_per_s=shape[0] / wall,
        ms_per_score_eval=wall / (evals_per_step * steps) * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
    )
    phase(
        "main", t,
        f"{label}: {steps}-step PC sampler: {wall:.3f} s wall, {result['images_per_s']:.4f} images/s,"
        f" {result['ms_per_score_eval']:.3f} ms per score evaluation, peak {result['peak_gib']:.3f} GiB;"
        f" samples {tuple(samples.shape)} finite={finite} range [{samples.min().item():.3f},"
        f" {samples.max().item():.3f}]; launches {launches} (expected {expected})",
    )
    if tuple(samples.shape) != tuple(shape) or not finite:
        raise RuntimeError(f"{label}: samples are not finite or not shaped {tuple(shape)}")
    if launches != expected:
        raise RuntimeError(f"{label}: launches {launches}, expected {expected}")
    return result


def ncsnpp_backward(model, batch):
    """One ``loss.backward()`` through the full-width ncsnpp_KxSR at B=1, in
    train mode, float32: the loss a seeded weighted sum of its output on the
    first test pair at label 499.5.  Where a gradient flows, the FIR
    resamplings take their plain versions (`ops/upfirdn.py`), so the forward
    launches the kernels on the raw input's pyramid alone
    (`NCSNPP_GRAD_FORWARD`) and the backward launches none.  Every gradient
    must be finite, and all of them together must agree by norm (1e-4) with
    the same backward with every FIR call on its plain version."""
    t = time.perf_counter()
    inputs = {k: batch[k][:1] for k in ("x", "y")}
    labels = torch.full((1,), 499.5, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        weights = {k: torch.randn(v.shape, generator=g, device="cuda") for k, v in model(inputs, labels).items()}
    model.train()

    def backward():
        model.zero_grad(set_to_none=True)
        torch.manual_seed(4)  # the same dropout masks both times
        out = model(inputs, labels)
        forward = {n: WRAPPERS[n].launches for n in NCSNPP_GRAD_FORWARD}
        sum((out[k] * weights[k]).sum() for k in weights).backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        return forward, {n: WRAPPERS[n].launches for n in NCSNPP_GRAD_FORWARD}, grads

    for fn in WRAPPERS.values():
        fn.launches = 0
    forward, after, grads = backward()
    with plain_versions():
        _, _, plain_grads = backward()
    model.eval()
    finite = all(bool(torch.isfinite(v).all()) for v in grads.values())
    got, want = (torch.cat([d[n].flatten() for n in sorted(plain_grads)]) for d in (grads, plain_grads))
    err = norm_rel_err(got, want)
    result = dict(
        check="float32 NCSN++ backward, B=1", tensors=len(grads), finite=finite, fir_launches_forward=forward,
        fir_launches_after_backward=after, grad_norm=want.norm().item(), vs_plain_by_norm=err,
    )
    phase(
        "backward", t,
        f"ncsnpp_KxSR B=1: {len(grads)} gradient tensors, finite={finite}, |grad| {result['grad_norm']:.4e},"
        f" kernel path vs plain {err:.3e} by norm (tol 1e-4); FIR launches in the forward {forward}"
        f" (expected {NCSNPP_GRAD_FORWARD}), after the backward {after}",
    )
    if not finite or sorted(grads) != sorted(plain_grads) or err > 1e-4:
        raise RuntimeError("NCSN++ backward: gradients not finite or not those of the plain path")
    if forward != NCSNPP_GRAD_FORWARD or after != forward:
        raise RuntimeError(f"NCSN++ backward: FIR launches {forward} then {after}, expected {NCSNPP_GRAD_FORWARD}")
    return result


def per_forward_row(name, route_source, replaces, launches, rows, dtype, calls_key, unit):
    """One kernel's line: sums over the calls of one forward at ``dtype``."""
    rows = [r for r in rows if r["dtype"] == dname(dtype) and r[calls_key] > 0]
    total = lambda key: sum(r[key] * r[calls_key] for r in rows)  # noqa: E731
    return dict(
        name=name, route="cuda", source=route_source, replaces=replaces, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
        library_ms=total("library_ms"), unit=unit,
    )


# ---- the fused bias + leaky ReLU (kernel 8) --------------------------------


def check_fused_act():
    """Kernel 8 against its plain version at `FUSED_ACT_SHAPES`, float32 and
    bfloat16, each timed (CUDA events) beside the plain three-op chain and
    its byte bound; returns per-shape rows."""
    rows = []
    for shape, with_bias, slope, scale in FUSED_ACT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(sum(shape))
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype) if with_bias else None
            kernel = lambda: fused_act.fused_leaky_relu(x, b, slope, scale)  # noqa: E731
            plain = lambda: fused_act.fused_leaky_relu_plain(x, b, slope, scale)  # noqa: E731
            got, want = kernel(), plain()
            label = f"fused_leaky_relu {shape} bias={with_bias} slope={slope} scale={scale:.4f} {dname(dtype)}"
            if dtype == torch.float32:
                err = check_close(label, got, want, dtype, {dtype: FUSED_ACT_F32_TOL})
            else:
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
                steps = (diff / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()
                err = diff.max().item()
                ok = got.dtype == dtype and got.shape == want.shape and steps <= FUSED_ACT_BF16_STEPS
                print(f"  {label}: max_abs_err {err:.3e}, {steps:.2f} bfloat16 steps (tol {FUSED_ACT_BF16_STEPS})"
                      f" {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise RuntimeError(f"{label}: kernel disagrees with its plain version")
            n = x.numel()
            bound_ms, bound_by = bound(3 * n, itemsize(dtype) * (2 * n + (shape[-1] if with_bias else 0)), dtype)
            row = dict(shape=list(shape), bias=with_bias, negative_slope=slope, scale=scale, dtype=dname(dtype),
                       max_abs_err=err, mbytes=itemsize(dtype) * 2 * n / 1e6, bound_ms=bound_ms, bound_by=bound_by,
                       ms=time_ms(kernel), plain_ms=time_ms(plain), library_ms=None)
            print(f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, no library call, bound {bound_ms:.4f} ms"
                  f" ({bound_by}), {2 * n * itemsize(dtype) / row['ms'] / 1e6:.1f} GB/s", flush=True)
            rows.append(row)
    return rows


# ---- the --mode test harness on the trained texture64 checkpoint -------------


def harness_config(base_log_dir):
    """The recipe `texture64_sr_cmde_test` on test batch 0, trees under
    ``base_log_dir``."""
    config = texture64_sr_cmde_test_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    config.eval.base_log_dir = base_log_dir
    config.eval.first_test_batch, config.eval.last_test_batch = 0, 1
    config.eval.draws = list(HARNESS_DRAWS)
    config.eval.p_steps = HARNESS_STEPS
    return config


def check_harness_tails(shapes):
    """The fused tail against plain at the harness's sites (B=16, float32
    and bfloat16, no temb, as the resblock calls it), float32 timed;
    returns per-shape rows."""
    rows = []
    for (h, c), calls in sorted(shapes.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, gamma, beta, bias, _ = tail_inputs(h, c, dtype, seed=h * c + 2, batch=HARNESS_BATCH)
            err = check_close(
                f"harness tail {HARNESS_BATCH}x{h}x{h}x{c} {dname(dtype)}",
                fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias),
                fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias), dtype,
            )
            if dtype != torch.float32:
                continue
            flops, nbytes = tail_work(h, c, dtype, HARNESS_BATCH)
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            row = dict(
                shape=f"{HARNESS_BATCH}x{h}x{h}x{c}", dtype=dname(dtype), calls_per_forward_harness=calls,
                max_abs_err=err, gflop=flops / 1e9, bound_ms=bound_ms, bound_by=bound_by,
                ms=time_ms(lambda: fused_tail.gn_silu_conv3x3(x, w, gamma, beta, GROUPS, bias=bias)),
                plain_ms=time_ms(lambda: fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, GROUPS, bias=bias)),
                library_ms=time_ms(lambda: conv3x3_nhwc(x, w, bias)),
            )
            print(f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cuDNN conv only"
                  f" {row['library_ms']:.4f} ms{ratio(row)}, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
            rows.append(row)
    return rows


def texture64_agreement(config):
    """The trained EMA's conditional score with the fused tail on and off on
    test batch 0 at t = 0.5 (x_t and y_t drawn from the SDE's marginals):
    float32 at `TEXTURE64_AGREE_TOL` of its largest magnitude; bfloat16
    compute (the tail's tensor-core path, 17 launches) by norm at
    `BF16_AGREE_TOL`, as `agreement` holds the random-weight paths.  Then
    the same with `fused_block` and `fused_tail` both on against both off
    (the recipe leaves `fused_block` unset, as JAX's does): the block
    kernels at the 8x8 and 4x4 levels, `TEXTURE64_BLOCK_SHAPES`, on
    trained weights."""
    t = time.perf_counter()
    model, step = load_model(config, "cuda")
    off_config = copy.deepcopy(config)
    off_config.model.fused_tail = False
    model_off, _ = load_model(off_config, "cuda")
    block_config = copy.deepcopy(config)
    block_config.model.fused_block = True
    model_block, _ = load_model(block_config, "cuda")
    block_names = ("resblock_fused", "resblock_fused_split", "gn_silu_conv3x3")
    sde, _ = build_sde(config)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter_test_batches(config)).items()}
    vec_t = torch.full((HARNESS_BATCH,), 0.5, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    x_t, y_t = (
        batch[k] + batch_mul(sde[k].marginal_prob(batch[k], vec_t)[1],
                             torch.randn(batch[k].shape, generator=g, device="cuda"))
        for k in ("x", "y")
    )
    with torch.no_grad():
        on, off = (score_fn(m, sde)(x_t, y_t, vec_t) for m in (model, model_off))
        launches = fused_tail.gn_silu_conv3x3.launches
        on_bf16 = score_fn(model, sde, torch.bfloat16)(x_t, y_t, vec_t)
        bf16_launches = fused_tail.gn_silu_conv3x3.launches - launches
        off_bf16 = score_fn(model_off, sde, torch.bfloat16)(x_t, y_t, vec_t)
        block_scores, block_launches = {}, {}
        for dtype in (None, torch.bfloat16):
            before = {n: WRAPPERS[n].launches for n in block_names}
            block_scores[dtype] = score_fn(model_block, sde, dtype)(x_t, y_t, vec_t)
            block_launches[dtype] = {n: WRAPPERS[n].launches - before[n] for n in block_names}
    err, err_bf16 = rel_err(on, off), norm_rel_err(on_bf16, off_bf16)
    ok = err <= TEXTURE64_AGREE_TOL and bool(torch.isfinite(on).all())
    ok_bf16 = err_bf16 <= BF16_AGREE_TOL and bool(torch.isfinite(on_bf16).all()) and bf16_launches == 17
    phase("agreement", t, f"texture64 trained EMA (step {step}): score with the fused tail on vs off, rel err"
                          f" {err:.3e} (tol {TEXTURE64_AGREE_TOL:.0e}) {'ok' if ok else 'FAIL'}; bfloat16 compute"
                          f" ({bf16_launches} tail launches, the tensor-core path): by norm {err_bf16:.3e}, rel err"
                          f" {rel_err(on_bf16, off_bf16):.3e} (tol by norm {BF16_AGREE_TOL:.0e})"
                          f" {'ok' if ok_bf16 else 'FAIL'}")
    expected = {"resblock_fused": 0, "resblock_fused_split": 0}
    for name, *_, calls in TEXTURE64_BLOCK_SHAPES:
        expected[name] += calls
    expected["gn_silu_conv3x3"] = 17 - sum(expected.values())  # the tails at 16x16 stay
    err_block = rel_err(block_scores[None], off)
    err_block_bf16 = norm_rel_err(block_scores[torch.bfloat16], off_bf16)
    ok_block = (err_block <= TEXTURE64_AGREE_TOL and bool(torch.isfinite(block_scores[None]).all())
                and block_launches[None] == expected)
    ok_block_bf16 = (err_block_bf16 <= BF16_AGREE_TOL and bool(torch.isfinite(block_scores[torch.bfloat16]).all())
                     and block_launches[torch.bfloat16] == expected)
    phase("agreement", t, f"texture64 trained EMA: score with fused_block and fused_tail on vs both off, float32"
                          f" (launches {block_launches[None]}, expected {expected}): rel err {err_block:.3e} (tol"
                          f" {TEXTURE64_AGREE_TOL:.0e}) {'ok' if ok_block else 'FAIL'}; bfloat16 compute (launches"
                          f" {block_launches[torch.bfloat16]}): by norm {err_block_bf16:.3e}, rel err"
                          f" {rel_err(block_scores[torch.bfloat16], off_bf16):.3e} (tol by norm {BF16_AGREE_TOL:.0e})"
                          f" {'ok' if ok_block_bf16 else 'FAIL'}")
    if not (ok and ok_bf16):
        raise RuntimeError("texture64: the fused tail disagrees with the unfused path on the trained weights")
    if not (ok_block and ok_block_bf16):
        raise RuntimeError("texture64: the block kernels disagree with the unfused path on the trained weights")
    return dict(path="texture64 trained EMA, fused tail", tol=TEXTURE64_AGREE_TOL, score_rel_err=err,
                bfloat16=dict(tol=BF16_AGREE_TOL, score_norm_rel_err=err_bf16, tail_launches=bf16_launches),
                fused_block=dict(score_rel_err=err_block, launches=block_launches[None],
                                 bfloat16=dict(score_norm_rel_err=err_block_bf16,
                                               launches=block_launches[torch.bfloat16])))


def psnr_without_quantization(config, draw):
    """Mean PSNR of one draw's PNGs against the ground-truth PNGs, each
    image's MSE less the 8-bit rounding's `QUANTIZATION_MSE`."""
    images = os.path.join(output_dir(config), "images")
    gt = numbered(os.path.join(images, "x_gt"))
    drawn = numbered(os.path.join(images, "samples", "snr_0.150", f"draw_{draw}"))
    ids = sorted(gt)
    x = torch.from_numpy(load_images([gt[i] for i in ids])).double() * 255.0
    s = torch.from_numpy(load_images([drawn[i] for i in ids])).double() * 255.0
    mse = ((s - x) ** 2).mean(dim=(1, 2, 3)) - QUANTIZATION_MSE
    return float((20 * torch.log10(255.0 / torch.sqrt(mse))).mean())


def run_harness(per_forward_tail):
    """`run_test` on test batch 0 with every kernel counter at 0 just before
    and read just after; the batch means against `HARNESS_JAX`, then the
    offline pipeline on the written tree."""
    with tempfile.TemporaryDirectory() as base_log_dir:
        config = harness_config(base_log_dir)
        records = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in WRAPPERS.values():
            fn.launches = 0
        t = time.perf_counter()
        results = run_test(config, device="cuda", draw_records=records)
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        expected = {name: 0 for name in WRAPPERS}
        expected["gn_silu_conv3x3"] = per_forward_tail * 2 * HARNESS_STEPS * len(HARNESS_DRAWS)
        means = {m: v[0] for m, v in results[0.15].items()}
        seconds = [r["seconds"] for r in records]
        result = dict(
            path="float32 --mode test harness, texture64 trained EMA", steps=HARNESS_STEPS, batch=HARNESS_BATCH,
            wall_s=wall, seconds_per_draw=seconds,
            ms_per_score_eval=[sec / (2 * HARNESS_STEPS) * 1e3 for sec in seconds],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches, expected_launches=expected,
            draws=records, means=means, jax_means=HARNESS_JAX,
        )
        for r in records:
            print(f"  draw {r['draw']}: psnr {r['psnr']:.4f} ssim {r['ssim']:.5f} consistency {r['consistency']:.4f}"
                  f" in {r['seconds']:.3f} s ({r['seconds'] / (2 * HARNESS_STEPS) * 1e3:.3f} ms per score evaluation)",
                  flush=True)
        off = {m: abs(means[m] - HARNESS_JAX[m]) for m in HARNESS_JAX if m in means}
        ok = len(off) == len(HARNESS_JAX) and all(v <= HARNESS_BAND[m] for m, v in off.items())
        ok = ok and launches == expected
        phase(
            "main", t,
            f"{result['path']}: batch 0 means "
            + ", ".join(f"{m} {means[m]:.5f} (JAX {HARNESS_JAX[m]:.5f}, band {HARNESS_BAND[m]:.4g})" for m in off)
            + f"; {wall:.3f} s wall, peak {result['peak_gib']:.3f} GiB; launches {launches} (expected {expected})"
            f" {'ok' if ok else 'FAIL'}",
        )
        if launches != expected:
            raise RuntimeError(f"harness: launches {launches}, expected {expected}")
        if not ok:
            raise RuntimeError(f"harness: batch-0 means {means} outside the bands around the JAX harness's")

        t = time.perf_counter()
        pipe = run_evaluation_pipeline("super-resolution", output_dir(config), 0.15, scale=config.data.scale)
        gaps = {f"draw_{r['draw']}": pipe["per_draw"][f"draw_{r['draw']}"]["psnr"] - r["psnr"] for r in records}
        unquantized = {f"draw_{r['draw']}": psnr_without_quantization(config, r["draw"]) - r["psnr"] for r in records}
        ok = pipe["n_images"] == HARNESS_BATCH and all(abs(v) <= PIPELINE_PSNR_TOL for v in unquantized.values())
        phase(
            "main", t,
            "evaluation pipeline on the written tree: "
            + ", ".join(f"{k} psnr {v['psnr']:.4f} ssim {v['ssim']:.5f} consistency {v['consistency']:.4f}"
                        for k, v in sorted(pipe["per_draw"].items()))
            + f", diversity {pipe['diversity']:.6f}; PSNR from the PNGs minus the harness's: "
            + ", ".join(f"{k} {v:+.4f} dB" for k, v in sorted(gaps.items()))
            + f"; the same with the 8-bit rounding's {QUANTIZATION_MSE:.4f} level^2 taken out of each image's MSE: "
            + ", ".join(f"{k} {v:+.4f} dB" for k, v in sorted(unquantized.items()))
            + f" (tol {PIPELINE_PSNR_TOL} dB) {'ok' if ok else 'FAIL'}",
        )
        if not ok:
            raise RuntimeError(f"pipeline: per-draw PSNR {unquantized} off the harness's by more than"
                               f" {PIPELINE_PSNR_TOL} dB with the rounding's MSE taken out")
        result["pipeline"] = dict(per_draw=pipe["per_draw"], diversity=pipe["diversity"], skipped=pipe["skipped"],
                                  psnr_minus_harness=gaps, psnr_without_quantization_minus_harness=unquantized)
    return result


# ---- the paper's other estimators, the unconditional and the VP samplers ---


def datasets_dir(config):
    config.data.base_dir = os.path.join(REPO, "datasets")
    return config


def run_estimator(approach, recipe, checked_conv):
    """One estimator on the texture160 recipe at the flagship's width: its
    bfloat16 sampler with fused_block and fused_tail (kernels 1-3, counted
    exactly), for CDE and VS-CMDE its kernels on against off, and
    `Trainer.fit` in float32 with kernel 4 (counted exactly; VS-CMDE's
    logged sigma_y held to its schedule), kernel 4 first checked against
    its plain version at each train-step shape not in ``checked_conv``
    (which gains them).  Returns (sampler, trainer, agreement, conv rows)."""
    t = time.perf_counter()
    config = datasets_dir(recipe())
    config.model.fused_block = True
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter_test_batches(config)).items()}
    model = init_model_random(config, seed=config.seed, device="cuda")
    sde, eps = sampler_sde(config)
    calls = forward_calls(config, BATCH)
    per_forward = per_name(calls)
    sigma_y = sde["y"].sigma_max if is_multispeed(sde) else None
    phase(
        "setup", t,
        f"{approach} ({config.model.name}): texture160 batch {tuple(batch['y'].shape)},"
        f" {'sigma_y,max %.4f' % sigma_y if sigma_y is not None else 'one VE SDE, y clean'};"
        f" kernel calls per forward {per_forward}",
    )
    if calls != flagship_block_path_calls():
        raise RuntimeError(f"{approach}: kernel calls per forward {dict(calls)}, expected the flagship's, at the"
                           " sites the kernel phase checked")
    agree = []
    if approach in ESTIMATOR_AGREEMENT:
        off = datasets_dir(recipe())
        off.model.fused_tail = False
        agree = [
            agreement(f"float32 {approach} block path", config, off, model, batch, None, REL_TOL[torch.float32]),
            agreement(f"bfloat16 {approach} block path", config, off, model, batch, torch.bfloat16, BF16_AGREE_TOL),
        ]
    score = score_fn(model, sde, torch.bfloat16)
    # a short run first, so that the timed window holds no first call's cost
    pc_sampler(config, sde, eps, tuple(batch["x"].shape), p_steps=WARMUP_STEPS)(
        torch.Generator(device="cuda").manual_seed(0), score, batch["y"])
    sampler = pc_sampler(config, sde, eps, tuple(batch["x"].shape), p_steps=ESTIMATOR_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(config.seed)
    sample = run_sampler(
        f"{approach} bfloat16 fused_block+fused_tail", lambda: sampler(gen, score, batch["y"])[0],
        per_forward, ESTIMATOR_STEPS, shape=tuple(batch["x"].shape),
    )
    sample["sigma_max_y"] = sigma_y
    del model, score

    train = datasets_dir(recipe())
    train.model.conv_dispatch = "conv3x3_kernel"
    train.training.log_freq, train.training.eval_freq, train.training.snapshot_freq = 1, 10**9, 10**9
    shapes = conv_call_shapes(train)
    per_step = tuple(sum(n for (ph, *_), n in shapes.items() if ph == p) for p in ("forward", "dx"))
    if per_step != CONV_PER_TRAIN_STEP:
        raise RuntimeError(f"{approach}: kernel 4 calls per train step {per_step}, expected {CONV_PER_TRAIN_STEP}")
    # CDE's 3-channel output conv (forward 96->3, dx 3->96) is not among the
    # flagship's shapes, which the kernel phase checked: check what is new.
    conv_rows = check_conv_shapes({k: n for k, n in shapes.items() if k not in checked_conv}, seed=2000,
                                  site=f"{approach} trainer")
    checked_conv.update(shapes)
    expected = dict.fromkeys(WRAPPERS, 0)
    expected["conv3x3"] = ESTIMATOR_TRAIN_STEPS * sum(per_step)
    trained = run_trainer(f"{approach} float32 trainer, conv3x3_kernel", train, ESTIMATOR_TRAIN_STEPS, expected,
                          evals=0, restore=False)
    return sample, trained, agree, conv_rows


def run_unconditional():
    """The unconditional VE NCSN++ (`texture160_unconditional_ncsnpp`, nf=128,
    128px, FIR) at B=8, float32: the FIR kernels against their plain versions
    on a short sample; the recipe's sampler (reverse_diffusion + langevin)
    with the FIR launches counted exactly; ancestral_sampling and ald;
    `show_evolution`; `Trainer.fit` through `unpaired_PKLDataset`, whose
    FIR calls all carry a gradient and take the plain versions."""
    t = time.perf_counter()
    config = datasets_dir(texture160_unconditional_ncsnpp_config())
    model = init_model_random(config, seed=config.seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    sde, eps = build_sde(config)
    shape = (UNCOND_BATCH, config.data.image_size, config.data.image_size, 3)
    calls = forward_calls(config, UNCOND_BATCH)
    per_forward = per_name(calls)
    phase("setup", t, f"unconditional NCSN++: {n_params} parameters, VE sigma_max {sde.sigma_max:.4f},"
                      f" kernel calls per forward {dict(calls)}")
    if per_forward != PER_FORWARD_UNCOND_PATH:
        raise RuntimeError(f"unconditional NCSN++: kernel calls per forward {per_forward},"
                           f" expected {PER_FORWARD_UNCOND_PATH}")

    def sample(steps, **kw):
        fn = get_sampling_fn(config, sde, shape, eps, p_steps=steps, **kw)
        return lambda seed, **call: fn(torch.Generator(device="cuda").manual_seed(seed), model, **call)

    t = time.perf_counter()
    check_fir_sites(calls, "unconditional NCSN++", UNCOND_BATCH)
    for fn in WRAPPERS.values():
        fn.launches = 0
    got = sample(UNCOND_SHORT)(1)[0]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    expected = {name: PER_FORWARD_UNCOND_PATH.get(name, 0) * 2 * UNCOND_SHORT for name in WRAPPERS}
    with plain_versions():
        want = sample(UNCOND_SHORT)(1)[0]
    fir_agree = dict(path="float32 unconditional NCSN++ FIR kernels vs plain", tol=FIR_AGREE_TOL,
                     sample_rel_err=rel_err(got, want), launches=launches)
    ok = fir_agree["sample_rel_err"] <= FIR_AGREE_TOL and launches == expected
    phase("agreement", t, f"{fir_agree['path']}: {UNCOND_SHORT}-step sample rel err {fir_agree['sample_rel_err']:.3e}"
                          f" (tol {FIR_AGREE_TOL:.0e}), launches {launches} (expected {expected})"
                          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("unconditional NCSN++: the FIR kernels disagree with their plain versions, or the"
                           " compared sample did not launch them as counted")

    main_fn = sample(UNCOND_STEPS)
    result = run_sampler("float32 unconditional NCSN++ reverse_diffusion+langevin", lambda: main_fn(config.seed)[0],
                         per_forward, UNCOND_STEPS, shape=shape)

    t = time.perf_counter()
    others = {}
    for predictor, corrector in (("ancestral_sampling", "none"), ("reverse_diffusion", "ald")):
        x = sample(UNCOND_SHORT, predictor=predictor, corrector=corrector)(2)[0]
        others[f"{predictor}+{corrector}"] = bool(torch.isfinite(x).all()) and tuple(x.shape) == shape
    # the frames against a run of the same sampler and seed without them:
    # the last one is its final x; each step moves x
    frames = sample(UNCOND_EVOLUTION, denoise=False)(3, show_evolution=True)[1]["evolution"]
    x = sample(UNCOND_EVOLUTION, denoise=False)(3)[0]
    evolution = tuple(frames.shape)
    last_err = rel_err(frames[-1], x)
    steps_move = all(not torch.equal(frames[k], frames[k + 1]) for k in range(len(frames) - 1))
    ok = (all(others.values()) and evolution == (UNCOND_EVOLUTION, *shape) and last_err <= EVOLUTION_TOL
          and steps_move)
    phase("main", t, f"unconditional NCSN++ {UNCOND_SHORT}-step runs finite: {others}; show_evolution"
                     f" {evolution}, last frame against the final x of a run without frames: rel err"
                     f" {last_err:.3e} (tol {EVOLUTION_TOL:.0e}), consecutive frames differ: {steps_move}"
                     f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("unconditional NCSN++: a predictor or corrector run, or the evolution, is wrong")
    result.update(other_runs_finite=others, evolution_shape=list(evolution), evolution_last_rel_err=last_err,
                  evolution_steps_move=steps_move)
    del model

    train = datasets_dir(texture160_unconditional_ncsnpp_config())
    train.training.batch_size = UNCOND_BATCH
    train.training.log_freq, train.training.eval_freq, train.training.snapshot_freq = 1, 10**9, 10**9
    trained = run_trainer("float32 unconditional NCSN++ trainer", train, UNCOND_TRAIN_STEPS,
                          dict.fromkeys(WRAPPERS, 0), evals=0, restore=False)
    return result, trained, fir_agree


def run_vp(name):
    """DDPM++ (`cifar10_vp_config`, nf=128, 32px, no FIR) under a VP or sub-VP
    SDE at B=64: the recipe's sampler (euler_maruyama, no corrector), short
    ancestral_sampling and langevin runs, the Langevin step's alpha, one loss
    and backward; no kernel runs, so every counter reads 0."""
    t = time.perf_counter()
    config = cifar10_vp_config(name)
    model = init_model_random(config, seed=config.seed, device="cuda")
    sde, eps = build_sde(config)
    shape = (VP_BATCH, config.data.image_size, config.data.image_size, 3)
    per_forward = per_name(forward_calls(config, VP_BATCH))
    phase("setup", t, f"{name} DDPM++: {sum(p.numel() for p in model.parameters())} parameters, eps {eps},"
                      f" kernel calls per forward {per_forward}")
    if per_forward:
        raise RuntimeError(f"{name}: kernel calls per forward {per_forward}, expected none")

    def sample(steps, **kw):
        fn = get_sampling_fn(config, sde, shape, eps, p_steps=steps, **kw)
        return lambda seed: fn(torch.Generator(device="cuda").manual_seed(seed), model)[0]

    sample(WARMUP_STEPS)(0)  # so that the timed window holds no first call's cost
    main_fn = sample(VP_STEPS)
    result = run_sampler(f"float32 {name} DDPM++ euler_maruyama+none", lambda: main_fn(config.seed), {}, VP_STEPS,
                         shape=shape, evals_per_step=1)

    t = time.perf_counter()
    for fn in WRAPPERS.values():
        fn.launches = 0
    others = {}
    runs = [("euler_maruyama", "langevin")] + ([("ancestral_sampling", "none")] if name == "vpsde" else [])
    for predictor, corrector in runs:
        x = sample(VP_SHORT, predictor=predictor, corrector=corrector)(2)
        others[f"{predictor}+{corrector}"] = bool(torch.isfinite(x).all()) and tuple(x.shape) == shape
    if name != "vpsde":  # sub-VP has no ancestral step, in JAX neither
        try:
            sample(VP_SHORT, predictor="ancestral_sampling", corrector="none")(2)
            others["ancestral_sampling refused"] = False
        except NotImplementedError:
            others["ancestral_sampling refused"] = True

    # the Langevin step size carries alphas[timestep] under VP (1 under sub-VP)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(shape, generator=g, device="cuda")
    z = torch.randn(shape, generator=g, device="cuda")
    vec_t = torch.full((VP_BATCH,), 0.5, device="cuda")
    score = get_score_fn(sde, model, conditional=False, train=False, continuous=True)
    snr = config.sampling.snr
    _, x_mean = get_corrector("langevin")(lambda s: z, x, vec_t, sde=sde, score_fn=score, snr=snr, n_steps=1)
    grad = score(x, vec_t)
    alpha = sde.alphas(x.device)[int(0.5 * (sde.N - 1))] if isinstance(sde, VPSDE) else 1.0
    step = (snr * z.flatten(1).norm(dim=-1).mean() / grad.flatten(1).norm(dim=-1).mean()) ** 2 * 2 * alpha
    alpha_err = rel_err(x_mean - x, step * grad)

    model.train()
    loss = build_loss_fn(config, model, sde, train=True)(
        sde, torch.rand(shape, generator=g, device="cuda"), generator=g
    )
    loss.backward()
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters() if p.grad is not None)
    model.eval()
    torch.cuda.synchronize()
    launches = {name_: fn.launches for name_, fn in WRAPPERS.items()}
    ok = (all(others.values()) and alpha_err <= 1e-5 and math.isfinite(loss.item()) and grads_finite
          and not any(launches.values()))
    phase("main", t, f"{name} {VP_SHORT}-step runs: {others}; Langevin step with alpha"
                     f" {float(alpha):.6f}: rel err {alpha_err:.3e} (tol 1e-5); loss {loss.item():.5f}, gradients"
                     f" finite: {grads_finite}; launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: a run, the Langevin alpha, the loss, its gradients or the launches are wrong")
    result.update(other_runs=others, langevin_alpha=float(alpha), langevin_alpha_rel_err=alpha_err,
                  loss=loss.item(), grads_finite=grads_finite)
    return result


# ---- the multi-scale chains (--mode multi_scale_test) ----------------------


def chain_inputs(config, batch, device="meta"):
    """One scale's model inputs at the recipe's shapes: x and y from
    ``data.shape_x`` / ``shape_y`` (CHW), ddpm_KxSR's y at
    ``target_resolution / scale`` (its LQ image as it is)."""
    cx, hx, wx = config.data.shape_x
    cy, hy, wy = config.data.shape_y
    if config.model.name == "ddpm_KxSR":
        hy = wy = config.data.target_resolution // config.data.scale
    return {"x": torch.empty(batch, hx, wx, cx, device=device), "y": torch.empty(batch, hy, wy, cy, device=device)}


def chain_calls(master):
    """`forward_calls` of one forward of each scale of ``master``, by image
    size, at B=8."""
    return {int(c.data.image_size): forward_calls(c, BATCH, chain_inputs(c, BATCH))
            for c in multiscale.scale_configs(master)}


def chain_sites():
    """Kernels 1-3 sites of every chain's _block variant (the pyramid, the
    Haar and bicubic sequential chains) as `CHAIN_TAIL_SHAPES` and
    `CHAIN_BLOCK_SHAPES` list them, and each scale's calls per forward; the
    direct 8x sampler's against the flagship's.  Raises where one differs."""
    with tempfile.TemporaryDirectory() as data_dir:
        masters = {
            "pyramid": texture64_multiscale_master_block_config(),
            "haar": texture160_sequential_master_config("haar", block=True),
            "bicubic": texture160_sequential_master_config("bicubic", data_dir, block=True,
                                                           source_dir=os.path.join(REPO, "datasets")),
        }
        calls = {name: chain_calls(m) for name, m in masters.items()}
    union = collections.Counter()
    for name, by_size in calls.items():
        want = PYRAMID_PER_FORWARD if name == "pyramid" else SEQUENTIAL_PER_FORWARD
        for size, c in by_size.items():
            union.update(c)
            if per_name(c) != want:
                raise RuntimeError(f"{name} chain, scale {size}: kernel calls per forward {per_name(c)}, expected {want}")
    tails = set(sites(union, "gn_silu_conv3x3"))
    blocks = set(sites(union, "resblock_fused", "resblock_fused_split"))
    if tails != set(CHAIN_TAIL_SHAPES) or blocks != {tuple(b) for b in CHAIN_BLOCK_SHAPES}:
        raise RuntimeError(f"chain sites {sorted(tails)} {sorted(blocks)}, expected `CHAIN_TAIL_SHAPES`,"
                           " `CHAIN_BLOCK_SHAPES`")
    direct = texture160_direct_8x_block_config()
    if forward_calls(direct, BATCH, chain_inputs(direct, BATCH)) != flagship_block_path_calls():
        raise RuntimeError("direct 8x ddpm_KxSR: kernel calls per forward differ from the flagship's")
    return calls


def check_chain_sites():
    """Kernels 1-3 against plain at every chain site, with the DDPM's groups,
    float32 and bfloat16, with and without temb; checked, not timed (the
    paths' time is their sampler's)."""
    for h, c in CHAIN_TAIL_SHAPES:
        g = legacy_num_groups(c)
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (False, True):
                x, w, gamma, beta, bias, temb = tail_inputs(h, c, dtype, seed=h * c + 3)
                temb = temb if with_temb else None
                check_close(f"chain tail {BATCH}x{h}x{h}x{c} ({g} groups) {dname(dtype)} temb={with_temb}",
                            fused_tail.gn_silu_conv3x3(x, w, gamma, beta, g, bias=bias, temb=temb),
                            fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, g, bias=bias, temb=temb), dtype)
    for name, h, ca, cb, cout in CHAIN_BLOCK_SHAPES:
        g0, g1 = legacy_num_groups(ca + cb), legacy_num_groups(cout)
        label = f"chain {name} {BATCH}x{h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout} ({g0}/{g1} groups)"
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (True, False):
                x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb) + 3, with_temb=with_temb)
                kw.update(num_groups0=g0, num_groups1=g1)
                check_close(f"{label} {dname(dtype)} temb={with_temb}",
                            block_call(x, skip, kw), block_call(x, skip, kw, plain=True), dtype)


def random_chain_weights(master, directory, on=None):
    """Point each scale of ``master`` (and of ``on``, its _block twin) at an
    EMA file of seeded N(0, 0.02) weights (`init_model_random`, seeded by the
    scale's size), as a trained chain reads its checkpoints."""
    for config in multiscale.scale_configs(master):
        size = int(config.data.image_size)
        model = init_model_random(config, seed=size, device="cuda")
        config.model.checkpoint_path = save_ema(os.path.join(directory, f"scale_{size}.pt"), 0, model.state_dict())
        del model
    if on is not None:
        paths = {int(c.data.image_size): c.model.checkpoint_path for c in multiscale.scale_configs(master)}
        for config in multiscale.scale_configs(on):
            config.model.checkpoint_path = paths[int(config.data.image_size)]


def run_chain(label, master, steps, per_forward, cli_config=None, data_path=os.path.join(REPO, "datasets")):
    """One chain over test batch 0, with every kernel counter at 0 just
    before and read just after: ``steps`` per scale through
    `run_multi_scale_test`, or (``cli_config``, a recipe name or file)
    through ``main.py --mode multi_scale_test --data_path <data_path>``
    in-process, whose chain gets the same records and ``steps``.  Checks
    the launches (``per_forward[size]`` x ``steps`` summed over the scales,
    corrector none: one evaluation a step) and the final images' shape and
    values.  Returns (result, final images)."""
    records, out = [], {}
    with tempfile.TemporaryDirectory() as log_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in WRAPPERS.values():
            fn.launches = 0
        t = time.perf_counter()
        if cli_config is None:
            out["final"] = multiscale.run_multi_scale_test(master, log_dir, p_steps=steps, device="cuda",
                                                           scale_records=records)[0]
        else:
            real = multiscale.run_multi_scale_test

            def recorded(*args, **kwargs):
                out["final"] = real(*args, scale_records=records, **{**kwargs, "p_steps": steps})[0]

            multiscale.run_multi_scale_test = recorded
            try:
                cli.main(["--mode", "multi_scale_test", "--config", cli_config, "--log_path", log_dir,
                          "--data_path", data_path])
            finally:
                multiscale.run_multi_scale_test = real
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        with open(os.path.join(log_dir, "multi_scale", "metrics.json")) as f:
            metrics = json.load(f)
        files = sorted(os.listdir(os.path.join(log_dir, "multi_scale")))
    sizes = sorted(per_forward)
    expected = {name: sum(per_forward[s].get(name, 0) for s in sizes) * steps for name in WRAPPERS}
    final = out["final"]
    top = max(sizes)
    shape = (BATCH, top, top, 3)
    finite = bool(np.isfinite(final).all())
    scales = [dict(image_size=r["image_size"], seconds=r["seconds"], evaluations=r["evaluations"],
                   ms_per_score_eval=r["seconds"] / r["evaluations"] * 1e3) for r in records]
    result = dict(path=label, steps_per_scale=steps, wall_s=wall, scales=scales, launches=launches,
                  expected_launches=expected, metrics=metrics, files=files,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    phase("main", t, f"{label}: {steps} steps a scale, {wall:.3f} s wall; "
          + ", ".join(f"scale {r['image_size']}: {r['seconds']:.3f} s, {r['ms_per_score_eval']:.3f} ms per score"
                      " evaluation" for r in scales)
          + f"; final {final.shape} finite={finite}; psnr {metrics['mean_psnr']:.5f} ssim {metrics['mean_ssim']:.5f};"
          f" launches {launches} (expected {expected})")
    if tuple(final.shape) != shape or not finite:
        raise RuntimeError(f"{label}: final images are not finite or not shaped {shape}")
    if launches != expected:
        raise RuntimeError(f"{label}: launches {launches}, expected {expected}")
    if "pyramid_batch0.png" not in files or len([f for f in files if f.startswith("batch0_")]) != BATCH:
        raise RuntimeError(f"{label}: the chain wrote {files}")
    return result, final


def chain_agreement(label, on, off, per_forward):
    """The same chain with the kernels on (``on``) and off (``off``) over
    `PYRAMID_SHORT` steps a scale, the same draws (the master's seed): final
    images at `CHAIN_AGREE_TOL` of their largest magnitude; the kernels'
    launches exact on, none off."""
    t = time.perf_counter()
    got_r, got = run_chain(f"{label}, kernels on", on, PYRAMID_SHORT, per_forward)
    _, want = run_chain(f"{label}, kernels off", off, PYRAMID_SHORT, {s: {} for s in per_forward})
    err = float(np.abs(got - want).max() / np.abs(want).max())
    ok = err <= CHAIN_AGREE_TOL
    phase("agreement", t, f"{label}: {PYRAMID_SHORT}-step chain, kernels on vs off: final images rel err {err:.3e}"
                          f" (tol {CHAIN_AGREE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the chain with the kernels disagrees with the chain without")
    return dict(path=f"{label} chain, kernels on vs off", tol=CHAIN_AGREE_TOL, final_rel_err=err,
                launches=got_r["launches"])


def run_pyramid(calls):
    """The trained texture64 pyramid: ``main.py --mode multi_scale_test
    --config texture64_multiscale_master`` at 2000 steps a scale (kernels
    off, as JAX runs it), its batch-0 PSNR and SSIM in `PYRAMID_BAND` and its
    zero-detail control at JAX's; then its _block variant against it on a
    short chain."""
    per_forward = {s: per_name(c) for s, c in calls.items()}
    full, _ = run_chain("float32 trained texture64 Haar pyramid (--mode multi_scale_test)", None, PYRAMID_STEPS,
                        {s: {} for s in per_forward}, cli_config="texture64_multiscale_master")
    m = full["metrics"]
    mean = {k: float(np.mean(PYRAMID_JAX[k])) for k in ("psnr", "ssim")}
    inside = {k: PYRAMID_BAND[k][0] <= m[f"mean_{k}"] <= PYRAMID_BAND[k][1] for k in ("psnr", "ssim")}
    dc = {k: abs(m[f"dc_only_mean_{k}"] - PYRAMID_JAX[f"dc_only_{k}"]) / PYRAMID_JAX[f"dc_only_{k}"]
          for k in ("psnr", "ssim")}
    ok = all(inside.values()) and all(v <= DC_ONLY_TOL for v in dc.values())
    print(f"  pyramid batch 0: psnr {m['mean_psnr']:.5f} (JAX seeds 42-44 mean {mean['psnr']:.5f}, band"
          f" {PYRAMID_BAND['psnr']}), ssim {m['mean_ssim']:.5f} (JAX mean {mean['ssim']:.5f}, band"
          f" {PYRAMID_BAND['ssim']}); zero-detail control psnr {m['dc_only_mean_psnr']:.5f} ssim"
          f" {m['dc_only_mean_ssim']:.5f} (JAX's, rel err {max(dc.values()):.2e}, tol {DC_ONLY_TOL:.0e})"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"pyramid: batch-0 metrics {m} outside the band set from the JAX chain's spread")
    full.update(jax=PYRAMID_JAX, band=PYRAMID_BAND)
    agree = chain_agreement("float32 texture64 pyramid", texture64_multiscale_master_block_config(),
                            texture64_multiscale_master_config(), per_forward)
    return full, agree


def run_sequential(calls):
    """The celebA-HQ-160 sequential chains on texture160 (40 -> 80 -> 160,
    full width, random weights): the Haar chain's kernels on against off,
    then its _block variant timed over `CHAIN_STEPS` a scale; the bicubic
    chain (ddpm_2xSR) on per-scale files made from the test split, its
    _block variant over `BICUBIC_STEPS`."""
    datasets = os.path.join(REPO, "datasets")
    paths, agree = [], []
    with tempfile.TemporaryDirectory() as weights, tempfile.TemporaryDirectory() as data_dir:
        for space in ("haar", "bicubic"):
            base = datasets if space == "haar" else write_texture160_sequential_data(data_dir, datasets)
            on = texture160_sequential_master_config(space, base, block=True)
            off = texture160_sequential_master_config(space, base)
            os.makedirs(os.path.join(weights, space))
            random_chain_weights(off, os.path.join(weights, space), on)
            per_forward = {s: per_name(c) for s, c in calls[space].items()}
            if space == "haar":
                agree.append(chain_agreement("float32 texture160 sequential Haar", on, off, per_forward))
            steps = CHAIN_STEPS if space == "haar" else BICUBIC_STEPS
            result, _ = run_chain(f"float32 texture160 sequential {space} chain, fused_block+fused_tail", on, steps,
                                  per_forward)
            result["calls_per_forward"] = per_forward
            paths.append(result)
    return paths, agree


def run_direct_8x():
    """The direct 8x ddpm_KxSR sampler (nf 96, ch_mult (1,1,2,2,3,3)) on the
    first 8 texture160 test images, y their 20px bicubic LQ: kernels on
    against off (`agreement`), then `DIRECT8X_STEPS` with fused_block and
    fused_tail, counted exactly."""
    t = time.perf_counter()
    config = texture160_direct_8x_block_config()
    gt = load_pkl_images(os.path.join(REPO, "datasets", "texture160", "texture160-test.pklv4"))[:BATCH]
    batch = {k: torch.from_numpy(np.stack(v).astype(np.float32) / 255.0).cuda()
             for k, v in (("x", gt), ("y", bicubic_lq_images(gt, config.data.scale)))}
    model = init_model_random(config, seed=config.seed, device="cuda")
    sde, eps = sampler_sde(config)
    phase("setup", t, f"direct 8x ddpm_KxSR: x {tuple(batch['x'].shape)} y {tuple(batch['y'].shape)},"
                      f" {sum(p.numel() for p in model.parameters())} params")
    off = texture160_direct_8x_config()
    agree = agreement("float32 direct 8x ddpm_KxSR", config, off, model, batch, None, REL_TOL[torch.float32])
    score = score_fn(model, sde)
    sampler = pc_sampler(config, sde, eps, tuple(batch["x"].shape), p_steps=DIRECT8X_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(config.seed)
    sample = run_sampler("float32 direct 8x ddpm_KxSR, fused_block+fused_tail",
                         lambda: sampler(gen, score, batch["y"])[0], PER_FORWARD_BLOCK_PATH, DIRECT8X_STEPS,
                         shape=tuple(batch["x"].shape))
    return sample, agree



# ---- training as the CLI runs it: callbacks, the toy, the NCSN++ trainer --------


class RecordingWriter:
    """The trainer's writer, keeping the last image each tag got (CHW)."""

    def __init__(self, writer):
        self.writer, self.images = writer, {}

    def add_image(self, tag, img, step):
        self.images[tag] = np.asarray(img)
        self.writer.add_image(tag, img, step)

    def __getattr__(self, name):
        return getattr(self.writer, name)


def callback_failures_logged(log_path):
    """The ``callback_failures/*`` scalars and ``callback_errors.jsonl``
    lines a run under ``log_path`` wrote (each failure writes one of each)."""
    failures = [(t, v, s) for t, v, s in read_scalars(os.path.join(log_path, "scalars.jsonl"))
                if t.startswith("callback_failures/")]
    errors = os.path.join(log_path, "callback_errors.jsonl")
    if os.path.exists(errors):
        with open(errors) as f:
            failures += [json.loads(line) for line in f]
    return failures


def fire_callback(label, trainer, callback, step, expected):
    """``callback`` once through the trainer (a failure is counted there),
    every kernel counter at 0 just before and read just after; the
    launches must be ``expected`` and no callback may have failed."""
    writer = trainer.writer
    trainer.writer = recording = RecordingWriter(writer)
    torch.cuda.synchronize()
    for fn in WRAPPERS.values():
        fn.launches = 0
    t = time.perf_counter()
    try:
        trainer._run_callback(callback, step)
        torch.cuda.synchronize()
    finally:
        trainer.writer = writer
    wall = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    result = dict(path=label, wall_s=wall, launches=launches, expected_launches=expected,
                  callback_failures=dict(trainer.callback_failures))
    if trainer.callback_failures:
        raise RuntimeError(f"{label}: callback failures {trainer.callback_failures}")
    if launches != expected:
        raise RuntimeError(f"{label}: launches {launches}, expected {expected}")
    return result, recording.images


def run_toy():
    """The GaussianBubbles toy as the CLI trains it (``main.py --mode train
    --config toy_gaussian_bubbles`` in-process: 10,000 steps of B=256, the
    ``2D`` callback every 2,000 steps at its full 500 steps), then 4,000 PC
    samples from the last checkpoint's EMA, their metrics in `TOY_BAND`."""
    t = time.perf_counter()
    config = cli.load_config("toy_gaussian_bubbles")
    with tempfile.TemporaryDirectory() as log_path:
        for fn in WRAPPERS.values():
            fn.launches = 0
        cli.main(["--mode", "train", "--config", "toy_gaussian_bubbles", "--log_path", log_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        scalars = read_scalars(os.path.join(log_path, "scalars.jsonl"))
        failures = callback_failures_logged(log_path)
        viz = {int(f[:-4]): np.load(os.path.join(log_path, "samples_2d", f))
               for f in os.listdir(os.path.join(log_path, "samples_2d"))}
        step, weights = load_eval_weights(os.path.join(log_path, "checkpoints"))
    losses = [v for tag, v, _ in scalars if tag == "train_loss"]
    windows = [(s, v) for tag, v, s in scalars if tag == "ms_per_step"]
    model = create_model(config, "cuda")
    model.load_state_dict(weights)
    ts = time.perf_counter()
    samples, metrics = sample_toy(config, model, seed=config.seed)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - ts
    inside = {k: TOY_BAND[k][0] <= metrics[k] <= TOY_BAND[k][1] for k in TOY_BAND}
    ms = float(np.median([v for s, v in windows if s > config.training.log_freq]))
    result = dict(path="float32 GaussianBubbles FCN toy (--mode train)", steps=step, wall_s=wall,
                  ms_per_step_median=ms, ms_per_step_windows=windows, train_loss=losses, sample_s=sample_s,
                  metrics=metrics, jax=TOY_JAX, band=TOY_BAND, launches=launches,
                  callback_failures=failures, viz_steps=sorted(viz))
    ok = (step == config.training.n_iters and all(inside.values()) and not failures
          and sorted(viz) == list(range(2000, 10001, 2000))
          and all(v.shape == (512, 2) and np.isfinite(v).all() for v in viz.values())
          and np.isfinite(samples).all() and np.mean(losses[-10:]) < losses[0] * 0.7
          and launches == {name: 0 for name in WRAPPERS})
    phase("main", t,
          f"{result['path']}: {step} steps {wall:.3f} s wall, {ms:.4f} ms/step (median of the sustained windows"
          f" of {config.training.log_freq} steps), train_loss {losses[0]:.5f} -> {losses[-1]:.5f}; 2D callback at"
          f" {sorted(viz)}; 4,000 samples of 500 steps in {sample_s:.3f} s: mode_mass_maxdev"
          f" {metrics['mode_mass_maxdev']:.5f} (band {TOY_BAND['mode_mass_maxdev']}), energy_distance_vs_gt"
          f" {metrics['energy_distance_vs_gt']:.5f} (band {TOY_BAND['energy_distance_vs_gt']}), mode_mass"
          f" {metrics['mode_mass']}; callback failures {failures}; launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("toy: metrics outside the band from the JAX seeds' spread, a callback failed, or"
                           " the run is not what the recipe asks")
    return result


def run_paired_callback(per_forward_tail):
    """The ``paired`` callback of the texture64 recipe at full length (1000
    steps) once, from the committed EMA, on the first 8 images of the test
    split, with the harness's kernel knobs (float32, ``fused_tail``): the
    tail counted exactly, the sample column's PSNR against the ground-truth
    column in `PAIRED_BAND`."""
    config = texture64_sr_cmde_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    config.eval.loss_split = "test"  # the val split is not sent to the card
    config.model.fused_tail = True
    with tempfile.TemporaryDirectory() as log_path:
        trainer = Trainer(config, log_path)
        step, ema = load_eval_weights(texture64_sr_cmde_test_config().model.checkpoint_path)
        trainer.state.model.load_state_dict(ema)
        with torch.no_grad():
            for name, shadow in trainer.state.ema.params.items():
                shadow.copy_(ema[name])
        callback = callbacks.get_callbacks(config)[-1]
        steps = callbacks._viz_p_steps(config)
        expected = {name: 0 for name in WRAPPERS}
        expected["gn_silu_conv3x3"] = per_forward_tail * 2 * steps
        result, images = fire_callback("float32 paired callback, texture64 EMA", trainer, callback,
                                       config.training.visualization_freq, expected)
        files = os.listdir(os.path.join(log_path, "images", "paired_y_sample_gt"))
    size = config.data.image_size
    grid = np.transpose(images["paired_y_sample_gt"], (1, 2, 0))
    rows = [grid[r * size : (r + 1) * size] for r in range(grid.shape[0] // size)]
    sample = torch.from_numpy(np.stack([r[:, size : 2 * size] for r in rows]))
    gt = torch.from_numpy(np.stack([r[:, 2 * size :] for r in rows]))
    psnr = float(psnr_fn(sample, gt).mean())
    ok = len(rows) == PAIRED_IMAGES and PAIRED_BAND[0] <= psnr <= PAIRED_BAND[1] and files == [f"{config.training.visualization_freq}.png"]
    result.update(steps=steps, images=len(rows), psnr=psnr, band=PAIRED_BAND, jax=PAIRED_JAX, ema_step=step,
                  ms_per_score_eval=result["wall_s"] / (2 * steps) * 1e3)
    print(f"[main] {result['wall_s']:.3f} s {result['path']} (step {step}): {steps} steps, {len(rows)} images,"
          f" {result['ms_per_score_eval']:.3f} ms per score evaluation; psnr {psnr:.5f} (JAX seeds 1-3"
          f" {PAIRED_JAX}, band {PAIRED_BAND}); grid {grid.shape} -> {files}; launches {result['launches']}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"paired callback: psnr {psnr} outside {PAIRED_BAND}, or the grid is not what it should be")
    return result


def run_ncsnpp_trainer(per_forward_fir):
    """The DF2K direct 4x NCSN++ trainer at full width (B=16, float32, the
    texture160 train split with its LQ file written to a temp dir):
    `Trainer.fit(12)` with the profiler window on (steps 3-5), then a
    checkpoint restored exactly, the device split of the window with the
    plain FIR's share, and the ``KxSR`` callback once at 10 steps, its FIR
    launches counted and its grid held against the plain FIR's."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = texture160_kxsr_ncsnpp_train_config(os.path.join(tmp, "data"), os.path.join(REPO, "datasets"))
        config.training.log_freq = 1
        config.training.visualization_freq = 10**9  # fired once below, at its own step count
        log_path, profile_dir = os.path.join(tmp, "logs"), os.path.join(tmp, "profile")
        trainer = Trainer(config, log_path)
        w0 = trainer.model.unet.fourier.W.clone()
        ema0 = {n: p.clone() for n, p in trainer.state.ema.params.items()}
        os.environ["CSDT_PROFILE_DIR"], os.environ["CSDT_PROFILE_STEPS"] = profile_dir, str(PROFILE_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in WRAPPERS.values():
            fn.launches = 0
        ts = time.perf_counter()
        try:
            trainer.fit(max_steps=NCSNPP_TRAIN_STEPS)
        finally:
            del os.environ["CSDT_PROFILE_DIR"], os.environ["CSDT_PROFILE_STEPS"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        expected = {name: 0 for name in WRAPPERS}
        expected.update({k: v * NCSNPP_TRAIN_STEPS for k, v in NCSNPP_GRAD_FORWARD.items()})
        scalars = read_scalars(os.path.join(log_path, "scalars.jsonl"))
        traces = [f for f in os.listdir(profile_dir) if f.endswith(".json")]
        trace_mb = sum(os.path.getsize(os.path.join(profile_dir, f)) for f in traces) / 2**20
        first_clean = 2 + PROFILE_STEPS + 2  # the first 1-step window after the trace was written
        ms = [v for tag, v, s in scalars if tag == "ms_per_step" and s >= first_clean]
        losses = [v for tag, v, _ in scalars if tag == "train_loss"]
        norms = [v for tag, v, _ in scalars if tag == "grad_norm"]
        ema_moved = sum(int(not torch.equal(ema0[n], p)) for n, p in trainer.state.ema.params.items())
        w_same = torch.equal(trainer.model.unet.fourier.W, w0)
        again = Trainer(config, os.path.join(tmp, "restored"), checkpoint_path=trainer.ckpt.directory)
        a, b = trainer.state, again.state
        restored = (a.step == b.step == NCSNPP_TRAIN_STEPS and a.ema.num_updates == b.ema.num_updates
                    and all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
                    and all(torch.equal(x, y) for x, y in zip(a.model.buffers(), b.model.buffers()))
                    and all(torch.equal(a.ema.params[n], b.ema.params[n]) for n in a.ema.params)
                    and all(torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k])
                            for p, q in zip(a.model.parameters(), b.model.parameters())
                            for k in ("exp_avg", "exp_avg_sq", "step")))
        del again
        attribution = profiling.attribute(profile_dir)
        device_ms = profiling.device_ms(attribution) / trainer.profile_steps
        rows = [(r["name"], r["total_ps"] / 1e9 / trainer.profile_steps, r["occurrences"] / trainer.profile_steps)
                for r in attribution["top_ops"]]
        batch = to_device(next(trainer.datamodule.train_iterator()), trainer.device)
        with recording_upfirdn() as calls:
            trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        # kernel durations summed, as the step's device time is: CUDA events around the
        # calls read 1.7-2x this, idle gaps between autograd's small launches included
        fir_ms = plain_fir_ms(calls, kernel_ms, trainer.device)
        split = dict(step_split(trainer))
        ok = (all(math.isfinite(v) for v in losses + norms) and len(losses) == NCSNPP_TRAIN_STEPS and ema_moved
              and w_same and restored and traces and trace_mb > 0 and launches == expected
              and not trainer.callback_failures and not callback_failures_logged(log_path))
        result = dict(
            path="float32 NCSN++ DF2K direct 4x trainer", steps=NCSNPP_TRAIN_STEPS, batch=config.training.batch_size,
            wall_s=wall, ms_per_step_median=float(np.median(ms)), ms_per_step_windows=ms, peak_gib=peak,
            train_loss=losses, grad_norm=norms, ema_tensors_moved=ema_moved, fourier_w_unchanged=w_same,
            checkpoint_restored_exactly=restored, trace_files=traces, trace_mib=trace_mb,
            profile_steps=trainer.profile_steps, device_ms_per_step=device_ms,
            kernel_launches_per_step=profiling.kernel_launches(attribution) / trainer.profile_steps,
            families={k: v["ms"] / trainer.profile_steps for k, v in attribution["families"].items()},
            top_kernels=rows[:25],
            plain_fir_ms_per_step=fir_ms, plain_fir_calls_per_step=sum(calls.values()),
            plain_fir_share=fir_ms / device_ms, launches=launches, expected_launches=expected,
            callback_failures=dict(trainer.callback_failures), **split,
        )
        phase("main", t,
              f"{result['path']}: Trainer.fit({NCSNPP_TRAIN_STEPS}) B={result['batch']} {wall:.3f} s wall, median"
              f" {result['ms_per_step_median']:.3f} ms/step over steps {first_clean}-{NCSNPP_TRAIN_STEPS}, peak"
              f" {peak:.3f} GiB; train_loss {['%.3f' % v for v in losses[:3]]}...{losses[-1]:.3f}, grad_norm finite;"
              f" {ema_moved} EMA tensors moved; W unchanged {w_same}; checkpoint restored exactly {restored};"
              f" trace {traces} {trace_mb:.1f} MiB of steps 3-{2 + PROFILE_STEPS}: {device_ms:.3f} ms of device"
              f" time a step, {result['kernel_launches_per_step']:.0f} launches; plain FIR {fir_ms:.3f} ms a step"
              f" ({result['plain_fir_calls_per_step']} upfirdn2d calls), share {result['plain_fir_share']:.4f};"
              f" one step: forward+loss {split['forward_loss_ms']:.3f} ms, backward {split['backward_ms']:.3f} ms,"
              f" optimizer+EMA {split['optimizer_ema_ms']:.3f} ms; launches {launches} (expected {expected})"
              f" {'ok' if ok else 'FAIL'}")
        for name, kms, count in rows[:12]:
            print(f"    {kms:10.3f} ms {count:7.1f}x  {name[:100]}", flush=True)
        if not ok:
            raise RuntimeError("NCSN++ trainer: a check failed (losses, EMA, W, checkpoint, trace, launches or a"
                               " callback)")

        # the KxSR callback once, kernels on, then with the plain FIR on the same draws
        config.training.visualization_p_steps = KXSR_VIZ_STEPS
        callback = callbacks.get_callbacks(config)[-1]
        expected = {name: 0 for name in WRAPPERS}
        expected.update({k: v * 2 * KXSR_VIZ_STEPS for k, v in per_forward_fir.items()})
        viz, images = fire_callback("float32 KxSR callback, NCSN++", trainer, callback, 10**9, expected)
        with plain_versions():
            _, plain = fire_callback("float32 KxSR callback, NCSN++, plain FIR", trainer, callback, 10**9,
                                     {name: 0 for name in WRAPPERS})
        got, want = images["KxSR_samples"], plain["KxSR_samples"]
        err = float(np.abs(got - want).max())
        viz.update(steps=KXSR_VIZ_STEPS, grid=list(got.shape), max_abs_err_vs_plain=err)
        print(f"[main] {viz['wall_s']:.3f} s {viz['path']}: {KXSR_VIZ_STEPS} steps, grid {got.shape}, against the"
              f" plain FIR {err:.3e} (tol {KXSR_GRID_TOL:.0e}); launches {viz['launches']} (expected {expected})"
              f" {'ok' if err <= KXSR_GRID_TOL else 'FAIL'}", flush=True)
        if err > KXSR_GRID_TOL:
            raise RuntimeError(f"KxSR callback: the grid with the FIR kernels is {err} off the plain FIR's")
    return result, viz


# ---- the other samplers: the ODE, bits/dim, inpainting and colorization ----


def counted_forwards(model):
    """A counter of ``model``'s forwards (one a score evaluation) and its hook."""
    count = [0]
    return count, model.register_forward_pre_hook(lambda module, args: count.__setitem__(0, count[0] + 1))


def zero_launches():
    torch.cuda.synchronize()
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches():
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def expect_launches(label, launches, per_forward, evaluations):
    expected = {name: per_forward.get(name, 0) * evaluations for name in WRAPPERS}
    if launches != expected:
        raise RuntimeError(f"{label}: launches {launches}, expected {expected}")
    return expected


def gaussian_score(sde, mu, s):
    """The exact score of data N(mu, s^2) under a VE SDE."""

    def score(x, t):
        return -batch_mul(1.0 / (s**2 + sde.marginal_prob(x, t)[1] ** 2), x - mu)

    return score


def unconditional_setup():
    """The unconditional NCSN++ (B=8, 128px, seeded weights) and texture160
    test batch 0 resized to 128px by `unpaired_PKLDataset`."""
    config = datasets_dir(texture160_unconditional_ncsnpp_config())
    model = init_model_random(config, seed=config.seed, device="cuda")
    batch = torch.from_numpy(next(PKLDataModule(config).test_iterator(UNCOND_BATCH))).cuda()
    return config, model, batch


def run_ode():
    """Phase 19: the probability-flow ODE sampler."""
    t = time.perf_counter()
    mu, s, eps = 1.5, 0.5, 1e-4
    sde = VESDE(sigma_min=0.01, sigma_max=10.0, N=200)
    nfe = [0]
    exact = gaussian_score(sde, mu, s)

    def score(x, vec_t):
        nfe[0] += 1
        return exact(x, vec_t)

    z = torch.randn(ODE_ANALYTIC_SHAPE, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    z = z * sde.sigma_max
    samples, info = get_ode_sampler(sde, ODE_ANALYTIC_SHAPE, denoise=False, eps=eps)(None, score, z=z)
    # the flow of the exact score is x - mu = (z - mu) sqrt((s^2 + sigma(t)^2) / (s^2 + sigma_max^2)): the
    # zero-mean prior lands at mean mu (1 - r), std r sigma_max, 0.075 under JAX's target mean
    r = math.sqrt((s**2 + sde.sigma_min**2 * (sde.sigma_max / sde.sigma_min) ** (2 * eps)) / (s**2 + sde.sigma_max**2))
    flow = mu + (z - mu) * r
    flow_err = rel_err(samples, flow)
    mean, std = samples.mean().item(), samples.std().item()
    analytic = dict(nfe=nfe[0], mean=mean, std=std, flow_rel_err=flow_err, flow_mean=mu * (1 - r),
                    flow_std=r * sde.sigma_max, info=info)
    ok = (flow_err <= ODE_AGREE_TOL and abs(mean - mu * (1 - r)) < ODE_ANALYTIC_TOL
          and abs(std - r * sde.sigma_max) < ODE_ANALYTIC_TOL and info == {"nfe": -1})
    phase("main", t, f"ODE sampler, exact score of N({mu}, {s}^2), 2048 x 1: against the exact flow of each prior"
                     f" draw rel err {flow_err:.3e} (tol {ODE_AGREE_TOL:.0e}); mean {mean:.5f} std {std:.5f}, the"
                     f" flow's {mu * (1 - r):.5f} / {r * sde.sigma_max:.5f} (tol {ODE_ANALYTIC_TOL}; JAX's test"
                     f" holds them against {mu} / {s}); {nfe[0]} score evaluations {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("ODE sampler: the analytic Gaussian's flow is not recovered")

    t = time.perf_counter()
    config, model, _ = unconditional_setup()
    config.sampling.method = "ode"
    sde, eps = build_sde(config)
    shape = (UNCOND_BATCH, config.data.image_size, config.data.image_size, 3)
    fn = get_sampling_fn(config, sde, shape, eps)
    count, hook = counted_forwards(model)
    runs = {}
    for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_versions)):
        count[0] = 0
        zero_launches()
        start = time.perf_counter()
        with ctx():
            x, info = fn(torch.Generator(device="cuda").manual_seed(config.seed), model)
        torch.cuda.synchronize()
        runs[label] = dict(x=x, nfe=count[0], seconds=time.perf_counter() - start, launches=read_launches(),
                           info=info)
    hook.remove()
    on, off = runs["kernels"], runs["plain"]
    expected = expect_launches("ODE sampler", on["launches"], PER_FORWARD_UNCOND_PATH, on["nfe"])
    if any(off["launches"].values()):
        raise RuntimeError(f"ODE sampler with the plain FIR: launches {off['launches']}")
    same_steps = on["nfe"] == off["nfe"]
    err = rel_err(on["x"], off["x"]) if same_steps else norm_rel_err(on["x"], off["x"])
    tol = ODE_AGREE_TOL if same_steps else ODE_NORM_TOL
    finite = bool(torch.isfinite(on["x"]).all()) and tuple(on["x"].shape) == shape
    ms = on["seconds"] / on["nfe"] * 1e3
    result = dict(path="float32 unconditional NCSN++ probability-flow ODE", nfe=on["nfe"], nfe_plain=off["nfe"],
                  wall_s=on["seconds"], wall_s_plain=off["seconds"], ms_per_score_eval=ms,
                  ms_per_score_eval_plain=off["seconds"] / off["nfe"] * 1e3, same_steps=same_steps,
                  agreement="max abs / max" if same_steps else "norm", rel_err=err, tol=tol,
                  launches=on["launches"], analytic=analytic)
    ok = finite and err <= tol and on["info"] == {"nfe": -1}
    phase("main", t, f"ODE sampler, unconditional NCSN++ B={UNCOND_BATCH} 128px: {on['nfe']} score evaluations"
                     f" ({off['nfe']} with the plain FIR), {on['seconds']:.3f} s, {ms:.3f} ms per evaluation"
                     f" ({result['ms_per_score_eval_plain']:.3f} plain); samples finite={finite} range"
                     f" [{on['x'].min().item():.3f}, {on['x'].max().item():.3f}]; against the plain FIR"
                     f" ({result['agreement']}, same steps: {same_steps}) rel err {err:.3e} (tol {tol:.0e});"
                     f" launches {on['launches']} (expected {expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("ODE sampler: the samples are wrong or disagree with the plain FIR's")
    return result


def run_bpd():
    """Phase 20: bits/dim through the likelihood ODE."""
    t = time.perf_counter()
    sde = VESDE(sigma_min=0.01, sigma_max=10.0, N=200)
    data = torch.randn(512, 2, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    bpd, z, _ = get_likelihood_fn(sde, eps=1e-5)(
        torch.Generator(device="cuda").manual_seed(1), gaussian_score(sde, 0.0, 1.0), data
    )
    analytic = 0.5 * math.log2(2 * math.pi * math.e) + 8.0
    err = abs(bpd.mean().item() - analytic)
    ok = err < 0.1 and bool(torch.isfinite(z).all())
    phase("main", t, f"likelihood, exact score of N(0, 1), 512 x 2: bpd {bpd.mean().item():.5f} against"
                     f" {analytic:.5f} (tol 0.1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("likelihood: the analytic bpd is not recovered")

    t = time.perf_counter()
    config, model, _ = unconditional_setup()
    config.eval.batch_size = BPD_BATCH
    sde, _ = build_sde(config)
    seen = []
    real = bpd_eval.get_likelihood_fn

    def recording(*args, **kwargs):
        fn = real(*args, **kwargs)

        def likelihood_fn(*a, **k):
            out = fn(*a, **k)
            seen.append(out)
            return out

        return likelihood_fn

    count, hook = counted_forwards(model)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    bpd_eval.get_likelihood_fn = recording
    try:
        start = time.perf_counter()
        mean_bpd = bpd_eval.evaluate_bpd(config, model, PKLDataModule(config), max_batches=BPD_MAX_BATCHES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        bpd_eval.get_likelihood_fn = real
        hook.remove()
    launches = read_launches()
    bpd, z, _ = seen[0]
    finite = math.isfinite(mean_bpd) and bool(torch.isfinite(bpd).all()) and bool(torch.isfinite(z).all())

    # the reverse-mode divergence against forward mode, both on the plain path
    x = torch.from_numpy(next(PKLDataModule(config).test_iterator(BPD_BATCH))).cuda()
    probe = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    rsde = sde.reverse(get_score_fn(sde, model, continuous=True), probability_flow=True)
    vec = torch.tensor(0.5, device="cuda")

    def drift_fn(xx, tt):
        return rsde.sde(xx, tt.expand(xx.shape[0]))[0]

    with plain_versions():
        div = get_div_fn(drift_fn)(x, vec, probe)
        _, jvp = torch.func.jvp(lambda xx: drift_fn(xx, vec), (x,), (probe,))
    want = torch.sum(jvp * probe, dim=(1, 2, 3))
    div_err = rel_err(div, want)
    peak = torch.cuda.max_memory_allocated() / 2**30
    result = dict(path="float32 unconditional NCSN++ evaluate_bpd", bpd=mean_bpd, bpd_per_image=bpd.tolist(),
                  nfe=count[0], wall_s=seconds, ms_per_score_eval=seconds / count[0] * 1e3, peak_gib=peak,
                  launches=launches, div_vs_jvp_rel_err=div_err, cuts=dict(eval_batch=BPD_BATCH,
                                                                           max_batches=BPD_MAX_BATCHES))
    ok = finite and not any(launches.values()) and div_err <= DIV_JVP_TOL
    phase("main", t, f"evaluate_bpd, unconditional NCSN++, texture160 test split at 128px, {BPD_MAX_BATCHES}"
                     f" batch of {BPD_BATCH} (cut from 8 batches of the recipe's eval batch): bpd {mean_bpd:.5f}"
                     f" ({', '.join(f'{v:.5f}' for v in bpd.tolist())}), z finite {finite}; {count[0]} score"
                     f" evaluations (each with its backward), {seconds:.3f} s, peak {peak:.3f} GiB; launches"
                     f" {launches} (every FIR call carries a gradient: all 0); reverse-mode divergence against"
                     f" torch.func.jvp at t=0.5: rel err {div_err:.3e} (tol {DIV_JVP_TOL:.0e})"
                     f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("evaluate_bpd: a value is not finite, a kernel launched, or the divergence is wrong")
    del model

    t = time.perf_counter()
    on, off = texture64_haar_multiscale_unconditional_block_config(), texture64_haar_multiscale_unconditional_config()
    model_on = init_model_random(on, seed=on.seed, device="cuda")
    model_off = create_model(off, "cuda")
    model_off.load_state_dict(model_on.state_dict())
    sde, _ = build_sde(on)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(BPD_BATCH, 32, 32, 12, generator=g, device="cuda") * 10.0
    probe = torch.randn(x.shape, generator=g, device="cuda")
    divs = {}
    for label, m in (("on", model_on), ("off", model_off)):
        rsde = sde.reverse(get_score_fn(sde, m, continuous=True), probability_flow=True)
        zero_launches()
        divs[label] = get_div_fn(lambda xx, tt: rsde.sde(xx, tt.expand(xx.shape[0]))[0])(x, vec, probe)
        divs[label + "_launches"] = read_launches()
    knobs_err = rel_err(divs["on"], divs["off"])
    ok = not any(divs["on_launches"].values()) and knobs_err <= DIV_KNOBS_TOL
    phase("main", t, f"divergence of the texture64 Haar DDPM (fused_block, fused_tail, eval) B={BPD_BATCH}:"
                     f" launches {divs['on_launches']} (a gradient takes the plain versions: all 0), against the"
                     f" knobs off rel err {knobs_err:.3e} (tol {DIV_KNOBS_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("Haar DDPM divergence: a kernel launched under a gradient, or the value differs")
    result.update(haar_div_launches=divs["on_launches"], haar_div_knobs_rel_err=knobs_err)
    return result


def haar_sites(config):
    """Kernels 1-3 sites of one forward of ``config``'s Haar DDPM (32x32x12
    coefficients, B=8): `forward_calls` by kernel and shape."""
    x = torch.empty(BATCH, 32, 32, 12, device="meta")
    return forward_calls(config, BATCH, x)


def check_haar_sites(calls):
    """Kernels 1-3 against plain at each site of the Haar DDPM that no
    earlier phase checked at B=8 with the DDPM's groups, float32 and
    bfloat16, with and without temb; returns the sites checked."""
    done_tails = set(CHAIN_TAIL_SHAPES)
    done_blocks = {tuple(b) for b in CHAIN_BLOCK_SHAPES}
    tails = sorted(k for k in sites(calls, "gn_silu_conv3x3") if k not in done_tails)
    blocks = sorted(k for k in sites(calls, "resblock_fused", "resblock_fused_split") if k not in done_blocks)
    for h, c in tails:
        g = legacy_num_groups(c)
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (False, True):
                x, w, gamma, beta, bias, temb = tail_inputs(h, c, dtype, seed=h * c + 5)
                temb = temb if with_temb else None
                check_close(f"Haar DDPM tail {BATCH}x{h}x{h}x{c} ({g} groups) {dname(dtype)} temb={with_temb}",
                            fused_tail.gn_silu_conv3x3(x, w, gamma, beta, g, bias=bias, temb=temb),
                            fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, g, bias=bias, temb=temb), dtype)
    for name, h, ca, cb, cout in blocks:
        g0, g1 = legacy_num_groups(ca + cb), legacy_num_groups(cout)
        label = f"Haar DDPM {name} {BATCH}x{h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout} ({g0}/{g1} groups)"
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (True, False):
                x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb) + 5, with_temb=with_temb)
                kw.update(num_groups0=g0, num_groups1=g1)
                check_close(f"{label} {dname(dtype)} temb={with_temb}",
                            block_call(x, skip, kw), block_call(x, skip, kw, plain=True), dtype)
    return tails, blocks


def evaluations_per_step(config):
    """Score evaluations of one PC step: the corrector's and the predictor's."""
    s = config.sampling
    return (s.n_steps_each if s.corrector.lower() != "none" else 0) + (s.predictor.lower() != "none")


def run_projected():
    """Phase 21: inpainting and colorization."""
    t = time.perf_counter()
    config, model, batch = unconditional_setup()
    config.model.num_scales = PROJECTED_STEPS
    sde, eps = build_sde(config)
    evals = evaluations_per_step(config) * PROJECTED_STEPS
    mask = torch.from_numpy(random_square_mask(tuple(batch.shape), MASK_COVERAGE,
                                               np.random.default_rng(config.seed))).cuda()
    zero_launches()
    start = time.perf_counter()
    out, _ = get_inpainting_fn(config, sde, eps)(torch.Generator(device="cuda").manual_seed(1), model, batch, mask)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    expected = expect_launches("inpainter", launches, PER_FORWARD_UNCOND_PATH, evals)
    known = mask.expand_as(batch).bool()
    known_err = (out[known] - batch[known]).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    inpaint = dict(path="float32 unconditional NCSN++ PC inpainter", steps=PROJECTED_STEPS, wall_s=seconds,
                   ms_per_score_eval=seconds / evals * 1e3, known_max_abs_err=known_err, launches=launches)
    ok = finite and known_err <= KNOWN_TOL
    phase("main", t, f"inpainter, unconditional NCSN++ B={UNCOND_BATCH} 128px, square mask coverage"
                     f" {MASK_COVERAGE}, {PROJECTED_STEPS} steps (cut from 1000): {seconds:.3f} s,"
                     f" {inpaint['ms_per_score_eval']:.3f} ms per evaluation; finite {finite}; known pixels against"
                     f" the data max abs err {known_err:.3e} (tol {KNOWN_TOL:.0e}); launches {launches}"
                     f" (expected {expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("inpainter: the known pixels moved or the samples are not finite")

    t = time.perf_counter()
    gray = torch.from_numpy(np.repeat(grayscale(batch.cpu().numpy()), 3, axis=-1)).cuda()
    colorizer = get_pc_colorizer(sde, "reverse_diffusion", "langevin", snr=0.15, eps=eps)
    zero_launches()
    start = time.perf_counter()
    rgb, _ = colorizer(torch.Generator(device="cuda").manual_seed(2), get_score_fn(sde, model, continuous=True), gray)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    expected = expect_launches("colorizer", launches, PER_FORWARD_UNCOND_PATH, 2 * PROJECTED_STEPS)
    gray_err = (decouple(rgb)[..., 0] - decouple(gray)[..., 0]).abs().max().item()
    scale = rgb.abs().max().item()
    finite = bool(torch.isfinite(rgb).all())
    colorize = dict(path="float32 unconditional NCSN++ PC colorizer", steps=PROJECTED_STEPS, wall_s=seconds,
                    ms_per_score_eval=seconds / (2 * PROJECTED_STEPS) * 1e3, gray_max_abs_err=gray_err,
                    scale=scale, launches=launches)
    ok = finite and gray_err <= GRAY_TOL * scale
    phase("main", t, f"colorizer (reverse_diffusion + langevin, snr 0.15), the same model and batch in"
                     f" grayscale, {PROJECTED_STEPS} steps: {seconds:.3f} s, {colorize['ms_per_score_eval']:.3f} ms"
                     f" per evaluation; finite {finite}; gray channel against the input's max abs err"
                     f" {gray_err:.3e} (tol {GRAY_TOL:.0e} of the output's largest magnitude, {scale:.3f});"
                     f" launches {launches} (expected {expected})"
                     f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("colorizer: the gray channel moved or the samples are not finite")
    del model

    # inpaint_hf on the Haar DDPM with kernels 1-3
    t = time.perf_counter()
    on, off = texture64_haar_multiscale_unconditional_block_config(), texture64_haar_multiscale_unconditional_config()
    calls = haar_sites(on)
    per_forward = per_name(calls)
    tails, blocks = check_haar_sites(calls)
    phase("kernel", t, f"texture64 Haar DDPM: kernel calls per forward {dict(calls)}; kernels 1-3 against plain at"
                       f" its {len(tails)} tail and {len(blocks)} block sites no earlier phase checked")
    t = time.perf_counter()
    t64 = datasets_dir(texture64_sr_cmde_test_config())
    images = next(PKLDataModule(t64).test_iterator(BATCH))["x"]
    dc = haar_forward(torch.from_numpy(images).cuda())[..., :3].contiguous()
    model_on = init_model_random(on, seed=on.seed, device="cuda")
    model_off = create_model(off, "cuda")
    model_off.load_state_dict(model_on.state_dict())
    per_step = evaluations_per_step(on)
    outs = {}
    for label, config, m in (("on", on, model_on), ("off", off, model_off)):
        config.model.num_scales = PYRAMID_SHORT
        zero_launches()
        with torch.no_grad():
            outs[label] = create_task(config, m).inpaint_hf(torch.Generator(device="cuda").manual_seed(3), m, dc)[0]
        outs[label + "_launches"] = read_launches()
    expect_launches("inpaint_hf, kernels on", outs["on_launches"], per_forward, per_step * PYRAMID_SHORT)
    expect_launches("inpaint_hf, kernels off", outs["off_launches"], {}, 0)
    agree_err = rel_err(outs["on"], outs["off"])
    agree = dict(path="float32 texture64 Haar DDPM inpaint_hf, kernels 1-3 on vs off", tol=CHAIN_AGREE_TOL,
                 sample_rel_err=agree_err, launches=outs["on_launches"])
    phase("agreement", t, f"{agree['path']}: {PYRAMID_SHORT}-step rel err {agree_err:.3e} (tol"
                          f" {CHAIN_AGREE_TOL:.0e}), launches {outs['on_launches']}"
                          f" {'ok' if agree_err <= CHAIN_AGREE_TOL else 'FAIL'}")
    if agree_err > CHAIN_AGREE_TOL:
        raise RuntimeError("inpaint_hf: kernels 1-3 disagree with the unfused path")

    t = time.perf_counter()
    on.model.num_scales = PROJECTED_STEPS
    zero_launches()
    start = time.perf_counter()
    with torch.no_grad():
        coeffs, _ = create_task(on, model_on).inpaint_hf(torch.Generator(device="cuda").manual_seed(4), model_on, dc)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    evals = per_step * PROJECTED_STEPS
    expected = expect_launches("inpaint_hf", launches, per_forward, evals)
    dc_err = (coeffs[..., :3] - dc).abs().max().item()
    finite = bool(torch.isfinite(coeffs).all()) and tuple(coeffs.shape) == (BATCH, 32, 32, 12)
    hf = dict(path="float32 texture64 Haar DDPM inpaint_hf, fused_block + fused_tail", steps=PROJECTED_STEPS,
              wall_s=seconds, ms_per_score_eval=seconds / evals * 1e3, dc_max_abs_err=dc_err, launches=launches,
              per_forward=per_forward)
    ok = finite and dc_err <= DC_TOL
    phase("main", t, f"inpaint_hf, texture64 Haar DDPM B={BATCH} (32x32x12), DC band of test batch 0,"
                     f" {PROJECTED_STEPS} steps: {seconds:.3f} s, {hf['ms_per_score_eval']:.3f} ms per evaluation;"
                     f" finite {finite}; DC against the input max abs err {dc_err:.3e} (tol {DC_TOL:.0e});"
                     f" launches {launches} (expected {expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("inpaint_hf: the DC band moved or the coefficients are wrong")
    return [inpaint, colorize, hf], agree


# ---- the paper's other inverse problems -----------------------------------------


def twin_inputs(config, device, batch=BATCH):
    """Empty ``{'x', 'y'}`` of a twin's shapes, channels last."""
    d = config.data
    shape = lambda s: (batch, *s[1:], s[0])  # noqa: E731
    return {"x": torch.empty(shape(d.shape_x), device=device), "y": torch.empty(shape(d.shape_y), device=device)}


def twin_batch(config, batch=BATCH):
    """The twin's first test batch of ``batch`` on the card, x and y."""
    dm = create_datamodule(config)
    dm.setup()
    host = next(dm.test_iterator(batch))
    return {k: torch.from_numpy(host[k]).cuda() for k in ("x", "y")}


def earlier_sites():
    """Sites of kernels 1-3 an earlier phase checked at B=8 with 32 groups."""
    done = {("gn_silu_conv3x3", h, c) for h, c, *_ in TAIL_SHAPES}
    done |= {("gn_silu_conv3x3", h, c) for h, c in NCSNPP_TAIL_SHAPES + CHAIN_TAIL_SHAPES}
    done |= {tuple(b[:5]) for b in BLOCK_SHAPES + CHAIN_BLOCK_SHAPES}
    done |= set(haar_sites(texture64_haar_multiscale_unconditional_block_config()))
    return done


def check_inverse_sites(new, site="inverse problems"):
    """Kernels 1-3 against plain at each site in ``new`` (B=8, the DDPM's
    groups: 32 at every such width), float32 (1e-4) and bfloat16 (2e-2),
    with and without temb; each timed once in float32, the twins' type,
    beside its plain version, the library yardstick and the bound.  Returns
    per-site rows labelled ``site``."""
    rows = []
    for key in sorted(new):
        name, h, *chans = key
        if name == "gn_silu_conv3x3":
            (c,) = chans
            groups = legacy_num_groups(c)
            for dtype in (torch.float32, torch.bfloat16):
                for with_temb in (False, True):
                    x, w, gamma, beta, bias, temb = tail_inputs(h, c, dtype, seed=h * c + 7)
                    temb = temb if with_temb else None
                    err = check_close(
                        f"{site} tail {BATCH}x{h}x{h}x{c} {dname(dtype)} temb={with_temb}",
                        fused_tail.gn_silu_conv3x3(x, w, gamma, beta, groups, bias=bias, temb=temb),
                        fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, groups, bias=bias, temb=temb), dtype,
                    )
                    if dtype != torch.float32 or with_temb:
                        continue
                    flops, nbytes = tail_work(h, c, dtype)
                    bound_ms, bound_by = bound(flops, nbytes, dtype)
                    row = dict(
                        shape=f"{BATCH}x{h}x{h}x{c}", dtype=dname(dtype), site=site, max_abs_err=err,
                        gflop=flops / 1e9, bound_ms=bound_ms, bound_by=bound_by,
                        ms=time_ms(lambda: fused_tail.gn_silu_conv3x3(x, w, gamma, beta, groups, bias=bias)),
                        plain_ms=time_ms(
                            lambda: fused_tail.gn_silu_conv3x3_plain(x, w, gamma, beta, groups, bias=bias)),
                        library_ms=time_ms(lambda: conv3x3_nhwc(x, w, bias)),
                    )
                    print(f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cuDNN conv only"
                          f" {row['library_ms']:.4f} ms{ratio(row)}, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
                    rows.append(row)
            continue
        ca, cb, cout = chans
        label = f"{site} {name} {BATCH}x{h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}"
        for dtype in (torch.float32, torch.bfloat16):
            for with_temb in (True, False):
                x, skip, kw = block_inputs(h, ca, cb, cout, dtype, seed=h * (ca + cb) + 7, with_temb=with_temb)
                kw.update(num_groups0=legacy_num_groups(ca + cb), num_groups1=legacy_num_groups(cout))
                err = check_close(f"{label} {dname(dtype)} temb={with_temb}",
                                  block_call(x, skip, kw), block_call(x, skip, kw, plain=True), dtype)
                if dtype != torch.float32 or not with_temb:
                    continue
                flops, nbytes = block_work(h, ca, cb, cout, dtype)
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                xin = x if skip is None else torch.cat([x, skip], dim=-1)
                ws = kw["shortcut_w"]

                def library():  # no single PyTorch call computes the block
                    conv3x3_nhwc(conv3x3_nhwc(xin, kw["w0"]), kw["w1"])
                    if ws is not None:
                        torch.matmul(xin, ws)

                row = dict(
                    kernel=name, shape=f"{BATCH}x{h}x{h}x{ca}" + (f"+{cb}" if cb else "") + f"->{cout}",
                    dtype=dname(dtype), site=site, max_abs_err=err, gflop=flops / 1e9,
                    bound_ms=bound_ms, bound_by=bound_by,
                    ms=time_ms(lambda: block_call(x, skip, kw)),
                    plain_ms=time_ms(lambda: block_call(x, skip, kw, plain=True)),
                    library_ms=time_ms(library),
                )
                print(f"    time: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cuDNN convs + matmul"
                      f" {row['library_ms']:.4f} ms{ratio(row)}, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
                rows.append(row)
    return rows


def run_inverse_harness(per_forward, directory):
    """`run_test` on the inpainting _block twin (test batch 0 of 25, draws
    1 and 2, `INVERSE_HARNESS_STEPS`) from seeded random weights, then the
    pipeline (``--mode evaluation_pipeline``'s function) on the tree it
    wrote: its masks, re-rolled from the PNG numbers, must be the harness
    batch's."""
    config = datasets_dir(texture160_inpainting_cmde_block_config())
    config.eval.base_log_dir = os.path.join(directory, "evaluation")
    config.eval.draws = list(INVERSE_HARNESS_DRAWS)
    config.eval.p_steps = INVERSE_HARNESS_STEPS
    model = init_model_random(config, seed=config.seed, device="cuda")
    config.model.checkpoint_path = save_ema(os.path.join(directory, "inpainting_ema.pt"), 0, model.state_dict())
    del model
    records = []
    zero_launches()
    t = time.perf_counter()
    results = run_test(config, device="cuda", draw_records=records)
    wall = time.perf_counter() - t
    launches = read_launches()
    evaluations = 2 * INVERSE_HARNESS_STEPS * len(config.eval.draws)
    expected = expect_launches("inpainting harness", launches, per_forward, evaluations)
    means = {m: v[0] for m, v in results[0.15].items()}
    ok = sorted(means) == ["consistency", "diversity", "psnr", "ssim"] and all(math.isfinite(v) for v in means.values())
    result = dict(path="float32 --mode test harness, inpainting _block twin", steps=INVERSE_HARNESS_STEPS,
                  batch=config.eval.batch_size, wall_s=wall, seconds_per_draw=[r["seconds"] for r in records],
                  ms_per_score_eval=[r["seconds"] / (2 * INVERSE_HARNESS_STEPS) * 1e3 for r in records],
                  means=means, launches=launches)
    phase("main", t, f"{result['path']}: test batch 0 of {result['batch']}, draws {config.eval.draws},"
                     f" {INVERSE_HARNESS_STEPS} steps: " + ", ".join(f"{m} {v:.5f}" for m, v in sorted(means.items()))
          + f"; {wall:.3f} s wall, ms per score evaluation {['%.3f' % v for v in result['ms_per_score_eval']]};"
          f" launches {launches} (expected {expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"inpainting harness: metrics {means} missing or not finite")

    t = time.perf_counter()
    rerolled, real = [], eval_pipeline.random_square_mask

    def recording(*args, **kwargs):
        rerolled.append(real(*args, **kwargs))
        return rerolled[-1]

    eval_pipeline.random_square_mask = recording
    try:
        pipe = cli.evaluation_pipeline(config, device="cuda")[0.15]
    finally:
        eval_pipeline.random_square_mask = real
    dm = create_datamodule(config)
    dm.setup()
    harness_mask = next(dm.test_iterator())["mask"]
    same = len(rerolled) == 1 and np.array_equal(rerolled[0], harness_mask)
    entries = [v for d in pipe["per_draw"].values() for v in d.values()] + [pipe["diversity"]]
    ok = same and pipe["n_images"] == config.eval.batch_size and all(math.isfinite(v) for v in entries)
    result["pipeline"] = dict(per_draw=pipe["per_draw"], diversity=pipe["diversity"], skipped=pipe["skipped"],
                              masks_equal=same)
    phase("main", t, "evaluation pipeline on the inpainting tree: " + ", ".join(
        f"{k} psnr {v['psnr']:.4f} ssim {v['ssim']:.5f} consistency {v['consistency']:.4f}"
        for k, v in sorted(pipe["per_draw"].items())) + f", diversity {pipe['diversity']:.6f}; masks re-rolled"
          f" from the PNG numbers equal the harness batch's: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("inpainting pipeline: masks re-rolled wrong or metrics not finite")
    return result


def run_paired3d(config, directory):
    """The ``paired3D`` callback once on the 3-D twin's EMA (seeded random
    weights) at its own 100 steps: 2 validation volumes, finite frames and
    ``val_rec_loss_pc``; no kernel launches."""
    with tempfile.TemporaryDirectory(dir=directory) as log_path:
        config = copy.deepcopy(config)
        config.training.visualization_freq = PAIRED3D_STEPS
        trainer = Trainer(config, log_path)
        model = init_model_random(config, seed=config.seed, device="cuda")
        with torch.no_grad():
            for name, shadow in trainer.state.ema.params.items():
                shadow.copy_(model.state_dict()[name])
        del model
        callback = callbacks.get_callbacks(config)[-1]
        result, images = fire_callback("float32 paired3D callback, MRI->PET 3-D twin", trainer, callback,
                                       PAIRED3D_STEPS, {name: 0 for name in WRAPPERS})
        rec = [v for tag, v, _ in read_scalars(os.path.join(log_path, "scalars.jsonl")) if tag == "val_rec_loss_pc"]
    names = ("axial", "coronal", "sagittal")
    tags = [f"paired3D_{n}" for n in names] + [f"paired_video_dim_{n}/filmstrip" for n in names]
    ok = len(rec) == 1 and math.isfinite(rec[0]) and sorted(images) == sorted(tags)
    ok = ok and all(np.isfinite(images[k]).all() for k in images)
    result.update(steps=PAIRED3D_STEPS, val_rec_loss_pc=rec, frames={k: list(v.shape) for k, v in images.items()},
                  ms_per_score_eval=result["wall_s"] / (2 * PAIRED3D_STEPS) * 1e3)
    print(f"[main] {result['wall_s']:.3f} s {result['path']}: {PAIRED3D_STEPS} steps on 2 volumes"
          f" {tuple(config.data.shape_x)}, {result['ms_per_score_eval']:.3f} ms per score evaluation;"
          f" val_rec_loss_pc {rec}; frames {result['frames']}; launches {result['launches']}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("paired3D callback: frames or val_rec_loss_pc missing or not finite")
    return result


def run_statistics(directory):
    """``main --mode compute_dataset_statistics`` in-process on the texture64
    recipe, 200 train batches of 64: the train split is the committed
    texture64 test file, linked in as the train file of a dataset directory
    under ``directory`` (the train file is not sent to the card).  Each
    batch the mode reduces on the card is also reduced on the host in
    float64 (a recorder around its `get_hf_coefficients`), and the saved
    mean is held against that."""
    config = texture64_sr_cmde_config()
    d = os.path.join(directory, "stats", config.data.dataset)
    os.makedirs(d)
    os.symlink(os.path.join(REPO, "datasets", "texture64", "texture64-test.pklv4"),
               os.path.join(d, "texture64-train.pklv4"))
    base = os.path.dirname(d)
    host = {"sum": 0.0, "count": 0}
    real = statistics.get_hf_coefficients

    def recording(x):
        hf = get_hf_coefficients(x.detach().cpu().double())
        host["sum"], host["count"] = host["sum"] + hf.sum(dim=0), host["count"] + hf.shape[0]
        return real(x)

    statistics.get_hf_coefficients = recording
    zero_launches()
    t = time.perf_counter()
    try:
        cli.main(["--mode", "compute_dataset_statistics", "--config", "texture64_sr_cmde", "--data_path", base])
        torch.cuda.synchronize()
    finally:
        statistics.get_hf_coefficients = real
    seconds = time.perf_counter() - t
    mean = np.load(os.path.join(base, "datasets_mean", f"{config.data.dataset}_{config.data.image_size}", "mean.npy"))
    want = (host["sum"] / host["count"]).numpy()
    err = float(np.abs(mean - want).max() / np.abs(want).max())
    count = host["count"]
    ok = mean.shape == (32, 32, 9) and mean.dtype == np.float32 and bool(np.isfinite(mean).all()) and err <= STATS_TOL
    ok = ok and count == STATS_BATCHES * config.training.batch_size
    result = dict(path="--mode compute_dataset_statistics, texture64", batches=STATS_BATCHES, images=count,
                  seconds=seconds, shape=list(mean.shape), rel_err_vs_float64_host=err, launches=read_launches())
    phase("main", t, f"compute_dataset_statistics on texture64 ({STATS_BATCHES} batches, {count} images):"
                     f" {seconds:.3f} s (with the host's float64 copy); mean.npy {mean.shape} {mean.dtype} range"
                     f" [{mean.min():.5f}, {mean.max():.5f}]; against the float64 host reduction of the same batches"
                     f" rel err {err:.3e} (tol {STATS_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("compute_dataset_statistics: mean.npy wrong")
    return result


def run_inverse_problems():
    """Phase 22: the paper's other inverse problems on their twins."""
    t = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="inverse_problems_")
    try:
        src = os.path.join(REPO, "datasets")
        write_texture64_paired(directory, src)
        write_texture_mri_to_pet(directory, src, volumetric=False)
        write_texture_mri_to_pet(directory, src, volumetric=True)
        twins = [(label, recipe(directory if written else src), want) for label, recipe, written, want in INVERSE_TWINS]
        volumes = texture_mri_to_pet_3d_config(directory)
        try:  # the image-to-image consistency compares OpenCV's Canny edges
            get_consistency_fn("image-to-image")
            import cv2

            canny = f"measured (cv2 {cv2.__version__})"
        except ConsistencyUnavailable as e:
            canny = f"skipped: {e}"
        phase("setup", t, f"twin trees under {directory}: texture64 image-to-image PNGs, MRI->PET .npy slices and"
                          f" volumes; image-to-image consistency: {canny}")

        t = time.perf_counter()
        for label, config, want in twins:
            calls = forward_calls(config, BATCH, twin_inputs(config, "meta"))
            if dict(calls) != want:
                raise RuntimeError(f"{label}: kernel sites {dict(calls)}, expected {want}")
        new = {k for _, _, want in twins for k in want} - earlier_sites()
        rows = check_inverse_sites(new)
        phase("kernel", t, f"inverse-problem twins: kernels 1-3 against plain at the {len(new)} sites no earlier"
                           f" phase checked: {sorted(new)}")

        paths, agree = [], []
        for label, config, want in twins:
            batch = twin_batch(config)
            model = init_model_random(config, seed=config.seed, device="cuda")
            off = copy.deepcopy(config)
            off.model.fused_tail = off.model.fused_block = False
            agree.append(agreement(f"float32 {label} _block twin", config, off, model, batch, None,
                                   REL_TOL[torch.float32]))
            sde, eps = sampler_sde(config)
            shape = tuple(batch["x"].shape)
            sample = get_conditional_sampling_fn(config, sde, shape, eps, p_steps=INVERSE_STEPS)
            gen = torch.Generator(device="cuda").manual_seed(config.seed)
            with torch.no_grad():
                paths.append(run_sampler(f"float32 {label} _block twin", lambda: sample(gen, model, batch["y"])[0],
                                         per_name(want), INVERSE_STEPS, shape=shape))
            del model

        zeros = {name: 0 for name in WRAPPERS}
        for label, config in [(lbl, c) for lbl, c, _ in twins] + [("MRI->PET volumes", volumes)]:
            config = copy.deepcopy(config)
            config.training.log_freq, config.training.eval_freq = 1, 10**9
            paths.append(run_trainer(f"float32 {label} trainer, B={config.training.batch_size}", config,
                                     INVERSE_TRAIN_STEPS, zeros, evals=0, restore=False))

        paths.append(run_inverse_harness(per_name(SITES_128), directory))
        paths.append(run_paired3d(volumes, directory))
        paths.append(run_statistics(directory))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return paths, agree, rows


# ---- the score_sde baselines (phase 23) ---------------------------------------


def fit_largest_batch(label, config, steps):
    """`run_trainer` at the recipe's train batch, halved until the step fits
    in the card's memory; returns the result and the batch it ran at."""
    zeros = {name: 0 for name in WRAPPERS}
    batch = config.training.batch_size
    while True:
        c = copy.deepcopy(config)
        c.training.batch_size = batch
        c.training.log_freq, c.training.eval_freq, c.training.snapshot_freq = 1, 10**9, 10**9
        try:
            return run_trainer(f"float32 {label} trainer, B={batch}", c, steps, zeros, evals=0, restore=False), batch
        except torch.cuda.OutOfMemoryError as e:
            print(f"  {label}: the train step at B={batch} does not fit: {str(e).splitlines()[0]}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        if batch == 1:
            raise RuntimeError(f"{label}: no train batch fits")
        batch //= 2


@contextlib.contextmanager
def table_entry(recipe, build):
    """The path table's entry for the recipe file ``recipe`` replaced by
    ``build`` (given the table's own entry) inside the block."""
    key = score_sde.recipe_key(recipe)
    real = score_sde.RECIPES[key]
    score_sde.RECIPES[key] = lambda: build(real)
    try:
        yield real
    finally:
        score_sde.RECIPES[key] = real


def cli_train(recipe, data_path, steps):
    """``main.py --mode train --config <recipe> --data_path <data_path>``
    in-process: the recipe from the path table, its ``n_iters`` cut to
    ``steps`` (every step logged) by wrapping the table entry for the call.
    Finite losses at every step, no callback failure, every counter 0 (the
    train steps carry a gradient)."""

    def cut(real):
        config = real()
        config.training.n_iters, config.training.log_freq = steps, 1
        return config

    t = time.perf_counter()
    with table_entry(recipe, cut), tempfile.TemporaryDirectory() as log_path:
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        cli.main(["--mode", "train", "--config", recipe, "--data_path", data_path, "--log_path", log_path])
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        scalars = read_scalars(os.path.join(log_path, "scalars.jsonl"))
        failures = callback_failures_logged(log_path)
        saved = sorted(os.listdir(os.path.join(log_path, "checkpoints")))
    wall = time.perf_counter() - t
    losses = [(step, v) for tag, v, step in scalars if tag == "train_loss"]
    ms = [v for tag, v, _ in scalars if tag == "ms_per_step"]
    ok = ([step for step, _ in losses] == list(range(1, steps + 1))
          and all(math.isfinite(v) for _, v in losses) and not failures and not any(launches.values()))
    phase("main", t, f"CLI --mode train --config {recipe} --data_path {data_path}: {wall:.3f} s,"
                     f" train_loss {losses}, ms_per_step {ms}, peak {peak:.3f} GiB, checkpoints {saved},"
                     f" callback failures {failures}, launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{recipe} did not train through the CLI as expected")
    return dict(path=f"CLI train {recipe}", steps=steps, wall_s=wall, train_loss=losses, ms_per_step=ms,
                peak_gib=peak, launches=launches)


def run_score_sde_cli(root):
    """`cli_train` of ``configs/ve/ncsnv2/celeba.py``; ``<root>/CELEBA`` is
    the twin's texture64 folder."""
    dataset = score_sde.RECIPES[score_sde.recipe_key(SCORE_SDE_CLI_RECIPE)]().data.dataset
    os.symlink(os.path.join(root, score_sde.TEXTURE64_FOLDER), os.path.join(root, dataset))
    return cli_train(SCORE_SDE_CLI_RECIPE, root, SCORE_SDE_CLI_STEPS)


def run_score_sde():
    """Phase 23: the score_sde baselines (NCSN, NCSNv2 64 / 128, the
    discrete-VE NCSN++ and the discrete DDPM) on their texture twins."""
    t = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="score_sde_")
    try:
        write_twin_folders(directory, os.path.join(REPO, "datasets"))
        twins = [(label, recipe(directory), steps) for label, recipe, steps in SCORE_SDE_TWINS]
        calls = {label: forward_calls(config, SCORE_SDE_BATCH) for label, config, _ in twins}
        phase("setup", t, f"twin folders under {directory}: {score_sde.TEXTURE64_FOLDER}"
                          f" ({len(os.listdir(os.path.join(directory, score_sde.TEXTURE64_FOLDER)))} PNGs),"
                          f" {score_sde.TEXTURE128_FOLDER}"
                          f" ({len(os.listdir(os.path.join(directory, score_sde.TEXTURE128_FOLDER)))} PNGs);"
                          f" kernel calls per forward {({k: dict(v) for k, v in calls.items()})}")
        ncsnpp_label = SCORE_SDE_TWINS[3][0]
        for label, _, _ in twins:
            want = SCORE_SDE_FIR_PER_FORWARD if label == ncsnpp_label else {}
            if per_name(calls[label]) != want:
                raise RuntimeError(f"{label}: kernel calls per forward {per_name(calls[label])}, expected {want}")

        t = time.perf_counter()
        shapes = [(name, h, c, n) for (name, h, w, c), n in sorted(calls[ncsnpp_label].items())]
        fir_rows = check_fir(shapes=shapes)
        for r in fir_rows:
            r["path"] = "discrete-VE NCSN++ 32px"
        phase("kernel", t, f"FIR kernels against plain at the 32px NCSN++ twin's {len(shapes)} shapes, timed")

        paths, agree = [], None
        for label, config, _ in twins:
            t = time.perf_counter()
            model = init_model_random(config, seed=config.seed, device="cuda")
            sde, eps = build_sde(config)
            shape = (SCORE_SDE_BATCH, config.data.image_size, config.data.image_size, config.data.num_channels)
            per_step = evaluations_per_step(config)
            steps = math.ceil(SCORE_SDE_EVALS / per_step)

            def sample(p_steps, seed=config.seed, model=model, config=config, sde=sde, eps=eps, shape=shape):
                fn = get_sampling_fn(config, sde, shape, eps, p_steps=p_steps)
                with torch.no_grad():
                    return fn(torch.Generator(device="cuda").manual_seed(seed), model)[0]

            phase("setup", t, f"{label}: {sum(p.numel() for p in model.parameters())} parameters,"
                              f" {type(sde).__name__} N={sde.N}, {config.sampling.predictor} +"
                              f" {config.sampling.corrector} x {config.sampling.n_steps_each}: {per_step} score"
                              f" evaluations a step, {steps} steps")
            if label == ncsnpp_label:  # the FIR kernels on against their plain versions on a short sample
                t = time.perf_counter()
                zero_launches()
                got = sample(SCORE_SDE_SHORT)
                launches = read_launches()
                with plain_versions():
                    want = sample(SCORE_SDE_SHORT)
                expected = expect_launches(label, launches, SCORE_SDE_FIR_PER_FORWARD, per_step * SCORE_SDE_SHORT)
                agree = dict(path=f"float32 {label} FIR kernels vs plain", tol=FIR_AGREE_TOL,
                             sample_rel_err=rel_err(got, want), launches=launches)
                ok = agree["sample_rel_err"] <= FIR_AGREE_TOL
                phase("agreement", t, f"{agree['path']}: {SCORE_SDE_SHORT}-step sample rel err"
                                      f" {agree['sample_rel_err']:.3e} (tol {FIR_AGREE_TOL:.0e}), launches"
                                      f" {launches} (expected {expected}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"{label}: the FIR kernels disagree with their plain versions")
            sample(1)  # so that the timed window holds no first call's cost
            paths.append(run_sampler(f"float32 {label} sampler", lambda: sample(steps), per_name(calls[label]), steps,
                                     shape=shape, evals_per_step=per_step))
            del model

        for label, config, steps in twins:
            result, batch = fit_largest_batch(label, config, steps)
            result["recipe_batch"], result["batch"] = config.training.batch_size, batch
            paths.append(result)
        paths.append(run_score_sde_cli(directory))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return paths, agree, fir_rows


# ---- the celebA multi-scale recipes and the Haar-flow trainer (phase 24) ------


def write_celeba_folders(directory, source_dir, limit=None):
    """The texture160 images as celebA under ``directory``: ``haar/celebA/``
    the train images (the first ``limit``) as JPEGs, with the Haar trees the
    recipes read beside it (``celebA_{160,80,40}`` by `create_dataset` of
    `celeba_haar_config(40)`; ``celebaHQ_128`` of the first `HAARFLOW_IMAGES`
    for `haarflow_config(128)`); ``bicubic/celebA/`` celebA's fixed split in
    symbolic links, the 162,770 train names cycling over the train JPEGs and
    the names after them the test images'.  Returns (Haar base, bicubic
    base, {stage: seconds})."""
    seconds = {}
    t = time.perf_counter()
    haar, bicubic = os.path.join(directory, "haar"), os.path.join(directory, "bicubic")
    jpegs = {}
    for split in ("train", "test"):
        images = load_pkl_images(os.path.join(source_dir, "texture160", f"texture160-{split}.pklv4"),
                                 limit or int(1e9))
        folder = os.path.join(directory, f"jpeg_{split}")
        os.makedirs(folder)
        jpegs[split] = [os.path.join(folder, f"{i:06d}.jpg") for i in range(len(images))]
        with ThreadPoolExecutor(8) as pool:  # libjpeg and the file writes release the GIL
            list(pool.map(lambda i: Image.fromarray(images[i]).save(jpegs[split][i], quality=CELEBA_JPEG_QUALITY),
                          range(len(images))))
    os.makedirs(os.path.join(haar))
    os.symlink(os.path.join(directory, "jpeg_train"), os.path.join(haar, "celebA"))
    seconds["jpeg"] = time.perf_counter() - t
    t = time.perf_counter()
    config = celeba_haar_config(40)
    config.data.base_dir = haar
    create_dataset(config)
    seconds["haar_160_80_40"] = time.perf_counter() - t
    t = time.perf_counter()
    flow = haarflow_config(128)
    create_haar_dataset(os.path.join(haar, "celebA"), haar, flow.data.dataset, flow.data.image_size, max_depth=0,
                        split=tuple(flow.data.split), seed=flow.seed, limit=HAARFLOW_IMAGES)
    seconds["haar_128"] = time.perf_counter() - t
    t = time.perf_counter()
    folder = os.path.join(bicubic, "celebA")
    os.makedirs(folder)
    train, test = jpegs["train"], jpegs["test"]
    links = [train[i % len(train)] for i in range(sr_multiscale.CELEBA_TRAIN)] + test
    for i, target in enumerate(links):
        os.symlink(target, os.path.join(folder, f"{i:06d}.jpg"))
    seconds["bicubic_links"] = time.perf_counter() - t
    return haar, bicubic, seconds


def multiscale_recipe(label, haar, bicubic):
    config = dict(MULTISCALE_RECIPES)[label]()
    config.data.base_dir = bicubic if "bicubic" in label else haar
    return config


def datamodule_ms(config, batches=2):
    """Host milliseconds of each of the first ``batches`` train batches of
    ``config``'s datamodule, after the task's `prepare_batch`."""
    dm = create_datamodule(config)
    dm.setup()
    task = create_task(config, None)
    it, out = dm.train_iterator(), []
    for _ in range(batches):
        t = time.perf_counter()
        task.prepare_batch(next(it))
        out.append((time.perf_counter() - t) * 1e3)
    return out


def multiscale_sites():
    """Kernels 1-3 per forward of each recipe's _block variant at B=8 on the
    meta device; raises where one differs from `MULTISCALE_PER_FORWARD` or
    the sites no earlier phase checked from `MULTISCALE_NEW_SITES`."""
    union = collections.Counter()
    for label, build in MULTISCALE_RECIPES:
        config = build()
        config.model.fused_tail = config.model.fused_block = True
        calls = forward_calls(config, BATCH, chain_inputs(config, BATCH))
        if per_name(calls) != MULTISCALE_PER_FORWARD[label]:
            raise RuntimeError(f"{label}: kernel calls per forward {per_name(calls)}, expected"
                               f" {MULTISCALE_PER_FORWARD[label]}")
        union.update(calls)
    new = set(union) - earlier_sites()
    if new != set(MULTISCALE_NEW_SITES):
        raise RuntimeError(f"new sites {sorted(new)}, expected `MULTISCALE_NEW_SITES`")
    return new


def multiscale_masters(recipe, space, base, directory):
    """The master file ``recipe`` by path (the path table), each scale on
    ``base`` at eval batch `BATCH`, chained in ``space``, and its _block
    twin (fused_tail, fused_block), both on one set of random weights."""
    off = cli.load_config(recipe)
    off.coordinate_space = space
    for config in multiscale.scale_configs(off):
        config.data.base_dir, config.eval.batch_size = base, BATCH
    on = copy.deepcopy(off)
    for config in multiscale.scale_configs(on):
        config.model.fused_tail = config.model.fused_block = True
    random_chain_weights(off, directory, on)
    return on, off


def run_multiscale_chains(haar, bicubic):
    """Each celebA master chain: kernels on against off over `PYRAMID_SHORT`
    steps a scale (`chain_agreement`), then ``main.py --mode
    multi_scale_test --config <master file>`` in-process over `CHAIN_STEPS`
    a scale, with the table entry wrapped to the chain with the kernels on,
    the random weights and eval batch `BATCH`; every launch at its count."""
    paths, agree = [], []
    with tempfile.TemporaryDirectory() as weights:
        for label, recipe, space in MULTISCALE_MASTERS:
            base = bicubic if space == "bicubic" else haar
            directory = os.path.join(weights, space)
            os.makedirs(directory)
            on, off = multiscale_masters(recipe, space, base, directory)
            per_forward = {s: per_name(c) for s, c in chain_calls(on).items()}
            agree.append(chain_agreement(f"float32 {label} master", on, off, per_forward))
            with table_entry(recipe, lambda real: copy.deepcopy(on)):
                result, _ = run_chain(f"float32 {label} master chain (--mode multi_scale_test by path),"
                                      " fused_block+fused_tail", None, CHAIN_STEPS, per_forward, cli_config=recipe,
                                      data_path=base)
            result["calls_per_forward"] = per_forward
            paths.append(result)
    return paths, agree


def run_multiscale_recipes():
    """Phase 24: the celebA multi-scale recipes and the Haar-flow trainer."""
    t = time.perf_counter()
    # in memory where the machine has /dev/shm: 162,822 links on its disk took 24.5 s
    directory = tempfile.mkdtemp(prefix="celeba_multiscale_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    try:
        haar, bicubic, seconds = write_celeba_folders(directory, os.path.join(REPO, "datasets"))
        host = {label: datamodule_ms(multiscale_recipe(label, haar, bicubic))
                for label in ("celebA haar 40", "haarflow 128")}  # the bicubic one: its trainer's data_ms
        phase("setup", t, f"celebA folders under {directory}: build seconds {seconds}; host ms of the first train"
                          f" batches (after prepare_batch) {host}")
        data = dict(path="celebA data build and datamodules", build_s=seconds, datamodule_ms=host,
                    launches={name: 0 for name in WRAPPERS})

        t = time.perf_counter()
        new = multiscale_sites()
        rows = check_inverse_sites(new, site="celebA multi-scale / Haar flow")
        phase("kernel", t, f"celebA multi-scale and Haar-flow recipes: kernels 1-3 against plain at the {len(new)}"
                           f" sites no earlier phase checked: {sorted(new)}")

        paths = [data, cli_train(MULTISCALE_CLI_RECIPE, haar, MULTISCALE_TRAIN_STEPS)]
        for label in ("celebA bicubic 160", "haarflow 128"):
            config = multiscale_recipe(label, haar, bicubic)
            result, batch = fit_largest_batch(label, config, MULTISCALE_TRAIN_STEPS)
            result["recipe_batch"], result["batch"] = config.training.batch_size, batch
            paths.append(result)
        chains, agree = run_multiscale_chains(haar, bicubic)
        paths += chains
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return paths, agree, rows


# ---- the perceptual metrics (phase 25) -----------------------------------------


def synthetic_perceptual_weights(directory):
    """Seeded weights written as the reference files are: pytorch-fid's
    Inception state dict (BatchNorm statistics random too), torchvision
    AlexNet ``features.*`` and lpips' ``lin{i}.model.1.weight``.  Returns
    {env var: path}."""
    g = torch.Generator().manual_seed(1)
    net, lp = fid_inception.InceptionV3FID(), lpips_metric.LPIPS()
    with torch.no_grad():
        for m in itertools.chain(net.modules(), lp.modules()):
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                if m.out_channels == 1:  # an lpips head: non-negative
                    m.weight.uniform_(0.0, 0.1, generator=g)
                else:
                    m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-0.05, 0.05, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    paths = {k: os.path.join(directory, name) for k, name in (
        ("CSDT_INCEPTION_WEIGHTS", "pt_inception.pth"), ("CSDT_LPIPS_ALEXNET", "alexnet.pth"),
        ("CSDT_LPIPS_LIN", "alex_lin.pth"))}
    torch.save(net.state_dict(), paths["CSDT_INCEPTION_WEIGHTS"])
    sd = lp.state_dict()
    torch.save({k: v for k, v in sd.items() if k.startswith("features.")}, paths["CSDT_LPIPS_ALEXNET"])
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")}, paths["CSDT_LPIPS_LIN"])
    return paths


def rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def run_perceptual():
    """Phase 25: Inception taps, LPIPS, FID and joint FID on the card
    against the CPU in float64, timed; then the evaluation pipeline with the
    weights' env vars set on a tree of the same images."""
    t = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="perceptual_")
    try:
        files = synthetic_perceptual_weights(directory)
        gt = load_pkl_images(os.path.join(REPO, "datasets", "texture160", "texture160-test.pklv4"))[:PERCEPTUAL_IMAGES]
        x = np.stack(gt).astype(np.float32) / 255.0
        g = np.random.default_rng(0)
        s = np.clip(x + g.normal(0.0, 0.1, x.shape).astype(np.float32), 0.0, 1.0)
        y = np.stack(bicubic_lq_images(gt, 4)).astype(np.float32) / 255.0
        zero_launches()
        card = fid_inception.load_fid_inception(files["CSDT_INCEPTION_WEIGHTS"], (0, 1, 2, 3), device="cuda")
        host = fid_inception.load_fid_inception(files["CSDT_INCEPTION_WEIGHTS"], (0, 1, 2, 3), device="cpu",
                                                dtype=torch.float64)
        lp_card = lpips_metric.load_lpips(files["CSDT_LPIPS_ALEXNET"], files["CSDT_LPIPS_LIN"], device="cuda")
        lp_host = lpips_metric.load_lpips(files["CSDT_LPIPS_ALEXNET"], files["CSDT_LPIPS_LIN"], device="cpu",
                                          dtype=torch.float64)
        xc = torch.from_numpy(x).cuda()
        with torch.no_grad(), full_float32():
            taps = [a.double().cpu().numpy() for a in card(xc)]
            want = [a.numpy() for a in host(torch.from_numpy(x).double())]
            inception_ms = time_ms(lambda: card(xc), iters=20, warmup=3)
            sc = torch.from_numpy(s).cuda()
            lpips_ms = time_ms(lambda: lp_card(xc, sc), iters=20, warmup=3)
        tap_err = [rel(a, b) for a, b in zip(taps, want)]
        lp_err = rel(lpips_metric.distances(lp_card, x, s), lpips_metric.distances(lp_host, x, s))
        acts = {name: (fid_inception.activations(card, v), fid_inception.activations(host, v))
                for name, v in (("x", x), ("y", y), ("s", s))}
        fid = [fid_from_activations(acts["x"][i], acts["s"][i]) for i in (0, 1)]
        jfid = [joint_fid_from_activations(acts["y"][i], acts["x"][i], acts["s"][i]) for i in (0, 1)]
        fid_err, jfid_err = abs(fid[0] - fid[1]) / abs(fid[1]), abs(jfid[0] - jfid[1]) / abs(jfid[1])
        ok = max(tap_err) <= PERCEPTUAL_TOL and lp_err <= PERCEPTUAL_TOL and max(fid_err, jfid_err) <= FID_TOL
        phase("agreement", t, f"perceptual metrics on synthetic reference-named weights, {PERCEPTUAL_IMAGES} texture160"
                              f" test images: Inception taps 0-3 card (float32, TF32 off) against CPU float64 rel err"
                              f" {['%.3e' % e for e in tap_err]}, LPIPS {lp_err:.3e} (tol {PERCEPTUAL_TOL:.0e});"
                              f" FID {fid[0]:.6f} vs {fid[1]:.6f} ({fid_err:.3e}), joint FID {jfid[0]:.6f} vs"
                              f" {jfid[1]:.6f} ({jfid_err:.3e}; tol {FID_TOL:.0e}); Inception forward"
                              f" {inception_ms:.4f} ms, LPIPS {lpips_ms:.4f} ms (B={PERCEPTUAL_IMAGES})"
                              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the perceptual metrics on the card disagree with the CPU's float64")

        t = time.perf_counter()
        tree = os.path.join(directory, "tree")
        for name, images in (("x_gt", x), ("y_gt", y), ("samples/snr_0.150/draw_1", s),
                             ("samples/snr_0.150/draw_2", np.clip(s[::-1] * 0.5 + x * 0.5, 0, 1))):
            os.makedirs(os.path.join(tree, "images", name))
            for i, img in enumerate(images):
                save_png(img, os.path.join(tree, "images", name, f"{i + 1}.png"))
        saved = {k: os.environ.get(k) for k in files}
        os.environ.update(files)
        try:
            result = run_evaluation_pipeline("super-resolution", tree, 0.15, scale=4, device="cuda")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = read_launches()
        wall = time.perf_counter() - t
        ok = (result["skipped"] == [] and all("lpips" in e for e in result["per_draw"].values())
              and all(math.isfinite(result[k]["mean"]) for k in ("fid", "joint_fid"))
              and sorted(result["best_25_lpips_ids"]) == list(range(1, PERCEPTUAL_IMAGES + 1))
              and not any(launches.values()))
        phase("main", t, f"evaluation pipeline with CSDT_INCEPTION_WEIGHTS / CSDT_LPIPS_* set: {wall:.3f} s;"
                         f" per_draw {result['per_draw']}, fid {result['fid']}, joint_fid {result['joint_fid']},"
                         f" best_25_lpips_ids {result['best_25_lpips_ids']}, skipped {result['skipped']}"
                         f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the pipeline did not report lpips, fid and joint_fid")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return dict(path="perceptual metrics (synthetic weights) and the pipeline", tap_rel_err=tap_err,
                lpips_rel_err=lp_err, fid=fid, joint_fid=jfid, fid_rel_err=fid_err, joint_fid_rel_err=jfid_err,
                inception_ms=inception_ms, lpips_ms=lpips_ms, pipeline_s=wall,
                pipeline={k: result[k] for k in ("per_draw", "fid", "joint_fid", "best_25_lpips_ids")},
                launches=launches)


# ---- phases 26-29: data parallelism, trace attribution, reference checkpoints, the host batch

DP_TRAIN_STEPS = 4  # Trainer.fit of phase 26, each way
DP_PROFILE_STEPS = 2  # its profiler window: steps 3-4
DP_TIMED_STEPS = 3  # steps timed each way after the fits
SHARD_STEPS = 2  # the sharded bf16 flagship sampler of phase 27
HOST_BATCH, HOST_REPEATS = 16, 5  # phase 29: images a batch, timed batches each way


def init_world_one(directory):
    """A one-rank NCCL group through a ``file://`` rendezvous in ``directory``."""
    return parallel.init_distributed("cuda", init_method=f"file://{directory}/pg", rank=0, world_size=1)


def update_rel(got, want, start):
    """``||got - want|| / ||want - start||`` over every tensor of the same
    names: how far apart two runs' updates from ``start`` are, by norm (an
    element's difference over the largest magnitude would be ruled by
    Adam's ~lr steps of rounding-noise gradients in zero-initialized
    tensors)."""
    diff = sum(float((got[n] - w).double().square().sum()) for n, w in want.items())
    update = sum(float((w - start[n]).double().square().sum()) for n, w in want.items())
    return math.sqrt(diff / update)


def run_data_parallel_trainer():
    """Phase 26: `Trainer.fit` of the flagship trainer (kernel 4, float32,
    B=16) under a one-rank NCCL group against the same fit without one, with
    cuDNN held to its deterministic algorithms (``cudnn.deterministic``, no
    benchmark; restored after): losses, params, EMA and the eval loss bit
    for bit; kernel 4's launches; the profiler window on steps 3-4 of the
    distributed run attributed by `profiling.attribute`, its conv3x3_gemm
    launches against the counter's increase over those steps and its device
    total against `key_averages()`; ms per step each way.  Each run starts
    with the card's memory as the first found it (the previous trainer
    freed, the cache emptied)."""
    t = time.perf_counter()
    config = train_configs()
    config.training.log_freq = 1
    config.training.eval_freq = config.training.snapshot_freq = 10**9
    config.eval.loss_split = "test"  # the val split is not copied to the card
    with tempfile.TemporaryDirectory() as tmp:

        def fit(label, profile_dir=None):
            trainer = Trainer(config, os.path.join(tmp, label))
            start = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
            per_step, step = [], trainer.train_step

            def count_launches(state, batch, **kwargs):
                before = WRAPPERS["conv3x3"].launches
                metrics = step(state, batch, **kwargs)
                per_step.append(WRAPPERS["conv3x3"].launches - before)
                return metrics

            trainer.train_step = count_launches
            env = {"CSDT_PROFILE_DIR": profile_dir, "CSDT_PROFILE_STEPS": str(DP_PROFILE_STEPS)} if profile_dir else {}
            os.environ.update(env)
            zero_launches()
            try:
                history = trainer.fit(max_steps=DP_TRAIN_STEPS, callbacks=[])
            finally:
                for k in env:
                    del os.environ[k]
            run = dict(
                launches=read_launches(), per_step=per_step, losses=[v for _, v in history["train_loss"]],
                start=start, params={n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
                ema={n: p.cpu() for n, p in trainer.state.ema.params.items()},
                eval_loss=trainer.run_eval(DP_TRAIN_STEPS),
            )
            if trainer.profile is not None:
                # device time by key_averages(): kernels and copies; the GPU spans of annotations
                # (e.g. Optimizer.step) are kept apart, they cover kernels already counted
                spans = {ev["name"] for f in profiling.find_trace_files(profile_dir) for ev in profiling.parse_trace(f)
                         if ev.get("cat") == "gpu_user_annotation"}
                cuda = [e for e in trainer.profile.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
                annotation = [e for e in cuda if e.key in spans or getattr(e, "is_user_annotation", False)]
                run["key_averages_ms"] = sum(e.self_device_time_total for e in cuda if e not in annotation) / 1e3
                run["annotations"] = {e.key: e.self_device_time_total / 1e3 for e in annotation}
            # ms per step on a fixed batch (host clock), after the compared state was copied
            trainer.train_step = step
            batch = to_device(trainer.task.prepare_batch(next(trainer.datamodule.train_iterator())), trainer.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_TIMED_STEPS):
                step(trainer.state, batch)
            torch.cuda.synchronize()
            run["ms_per_step"] = (time.perf_counter() - t0) / DP_TIMED_STEPS * 1e3
            del trainer, batch
            gc.collect()
            torch.cuda.empty_cache()
            return run

        profile_dir = os.path.join(tmp, "profile")
        cudnn = torch.backends.cudnn
        flags = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            plain = fit("plain", os.path.join(tmp, "profile_plain"))
            init_world_one(tmp)
            try:
                dist_run = fit("distributed", profile_dir)
            finally:
                torch.distributed.destroy_process_group()
        finally:
            cudnn.deterministic, cudnn.benchmark = flags
        bitwise = dict(
            loss=dist_run["losses"] == plain["losses"], eval_loss=dist_run["eval_loss"] == plain["eval_loss"],
            **{k: all(torch.equal(dist_run[k][n], v) for n, v in plain[k].items()) for k in ("params", "ema")})
        # where they differ, by how much: the update's norm
        update_gap = {k: update_rel(dist_run[k], plain[k], plain["start"]) for k in ("params", "ema")}
        ms_dist, ms_plain = dist_run["ms_per_step"], plain["ms_per_step"]
        attribution = profiling.attribute(profile_dir)
        plain_families = profiling.attribute(os.path.join(tmp, "profile_plain"))["families"]
        averages_ms = dist_run["key_averages_ms"]
        traced_ms = profiling.device_ms(attribution)
        gemm = attribution["families"].get("conv3x3_gemm", {}).get("occurrences", 0)
        counted = sum(dist_run["per_step"][2:2 + DP_PROFILE_STEPS])
    fwd, dx = CONV_PER_TRAIN_STEP
    expected = {name: 0 for name in WRAPPERS}
    expected["conv3x3"] = DP_TRAIN_STEPS * (fwd + dx)
    ok = (all(bitwise.values()) and dist_run["launches"] == plain["launches"] == expected and gemm == counted
          and dist_run["per_step"] == [fwd + dx] * DP_TRAIN_STEPS
          and abs(traced_ms - averages_ms) <= 0.02 * averages_ms and attribution["files"]
          and all(math.isfinite(v) for v in dist_run["losses"]))
    result = dict(
        path="float32 trainer under a one-rank NCCL group (parallel)", steps=DP_TRAIN_STEPS,
        launches=dist_run["launches"], expected_launches=expected, plain_launches=plain["launches"],
        train_loss=dist_run["losses"], train_loss_plain=plain["losses"], eval_loss=dist_run["eval_loss"],
        eval_loss_plain=plain["eval_loss"], bitwise_equal=bitwise, update_rel_err=update_gap,
        ms_per_step_distributed=ms_dist, ms_per_step_plain=ms_plain, traced_steps=[3, 2 + DP_PROFILE_STEPS],
        trace_conv3x3_gemm=gemm, counter_conv3x3_over_traced_steps=counted, trace_device_ms=traced_ms,
        key_averages_device_ms=averages_ms, key_averages_annotations_ms=dist_run["annotations"],
        trace_kernel_ms=attribution["total_ms"],
        trace_memcpy_memset_ms=attribution["async_overlapped_ms"], streams=attribution["planes"],
        families={k: {"ms_per_step": v["ms"] / DP_PROFILE_STEPS, "share": v["share"],
                      "launches_per_step": v["occurrences"] / DP_PROFILE_STEPS}
                  for k, v in attribution["families"].items()},
        family_ms_per_step_minus_plain={
            k: (attribution["families"].get(k, {}).get("ms", 0.0) - plain_families.get(k, {}).get("ms", 0.0))
            / DP_PROFILE_STEPS for k in set(attribution["families"]) | set(plain_families)},
    )
    phase("main", t,
          f"{result['path']}: Trainer.fit({DP_TRAIN_STEPS}) B={TRAIN_BATCH}; train_loss"
          f" {['%.6f' % v for v in dist_run['losses']]} (plain {['%.6f' % v for v in plain['losses']]});"
          f" bit for bit the plain run's (cuDNN deterministic): {bitwise} (params and EMA apart by"
          f" {update_gap['params']:.3e} and {update_gap['ema']:.3e} of the update's norm; the eval loss is the"
          f" all-reduced mean); ms per step"
          f" (host clock, a fixed batch, {DP_TIMED_STEPS} steps) distributed {ms_dist:.3f}, plain {ms_plain:.3f};"
          f" kernel 4 launches {dist_run['launches']['conv3x3']} (plain {plain['launches']['conv3x3']}, expected"
          f" {expected['conv3x3']}); trace of steps 3-{2 + DP_PROFILE_STEPS}: conv3x3_gemm {gemm} launches against"
          f" the counter's {counted}; device time {traced_ms:.3f} ms (kernels {attribution['total_ms']:.3f} +"
          f" memcpy/memset {attribution['async_overlapped_ms']:.3f}) against key_averages() {averages_ms:.3f}"
          f" (within 2%; its annotations' GPU spans apart: {dist_run['annotations']}) {'ok' if ok else 'FAIL'}")
    for line in profiling.per_unit_lines(attribution, DP_PROFILE_STEPS, 10):
        print(f"  {line}", flush=True)
    print("  device ms a step by family, distributed minus plain (both traced, steps 3-4): " + ", ".join(
        f"{k} {v:+.3f}" for k, v in sorted(result["family_ms_per_step_minus_plain"].items())), flush=True)
    if not ok:
        raise RuntimeError("the data-parallel train step at world 1 disagrees with the plain one, or its launches or"
                           " its trace's attribution do not add up")
    return result


def run_sharded_sampler():
    """Phase 27: the bfloat16 flagship conditional PC sampler through
    `parallel.shard_sampling_fn` under a one-rank NCCL group against the
    plain call: the same samples bit for bit, kernels 1-3 at the same counts."""
    t = time.perf_counter()
    config = texture160_sr_cmde_bf16_block_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    y = torch.from_numpy(next(iter_test_batches(config))["y"]).cuda()
    model = init_model_random(config, seed=config.seed, device="cuda")
    sde, eps = sampler_sde(config)
    score = score_fn(model, sde, torch.bfloat16)
    shape = (BATCH, 160, 160, 3)
    runs = {}
    for label in ("plain", "sharded"):
        directory = tempfile.mkdtemp(prefix="chip_smoke_pg_")
        sharded = label == "sharded"
        if sharded:
            init_world_one(directory)
        try:
            sampler = pc_sampler(config, sde, eps, shape, p_steps=SHARD_STEPS)
            if sharded:
                sampler = parallel.shard_sampling_fn(sampler)
            zero_launches()
            t0 = time.perf_counter()
            samples = sampler(torch.Generator(device="cuda").manual_seed(config.seed), score, y)[0]
            torch.cuda.synchronize()
            runs[label] = dict(samples=samples, launches=read_launches(), wall_s=time.perf_counter() - t0)
        finally:
            if sharded:
                torch.distributed.destroy_process_group()
            shutil.rmtree(directory, ignore_errors=True)
    got, want = runs["sharded"], runs["plain"]
    expected = {name: PER_FORWARD_BLOCK_PATH.get(name, 0) * 2 * SHARD_STEPS for name in WRAPPERS}
    same = torch.equal(got["samples"], want["samples"])
    ok = same and got["launches"] == want["launches"] == expected and bool(torch.isfinite(got["samples"]).all())
    result = dict(path="bfloat16 flagship sampler, sharded (parallel) at world 1", steps=SHARD_STEPS,
                  launches=got["launches"], expected_launches=expected, bitwise_equal=same,
                  wall_s=got["wall_s"], wall_s_plain=want["wall_s"])
    phase("main", t,
          f"{result['path']}: {SHARD_STEPS}-step sampler B={BATCH}, samples bit for bit the plain call's: {same};"
          f" launches {got['launches']} (plain {want['launches']}, expected {expected}); {got['wall_s']:.3f} s"
          f" (plain {want['wall_s']:.3f} s, the first includes cuDNN's plans) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the sharded sampler at world 1 differs from the plain call")
    return result


def write_reference_ckpt(path, sd):
    """A reference Lightning checkpoint: ``score_model.`` keys and
    ``hyper_parameters`` of a class that cannot be imported when it is read
    (the reference's ConfigDict on a machine without ml_collections)."""
    import types

    mod = types.ModuleType("chip_smoke_absent_hparams")

    class ConfigDict:
        def __init__(self):
            self.model = {"name": "ddpm_paired", "nf": 96}

    ConfigDict.__module__, ConfigDict.__qualname__ = mod.__name__, "ConfigDict"
    mod.ConfigDict = ConfigDict
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"state_dict": {f"score_model.{k}": v for k, v in sd.items()},
                    "hyper_parameters": ConfigDict(), "epoch": 0}, path)
    finally:
        del sys.modules[mod.__name__]


def run_reference_checkpoint():
    """Phase 28: the flagship ``ddpm_paired`` (celebA 160, nf 96) with seeded
    weights written as a reference Lightning ``.ckpt`` and loaded through
    `load_reference_lightning_checkpoint` onto the card: its state dict
    against the same arrays through `convert.flax_to_state_dict`, then
    float32 with fused_tail and fused_block on against both off
    (`agreement`, the bound of the other agreement phases)."""
    t = time.perf_counter()
    on_config = texture160_sr_cmde_bf16_block_config()  # float32 weights; kernels 1-3 on
    on_config.data.base_dir = os.path.join(REPO, "datasets")
    off_config = texture160_sr_cmde_config()
    off_config.model.fused_tail = False
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter_test_batches(on_config)).items()}
    params = state_dict_to_flax(init_model_random(on_config, seed=on_config.seed + 28, device="cuda").state_dict())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.ckpt")
        reference = reference_checkpoint.to_reference_state_dict(params, on_config)
        write_reference_ckpt(path, reference)
        size_mb = os.path.getsize(path) / 2**20
        try:
            torch.load(path, map_location="cpu", weights_only=True)
            refused = False
        except pickle.UnpicklingError:
            refused = True
        model = create_model(on_config, "cuda")
        loaded = reference_checkpoint.load_reference_lightning_checkpoint(path, on_config, model=model)
    want = flax_to_state_dict(params)
    on_card = model.state_dict()
    exact = sorted(loaded) == sorted(want) and all(torch.equal(loaded[k], want[k]) for k in want)
    exact = exact and all(torch.equal(on_card[k].cpu(), want[k]) for k in want)
    phase("setup", t, f"reference checkpoint: {len(reference)} reference tensors, {size_mb:.1f} MiB, weights_only"
                      f" refused its hyper_parameters: {refused}; state dict equal to convert.py's: {exact}")
    if not (exact and refused):
        raise RuntimeError("the reference checkpoint's state dict differs from convert.py's, or torch's safe"
                           " loader read its unimportable hyper_parameters")
    per_forward = per_name(forward_calls(on_config, BATCH))
    zero_launches()
    agree = agreement("float32 block path from a reference checkpoint", on_config, off_config, model, batch, None,
                      REL_TOL[torch.float32])
    launches = read_launches()
    expected = {name: per_forward.get(name, 0) * (1 + 2 * 3 + 1) for name in WRAPPERS}  # score, 3 steps, raw
    agree.update(state_dict_exact=exact, safe_loader_refused=refused, launches=launches, expected_launches=expected)
    print(f"[agreement] reference checkpoint: kernels 1-3 launches {launches} (expected {expected})"
          f" {'ok' if launches == expected else 'FAIL'}", flush=True)
    if launches != expected:
        raise RuntimeError(f"reference checkpoint: launches {launches}, expected {expected}")
    return dict(path="float32 block path from a reference checkpoint", launches=launches), agree


def run_host_batch():
    """Phase 29: 16 texture160 images through `data.native.assemble_batch`
    (the GT at 160px, up 1; their 20px nearest LQ, up 8; random flips),
    the C++ path against numpy bit for bit, ms a batch each way."""
    t = time.perf_counter()
    hr = load_pkl_images(os.path.join(REPO, "datasets", "texture160", "texture160-train.pklv4"), HOST_BATCH)
    lr = [np.ascontiguousarray(im[::8, ::8]) for im in hr]
    flips = (np.random.default_rng(29).random(HOST_BATCH) < 0.5).astype(np.uint8)
    rows = {}
    for label, images, up in (("GT 160px, up 1", hr, 1), ("LQ 20px, up 8", lr, 8)):
        ms = {}
        for backend in ("native", "numpy"):
            times = []
            for _ in range(HOST_REPEATS):
                t0 = time.perf_counter()
                out = native.assemble_batch(images, up=up, flips=flips, backend=backend)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[backend] = (float(np.median(times)), out)
        same = ms["native"][1].tobytes() == ms["numpy"][1].tobytes()
        out = ms["native"][1]
        rows[label] = dict(shape=list(out.shape), bitwise_equal=same, native_ms=ms["native"][0],
                           numpy_ms=ms["numpy"][0], threads=native.threads_for(len(images), out.nbytes))
    ok = all(r["bitwise_equal"] for r in rows.values())
    cores = len(os.sched_getaffinity(0))
    phase("main", t, f"host batch (data/native.py, {cores} cores): " + "; ".join(
        f"{k} {r['shape']}: native ({r['threads']} thread(s)) {r['native_ms']:.3f} ms, numpy {r['numpy_ms']:.3f} ms"
        f" a batch (median of {HOST_REPEATS}), bit for bit {r['bitwise_equal']}" for k, r in rows.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the C++ host batch differs from numpy's")
    return dict(path="host batch (data/native.py)", cores=cores, batches=rows,
                launches={name: 0 for name in WRAPPERS})


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    phase(
        "device", t0,
        f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
    )

    # ---- build: one nvcc for each source, started together ----------------
    t = time.perf_counter()
    loaders = {
        "gn_silu_conv3x3": fused_tail.load_library,
        "resblock_fused": fused_block.load_library,
        "fir_resample": fir.load_library,
        "conv3x3": conv3x3.load_library,
        "fused_bias_act": fused_act.load_library,
    }
    with ThreadPoolExecutor(len(loaders)) as pool:
        built = dict(zip(loaders, pool.map(lambda load: load(), loaders.values())))
    phase("build", t, "; ".join(
        f"{name}: nvcc {b.build_seconds:.2f} s -> {os.path.relpath(b.path, REPO)}" for name, b in built.items()
    ))
    for name, b in built.items():
        for ln in b.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)

    t = time.perf_counter()
    tail_rows = check_tail()
    block_rows = check_blocks()
    ncsnpp_tail_rows = check_ncsnpp_sites()
    fir_rows = check_fir()
    check_fir_cases()
    shapes = conv_call_shapes(train_configs())
    per_step = tuple(sum(n for (ph, *_), n in shapes.items() if ph == p) for p in ("forward", "dx"))
    if per_step != CONV_PER_TRAIN_STEP:
        raise RuntimeError(f"kernel 4 calls per train step {per_step}, expected {CONV_PER_TRAIN_STEP}")
    conv_rows, hmajor_rows = check_conv(shapes)
    harness_tails = sites(forward_calls(harness_config(""), HARNESS_BATCH), "gn_silu_conv3x3")
    harness_tail_rows = check_harness_tails(harness_tails)
    t64_blocks = harness_config("")
    t64_blocks.model.fused_block = True
    t64_sites = sites(forward_calls(t64_blocks, HARNESS_BATCH), "resblock_fused", "resblock_fused_split")
    if t64_sites != {(name, *shape): calls for name, *shape, calls in TEXTURE64_BLOCK_SHAPES}:
        raise RuntimeError(f"texture64 block sites {dict(t64_sites)}, expected {TEXTURE64_BLOCK_SHAPES}")
    check_texture64_blocks()
    chain = chain_sites()
    check_chain_sites()
    act_rows = check_fused_act()
    phase("kernel", t, "every kernel agrees with its plain version at every shape; the harness's tail calls per"
                       f" forward {dict(sorted(harness_tails.items()))}")

    # ---- set-up: the batch and one set of weights ---------------------------
    t = time.perf_counter()
    config = texture160_sr_cmde_bf16_block_config()
    config.data.base_dir = os.path.join(REPO, "datasets")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter_test_batches(config)).items()}
    model = init_model_random(config, seed=config.seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    sde, eps = sampler_sde(config)
    shape = tuple(batch["x"].shape)
    phase("setup", t, f"texture160 batch {tuple(batch['y'].shape)}, ddpm_paired {n_params} params")

    tail_config = texture160_sr_cmde_config()  # fused_tail only
    tail_model = create_model(tail_config, "cuda")
    tail_model.load_state_dict(model.state_dict())
    off_config = texture160_sr_cmde_config()
    off_config.model.fused_tail = False
    agree = [
        agreement("float32 tail path", tail_config, off_config, tail_model, batch, None, REL_TOL[torch.float32]),
        agreement("float32 block path", config, off_config, model, batch, None, REL_TOL[torch.float32]),
        agreement("bfloat16 block path", config, off_config, model, batch, torch.bfloat16, BF16_AGREE_TOL),
    ]

    # ---- main: the new path, bfloat16, block and tail kernels -----------
    score = score_fn(model, sde, torch.bfloat16)
    sampler = pc_sampler(config, sde, eps, shape, p_steps=STEPS)
    gen = torch.Generator(device="cuda").manual_seed(config.seed)
    main_new = run_sampler(
        "bfloat16 fused_block+fused_tail", lambda: sampler(gen, score, batch["y"])[0],
        PER_FORWARD_BLOCK_PATH, STEPS,
    )
    del score

    # ---- main: the float32 tail path, fewer steps ---------------------
    tail_sample = get_conditional_sampling_fn(tail_config, sde, shape, eps, p_steps=TAIL_PATH_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(config.seed)
    main_tail = run_sampler(
        "float32 fused_tail", lambda: tail_sample(gen, tail_model, batch["y"])[0],
        PER_FORWARD_TAIL_PATH, TAIL_PATH_STEPS,
    )
    del model, tail_model

    # ---- the DF2K direct 4x NCSN++ path: set-up and agreement ---------------
    t = time.perf_counter()
    kx_config = texture160_kxsr_ncsnpp_config()
    kx_config.data.base_dir = os.path.join(REPO, "datasets")
    kx_batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter_test_batches(kx_config)).items()}
    kx_model = init_model_random(kx_config, seed=kx_config.seed, device="cuda")
    kx_params = sum(p.numel() for p in kx_model.parameters()) + kx_model.unet.fourier.W.numel()
    kx_sde, kx_eps = sampler_sde(kx_config)
    phase(
        "setup", t,
        f"texture160 LRHR batch x {tuple(kx_batch['x'].shape)} y {tuple(kx_batch['y'].shape)},"
        f" ncsnpp_KxSR {kx_params} params (the Fourier W included), sigma_y,max {kx_sde['y'].sigma_max:.4f}",
    )
    block_config = texture160_kxsr_ncsnpp_block_config()
    block_model = create_model(block_config, "cuda")
    block_model.load_state_dict(kx_model.state_dict())
    agree += [
        agreement("float32 NCSN++ FIR kernels vs plain", kx_config, kx_config, kx_model, kx_batch, None,
                  REL_TOL[torch.float32], plain_off=True),
        agreement("float32 NCSN++ block variant", block_config, kx_config, block_model, kx_batch, None,
                  REL_TOL[torch.float32]),
    ]
    del block_model

    # ---- main: the NCSN++ path, float32, the FIR kernels -------------------
    kx_sample = get_conditional_sampling_fn(kx_config, kx_sde, tuple(kx_batch["x"].shape), kx_eps, p_steps=STEPS)
    gen = torch.Generator(device="cuda").manual_seed(kx_config.seed)
    main_ncsnpp = run_sampler(
        "float32 NCSN++ DF2K direct 4x", lambda: kx_sample(gen, kx_model, kx_batch["y"])[0],
        PER_FORWARD_NCSNPP_PATH, STEPS,
    )
    agree.append(ncsnpp_backward(kx_model, kx_batch))
    del kx_model, kx_sample

    # ---- the trainer path: agreement, then Trainer.fit with and without kernel 4
    agree_train = train_agreement()
    config = train_configs()
    config.training.log_freq, config.training.eval_freq = 10, TRAIN_STEPS
    config.eval.loss_split = "test"  # the val split stays off the card (.chiprunignore)
    fwd, dx = CONV_PER_TRAIN_STEP
    expected = {name: 0 for name in WRAPPERS}
    expected["conv3x3"] = TRAIN_STEPS * (fwd + dx) + EVAL_BATCHES * CONV_PER_EVAL_FORWARD
    expected["gn_silu_conv3x3"] = EVAL_BATCHES * PER_FORWARD_TAIL_PATH["gn_silu_conv3x3"]
    main_train = run_trainer("float32 trainer, conv3x3_kernel", config, TRAIN_STEPS, expected, evals=1)
    off = train_configs(off=True)
    off.training.log_freq, off.training.eval_freq = TRAIN_OFF_STEPS, 10**9
    main_train_off = run_trainer(
        "float32 trainer, policy off", off, TRAIN_OFF_STEPS, {name: 0 for name in WRAPPERS}, evals=0, restore=False,
    )

    # ---- the trained texture64 checkpoint's score, kernels on vs off --------
    agree_texture64 = texture64_agreement(harness_config(""))

    # ---- the paper's other estimators ---------------------------------------
    estimator_paths, agree_estimators, estimator_conv_rows, checked_conv = [], [], [], set(shapes)
    for approach, recipe in ESTIMATORS:
        sample, trained, agree_one, conv_rows_one = run_estimator(approach, recipe, checked_conv)
        estimator_paths += [sample, trained]
        agree_estimators += agree_one
        estimator_conv_rows += conv_rows_one

    # ---- the quality-gated, host-bound phases (the --mode test harness; the toy;
    # the paired callback and the trained pyramid) in three child processes, beside
    # this one's phases up to the inverse problems, none of which times a kernel
    tails = sum(harness_tails.values())
    children = [
        Child("the --mode test harness", [("run_harness", (tails,))]),
        Child("the toy", [("run_toy", ())]),
        Child("the paired callback and the trained pyramid",
              [("run_paired_callback", (tails,)), ("run_pyramid", (chain["pyramid"],))]),
    ]
    try:
        # ---- the unconditional and VP samplers ------------------------------
        main_uncond, train_uncond, agree_uncond = run_unconditional()
        main_vp = [run_vp(name) for name in ("vpsde", "subvpsde")]

        # ---- the multi-scale chains: the sequential chains, direct 8x -------
        sequential_paths, agree_sequential = run_sequential(chain)
        main_direct, agree_direct = run_direct_8x()

        # ---- training as the CLI runs it: the NCSN++ trainer ----------------
        main_ncsnpp_train, main_kxsr_viz = run_ncsnpp_trainer(PER_FORWARD_NCSNPP_PATH)

        # ---- the other samplers: the ODE, bits/dim, inpainting and colorization
        main_ode = run_ode()
        main_bpd = run_bpd()
        projected_paths, agree_haar = run_projected()

        t = time.perf_counter()
        (main_harness,), (main_toy,), (main_paired, (main_pyramid, agree_pyramid)) = [c.join() for c in children]
        phase("child", t, "waited for the children; their lines are above")
    finally:
        for c in children:
            c.stop()
    new_paths = estimator_paths + [main_uncond, train_uncond] + main_vp + [main_pyramid] + sequential_paths
    new_paths += [main_direct, main_toy, main_paired, main_ncsnpp_train, main_kxsr_viz]
    new_paths += [main_ode, main_bpd] + projected_paths

    # ---- the paper's other inverse problems on their texture twins
    inverse_paths, agree_inverse, inverse_rows = run_inverse_problems()
    new_paths += inverse_paths

    # ---- the score_sde baselines on their texture twins
    score_sde_paths, agree_score_sde, score_sde_fir_rows = run_score_sde()
    new_paths += score_sde_paths

    # ---- the celebA multi-scale recipes and the Haar-flow trainer; the perceptual metrics
    multiscale_paths, agree_multiscale, multiscale_rows = run_multiscale_recipes()
    new_paths += multiscale_paths + [run_perceptual()]

    # ---- data parallelism, trace attribution, reference checkpoints, the host batch
    dp_train, dp_sampler = run_data_parallel_trainer(), run_sharded_sampler()
    reference_path, agree_reference = run_reference_checkpoint()
    new_paths += [dp_train, dp_sampler, reference_path, run_host_batch()]

    bf16 = torch.bfloat16
    tail_line = per_forward_row(
        "gn_silu_conv3x3", "conditional_score_diffusion_tpu_torch/csrc/gn_silu_conv3x3.cu",
        "conditional_score_diffusion_tpu/ops/fused_block_pallas.py:107",
        main_new["launches"]["gn_silu_conv3x3"], tail_rows, bf16, "calls_per_forward_block_path",
        "one forward of the bfloat16 block path: the 5 tails at 20x20x192, B=8; library_ms is cuDNN's conv alone",
    )
    tail_line["float32_tail_path"] = per_forward_row(
        "gn_silu_conv3x3", tail_line["source"], tail_line["replaces"],
        main_tail["launches"]["gn_silu_conv3x3"], tail_rows, torch.float32, "calls_per_forward_tail_path",
        "one forward of the float32 tail path: the 17 gated tails, B=8",
    )
    tail_line["float32_texture64_harness"] = per_forward_row(
        "gn_silu_conv3x3", tail_line["source"], tail_line["replaces"],
        main_harness["launches"]["gn_silu_conv3x3"], harness_tail_rows, torch.float32, "calls_per_forward_harness",
        f"one forward of the float32 texture64 harness: its {sum(harness_tails.values())} tails, B={HARNESS_BATCH}",
    )
    kernels = [tail_line]
    for name, line in (("resblock_fused", 269), ("resblock_fused_split", 462)):
        rows = [r for r in block_rows if r["kernel"] == name]
        k = per_forward_row(
            name, "conditional_score_diffusion_tpu_torch/csrc/resblock_fused.cu",
            f"conditional_score_diffusion_tpu/ops/fused_block_pallas.py:{line}",
            main_new["launches"][name], rows, bf16, "calls_per_forward",
            f"one forward of the bfloat16 block path: its {PER_FORWARD_BLOCK_PATH[name]} calls, B=8;"
            " library_ms is cuDNN's two convs + the shortcut matmul",
        )
        k["float32"] = per_forward_row(
            name, k["source"], k["replaces"], k["launches"], rows, torch.float32, "calls_per_forward",
            "the same calls in float32",
        )
        kernels.append(k)
    for name, line in (("fir_upsample2", 131), ("fir_downsample2", 156)):
        rows = [r for r in fir_rows if r["kernel"] == name]
        k = per_forward_row(
            name, "conditional_score_diffusion_tpu_torch/csrc/fir_resample.cu",
            f"conditional_score_diffusion_tpu/ops/pallas_kernels.py:{line}",
            main_ncsnpp["launches"][name], rows, torch.float32, "calls_per_forward",
            f"one forward of the float32 NCSN++ path: its {PER_FORWARD_NCSNPP_PATH[name]} calls, B=8;"
            " ms, plain_ms and library_ms with the operands out of L2 (l2_ms: L2-resident, one input);"
            " library_ms is the depthwise 4x4 cuDNN call",
        )
        k["bfloat16"] = per_forward_row(
            name, k["source"], k["replaces"], k["launches"], rows, bf16, "calls_per_forward",
            "the same calls in bfloat16",
        )
        for line, dtype in ((k, torch.float32), (k["bfloat16"], bf16)):
            line["l2_ms"] = sum(r["l2_ms"] * r["calls_per_forward"] for r in rows if r["dtype"] == dname(dtype))
        ncsnpp32 = next(p for p in score_sde_paths if p["path"] == f"float32 {SCORE_SDE_TWINS[3][0]} sampler")
        k["float32_ncsnpp_32px"] = per_forward_row(
            name, k["source"], k["replaces"], ncsnpp32["launches"][name],
            [r for r in score_sde_fir_rows if r["kernel"] == name], torch.float32, "calls_per_forward",
            f"one forward of the float32 discrete-VE NCSN++ twin (32px, B=8): its"
            f" {SCORE_SDE_FIR_PER_FORWARD[name]} calls; launches are its sampler's",
        )
        kernels.append(k)
    for k in kernels:
        k["per_shape"] = [
            r for r in tail_rows + harness_tail_rows + ncsnpp_tail_rows + block_rows + fir_rows + inverse_rows
            + score_sde_fir_rows + multiscale_rows
            if r.get("kernel", "gn_silu_conv3x3") == k["name"]
        ]
    f32 = conv_sums(conv_rows, torch.float32)
    conv_line = dict(
        name="conv3x3", route="cuda", source="conditional_score_diffusion_tpu_torch/csrc/conv3x3.cu",
        replaces="conditional_score_diffusion_tpu/ops/conv_pallas.py:198",
        launches=main_train["launches"]["conv3x3"],
        max_abs_err=max(r["max_abs_err"] for r in conv_rows if r["dtype"] == "float32"),
        **f32["step"],
        bound_by="operations" if all(r["bound_by"] == "operations" for r in conv_rows if r["dtype"] == "float32")
        else "bytes",
        unit=f"one float32 train step of the flagship, B={TRAIN_BATCH}: {fwd} forward and {dx} dx calls"
             " (the sum over the calls); library_ms is F.conv2d (cuDNN, TF32 off) on the same tensors",
        forward=f32["forward"], dx=f32["dx"], bfloat16=conv_sums(conv_rows, torch.bfloat16), per_shape=conv_rows,
        per_shape_other_trainers=estimator_conv_rows,
    )
    hmajor_f32 = [r for r in hmajor_rows if r["dtype"] == "float32"]
    hmajor_line = dict(
        name="conv3x3_hmajor", route="cuda", source=conv_line["source"],
        replaces="conditional_score_diffusion_tpu/ops/conv_pallas.py:144",
        launches=main_train["launches"]["conv3x3"],
        entry_launches_on_main_path=main_train["launches"]["conv3x3_hmajor"],
        max_abs_err=max(r["max_abs_err"] for r in hmajor_f32),
        **{k: sum(r[k] for r in hmajor_f32) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        bound_by="operations" if all(r["bound_by"] == "operations" for r in hmajor_f32) else "bytes",
        unit="the (H, W, B, C) entry of the conv3x3 kernel (one CUDA kernel, other strides) at its two checked"
             " shapes, float32, one call each; launches counts that CUDA kernel on the trainer path, where"
             " every call comes through the NHWC entry (no path calls the (H, W, B, C) entry, in JAX neither)",
        per_shape=hmajor_rows,
    )
    big = [r for r in act_rows if r["shape"] == [8, 160, 160, 96]]
    act_f32 = next(r for r in big if r["dtype"] == "float32")
    act_line = dict(
        name="fused_leaky_relu", route="cuda", source="conditional_score_diffusion_tpu_torch/csrc/fused_bias_act.cu",
        replaces="conditional_score_diffusion_tpu/ops/pallas_kernels.py:188",
        launches=main_harness["launches"]["fused_leaky_relu"],
        max_abs_err=max(r["max_abs_err"] for r in act_rows if r["dtype"] == "float32"),
        **{k: act_f32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        unit="one float32 call at (8, 160, 160, 96) with a bias; no path calls this op (in JAX neither), so its"
             " launches on the main path are 0; no single PyTorch call computes bias + leaky ReLU + gain, so"
             " library_ms is null",
        bfloat16={k: next(r for r in big if r["dtype"] == "bfloat16")[k] for k in ("ms", "plain_ms", "bound_ms")},
        per_shape=act_rows,
    )
    kernels += [conv_line, hmajor_line, act_line]
    for k in kernels:  # each kernel's launches on the estimator, unconditional and VP paths
        name = "conv3x3" if k["name"] == "conv3x3_hmajor" else k["name"]
        k["launches_other_paths"] = {p["path"]: p["launches"][name] for p in new_paths if p["launches"][name]}
    paths = [main_new, main_tail, main_ncsnpp, main_train, main_train_off, main_harness] + new_paths
    agree += [agree_train, agree_texture64] + agree_estimators + [agree_uncond, agree_pyramid] + agree_sequential
    agree += [agree_direct, agree_haar] + agree_inverse + [agree_score_sde] + agree_multiscale + [agree_reference]
    print(json.dumps({"kernels": kernels, "paths": paths, "agreement": agree}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[2]) if sys.argv[1:2] == ["--child"] else main())
