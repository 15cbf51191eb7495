"""Callbacks run by `Trainer.fit` after every step (JAX `training/callbacks.py`).

The registry holds the JAX names.  ``configuration``,
``decreasing_variance_configuration``, ``ema`` and ``test_paired`` are no-op
markers, as in JAX: the SDE, the sigma_y anneal and the EMA live in the
train step, and ``--mode test`` runs the harness.  The visualization
callbacks sample on a schedule (``training.visualization_freq``, 0 for
``snapshot_freq``) and hand the writer what the JAX ones hand theirs, with
the same tags: image grids (``add_image``, CHW in [0, 1]), a filmstrip of
at most 16 frames in place of a video (JAX's own fallback without moviepy),
the 2-D samples (``add_points``) and the score norm against t
(``add_curve``) as data where JAX draws a figure.

A callback samples from the EMA weights: a copy of the live model with
them loaded, in eval mode, under ``torch.no_grad`` (:func:`ema_model`).  The
live model, its train mode, the optimizer and the EMA are never touched,
so an exception half way leaves training as it was; the copy goes at the
end of the call.  No gradient flows, so the eval kernels (tail, block, FIR)
fire where their gates hold.

Randomness: JAX samples with ``jax.random.key(step)`` (and folds
``int(t * 1e3)`` in for `GradientVisualization`); here a `torch.Generator`
is seeded from the same integers (:func:`callback_noise`).  A trainer with
a ``callback_noise(step, *fold)`` attribute supplies the noise source
instead (the parity tests replay the JAX draws through it).

Sampling uses the full ``model.num_scales`` steps unless the recipe sets
``training.visualization_p_steps``: the reverse-diffusion predictor
discretizes against the SDE's own N, so fewer steps leave the grids noise.

The image helpers (`image_grid`, `_normalise_per_image`, `haar_supergrid`)
also serve the multi-scale chain (`eval/multiscale.py`).
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import registry
from ..ops import haar as haar_ops
from ..sampling.pc import gaussian_noise
from . import tasks

register_callback = registry.callbacks.register
get_callback = registry.callbacks.get


def _viz_p_steps(config) -> int:
    """Predictor steps of a visualization sample: ``training.
    visualization_p_steps`` where set, else the full ``model.num_scales``."""
    return int(config.training.get("visualization_p_steps", 0) or config.model.num_scales)


def image_grid(images: np.ndarray, nrow: Optional[int] = None) -> np.ndarray:
    """``[B, H, W, C]`` in [0, 1] -> one ``[H', W', C]`` grid, ``nrow``
    images a row (torchvision's ``make_grid`` without padding), clipped to
    [0, 1]; unfilled cells are 1."""
    B, H, W, C = images.shape
    nrow = nrow or int(math.ceil(math.sqrt(B)))
    ncol = int(math.ceil(B / nrow))
    grid = np.ones((ncol * H, nrow * W, C), dtype=np.float32)
    for i in range(B):
        r, c = divmod(i, nrow)
        grid[r * H : (r + 1) * H, c * W : (c + 1) * W] = np.clip(images[i], 0, 1)
    return grid


def _normalise_per_image(x: np.ndarray) -> np.ndarray:
    """Each image of ``[B, H, W, C]`` min-max scaled to [0, 1]."""
    lo = x.min(axis=(1, 2, 3), keepdims=True)
    hi = x.max(axis=(1, 2, 3), keepdims=True)
    return (x - lo) / (hi - lo + 1e-8)


def haar_supergrid(coeffs: np.ndarray) -> np.ndarray:
    """The four Haar bands of band-major ``[B, H, W, 4C]`` coefficients as a
    2x2 supergrid per image, each band min-max scaled over the batch, then
    gridded."""
    C = coeffs.shape[-1] // 4
    bands = [coeffs[..., i * C : (i + 1) * C] for i in range(4)]
    bands = [(b - b.min()) / (b.max() - b.min() + 1e-8) for b in bands]
    top = np.concatenate(bands[:2], axis=2)
    bot = np.concatenate(bands[2:], axis=2)
    return image_grid(np.concatenate([top, bot], axis=1))


def _joint_evolution_frames(evolution, max_frames: int = 100) -> np.ndarray:
    """``{'x', 'y'}`` of ``[T, B, H, W, C]`` -> ``[T', gH, gW, 3]`` frames: at
    most ``max_frames`` steps, each image min-max scaled per frame, y | x
    side by side, gridded."""
    ex = _host(evolution["x"])
    ey = _host(evolution["y"])
    stride = max(1, ex.shape[0] // max_frames)
    frames = []
    for t in range(0, ex.shape[0], stride):
        joint = np.concatenate(
            [_normalise_per_image(ey[t])[..., :3], _normalise_per_image(ex[t])[..., :3]], axis=2
        )
        frames.append(image_grid(joint))
    return np.stack(frames)


def _nearest_up(x: np.ndarray, factor: int) -> np.ndarray:
    """Nearest-neighbour upsample of NHWC ``x`` by an integer ``factor``."""
    return np.repeat(np.repeat(x, factor, axis=1), factor, axis=2)


def _paired3d_rows(yv: np.ndarray, samples: np.ndarray, gv: np.ndarray, axis: int):
    """The middle slice along ``axis`` of the volumes ``[B, D, H, W, C]`` as
    a y | sample | ground-truth grid (gray made RGB), and the fly-through
    frames: every slice along ``axis``, each volume's slice min-max scaled
    per image."""
    mid = samples.shape[axis] // 2
    rows = np.concatenate([np.take(v, mid, axis=axis) for v in (yv, samples, gv)], axis=2)
    if rows.shape[-1] == 1:
        rows = np.repeat(rows, 3, axis=-1)
    frames = []
    for i in range(samples.shape[axis]):
        f = np.concatenate([_normalise_per_image(np.take(v, i, axis=axis)) for v in (yv, samples, gv)], axis=2)
        if f.shape[-1] == 1:
            f = np.repeat(f, 3, axis=-1)
        frames.append(image_grid(f, nrow=1))
    return image_grid(rows, nrow=1), np.stack(frames)


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _log_image(trainer, tag: str, grid_hwc: np.ndarray, step: int):
    if trainer.writer is not None:
        trainer.writer.add_image(tag, np.transpose(grid_hwc, (2, 0, 1)), step)


def _log_video(trainer, tag: str, frames_thwc: np.ndarray, step: int, fps: int = 50):
    """An evolution video as JAX logs it without moviepy: a filmstrip of at
    most 16 evenly strided frames side by side, under ``{tag}/filmstrip``."""
    if trainer.writer is None:
        return
    frames = np.clip(frames_thwc, 0, 1)
    stride = max(1, frames.shape[0] // 16)
    strip = np.concatenate(list(frames[::stride]), axis=1)  # [H, T' * W, C]
    _log_image(trainer, f"{tag}/filmstrip", strip, step)


def callback_noise(trainer, step: int, *fold: int):
    """The noise source of a callback's draws at ``step`` (``fold``: the
    integers JAX folds into ``key(step)``): ``trainer.callback_noise`` where
    the trainer has one, else a generator on the trainer's device seeded
    from the same integers."""
    hook = getattr(trainer, "callback_noise", None)
    if hook is not None:
        return hook(step, *fold)
    seed = step
    for f in fold:
        seed = seed * 1_000_003 + f
    return gaussian_noise(torch.Generator(device=trainer.device).manual_seed(seed % (2**63 - 1)))


@contextlib.contextmanager
def ema_model(trainer):
    """A copy of the trainer's model holding its EMA weights, in eval mode,
    with autograd off for the block (JAX samples from
    ``trainer.state.ema.params``); the live model is left as it is."""
    live = trainer.state.model
    model = copy.deepcopy(live)
    try:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.requires_grad_(False)
                p.copy_(trainer.state.ema.params[name])
            yield model.eval()
    finally:
        del model


def _val_batch(trainer, batch_size: int):
    return next(trainer.datamodule.val_iterator(batch_size=batch_size))


class _FreqGated:
    """Call ``fn(trainer, step)`` at the steps divisible by
    ``training.visualization_freq`` (0: ``training.snapshot_freq``)."""

    def __init__(self, config, fn: Callable):
        freq = config.training.get("visualization_freq", 0)
        self.freq = freq or config.training.get("snapshot_freq", 5000)
        self.fn = fn

    def __call__(self, trainer, step: int):
        if step % self.freq == 0:
            self.fn(trainer, step)


@register_callback(name="configuration")
def configuration_callback(config, phase: str = "train"):
    """No-op marker: the SDE and the loss are configured in the train step."""
    return lambda trainer, step: None


@register_callback(name="decreasing_variance_configuration")
def dv_configuration_callback(config, phase: str = "train"):
    """No-op marker: the sigma_y schedule is evaluated in the train step
    and logged by the Trainer."""
    return lambda trainer, step: None


@register_callback(name="ema")
def ema_callback(config, phase: str = "train"):
    """No-op marker: the EMA is part of the train state."""
    return lambda trainer, step: None


@register_callback(name="base")
def image_visualization_callback(config, phase: str = "train"):
    """A grid of ``min(16, eval.batch_size)`` samples
    (``generated_images``); with ``training.show_evolution`` the first
    sample's trajectory (``generation_evolution``)."""
    show_evo = config.training.get("show_evolution", False)

    def fn(trainer, step):
        n = min(16, config.eval.batch_size)
        with ema_model(trainer) as model:
            task = tasks.create_task(config, model)
            sampling_fn = task.sampling_fn(_sample_shape(config, n), p_steps=_viz_p_steps(config))
            samples, info = sampling_fn(callback_noise(trainer, step), model, show_evolution=show_evo)
        _log_image(trainer, "generated_images", image_grid(_host(samples)), step)
        if show_evo and "evolution" in info:
            _log_video(trainer, "generation_evolution", _host(info["evolution"])[:, 0], step)

    return _FreqGated(config, fn)


@register_callback(name="2D")
def two_d_visualization_callback(config, phase: str = "train"):
    """512 samples of a 2-D model (``samples_2d``; JAX plots them)."""

    def fn(trainer, step):
        with ema_model(trainer) as model:
            task = tasks.create_task(config, model)
            sampling_fn = task.sampling_fn((512, 2), p_steps=_viz_p_steps(config))
            samples, _ = sampling_fn(callback_noise(trainer, step), model)
        if trainer.writer is not None:
            trainer.writer.add_points("samples_2d", _host(samples), step)

    return _FreqGated(config, fn)


@register_callback(name="GradientVisualization")
def gradient_visualization_callback(config, phase: str = "train"):
    """The mean score norm of 16 prior draws at 20 times in [1e-3, 1]
    (``score_norm_vs_t``; JAX plots it)."""

    def fn(trainer, step):
        from ..models.wrappers import get_score_fn
        from ..sde import build_sde

        sde, _ = build_sde(config)
        shape = _sample_shape(config, 16)
        ts = np.linspace(1e-3, 1.0, 20)
        norms = []
        with ema_model(trainer) as model:
            score_fn = get_score_fn(sde, model, conditional=False, train=False, continuous=config.training.continuous)
            for t in ts:
                vec_t = torch.full((shape[0],), float(t), device=trainer.device)
                x = sde.prior_sampling(callback_noise(trainer, step, int(t * 1e3)), shape).to(trainer.device)
                s = score_fn(x, vec_t)
                norms.append(float(torch.linalg.vector_norm(s.reshape(s.shape[0], -1), dim=-1).mean()))
        if trainer.writer is not None:
            trainer.writer.add_curve("score_norm_vs_t", ts, np.asarray(norms), step)

    return _FreqGated(config, fn)


@register_callback(name="paired")
def paired_visualization_callback(config, phase: str = "train"):
    """y | sample | ground truth for ``min(8, eval.batch_size)`` images of
    the eval split, a row each (``paired_y_sample_gt``); with
    ``training.show_evolution`` the joint y | x trajectory
    (``val_joint_evolution``)."""
    show_evolution = config.training.get("show_evolution", False)

    def fn(trainer, step):
        batch = _val_batch(trainer, min(8, config.eval.batch_size))
        y = torch.from_numpy(batch["y"]).to(trainer.device)
        shape = (y.shape[0],) + _xshape(config)
        with ema_model(trainer) as model:
            task = tasks.create_task(config, model)
            sampling_fn = task.sampling_fn(shape, p_steps=_viz_p_steps(config))
            samples, info = sampling_fn(callback_noise(trainer, step), model, y, show_evolution=show_evolution)
        rows = np.concatenate([batch["y"][..., :3], np.clip(_host(samples), 0, 1), batch["x"]], axis=2)
        _log_image(trainer, "paired_y_sample_gt", image_grid(rows, nrow=1), step)
        if show_evolution and "evolution" in info:
            _log_video(trainer, "val_joint_evolution", _joint_evolution_frames(info["evolution"]), step)

    return _FreqGated(config, fn)


@register_callback(name="haar_multiscale")
def haar_multiscale_callback(config, phase: str = "train"):
    """4 samples of Haar coefficients as band supergrids
    (``haar_supergrid``) and as images (``haar_reconstructed``); with
    ``training.show_evolution`` the supergrid trajectory
    (``haar_super_grid_evolution``)."""
    show_evolution = config.training.get("show_evolution", False)

    def fn(trainer, step):
        with ema_model(trainer) as model:
            task = tasks.create_task(config, model)
            sampling_fn = task.sampling_fn(_sample_shape(config, 4), p_steps=_viz_p_steps(config))
            coeffs, info = sampling_fn(callback_noise(trainer, step), model, show_evolution=show_evolution)
            imgs = _host(haar_ops.haar_backward(coeffs))
        coeffs = _host(coeffs)
        _log_image(trainer, "haar_supergrid", haar_supergrid(coeffs), step)
        imgs = (imgs - imgs.min()) / (imgs.max() - imgs.min() + 1e-8)
        _log_image(trainer, "haar_reconstructed", image_grid(imgs), step)
        if show_evolution and "evolution" in info:
            evo = _host(info["evolution"])
            stride = max(1, evo.shape[0] // 100)
            frames = np.stack([haar_supergrid(evo[t]) for t in range(0, evo.shape[0], stride)])
            _log_video(trainer, "haar_super_grid_evolution", frames, step)

    return _FreqGated(config, fn)


@register_callback(name="conditional_haar_multiscale")
def conditional_haar_multiscale_callback(config, phase: str = "train"):
    """The detail bands of 4 eval images sampled given their DC band,
    inverse-Haar to images: upsampled DC | sample | ground truth, each
    min-max scaled per image (``conditional_haar_samples``)."""
    show_evolution = config.training.get("show_evolution", False)

    def fn(trainer, step):
        batch = _val_batch(trainer, min(4, config.eval.batch_size))
        y, x_gt = (torch.from_numpy(batch[k]).to(trainer.device) for k in ("y", "x"))
        shape = (y.shape[0],) + _xshape(config)
        with ema_model(trainer) as model:
            task = tasks.create_task(config, model)
            sampling_fn = task.sampling_fn(shape, p_steps=_viz_p_steps(config))
            sampled_hf, _ = sampling_fn(callback_noise(trainer, step), model, y, show_evolution=show_evolution)
            orig = _host(haar_ops.haar_backward(torch.cat([y, x_gt], dim=-1)))
            sampled = _host(haar_ops.haar_backward(torch.cat([y, sampled_hf.to(y.dtype)], dim=-1)))
        dc_interp = _nearest_up(batch["y"], 2)[..., :3]
        rows = np.concatenate([_normalise_per_image(v) for v in (dc_interp, sampled, orig)], axis=2)
        _log_image(trainer, "conditional_haar_samples", image_grid(rows, nrow=1), step)

    return _FreqGated(config, fn)


def _sr_visualization(config, factor_fn, tag):
    """LR (nearest-neighbour up by ``factor_fn(config)``) | SR sample |
    ground truth for 4 eval images, each min-max scaled per image."""
    show_evolution = config.training.get("show_evolution", False)

    def fn(trainer, step):
        batch = _val_batch(trainer, min(4, config.eval.batch_size))
        y = torch.from_numpy(batch["y"]).to(trainer.device)
        shape = (y.shape[0],) + _xshape(config)
        with ema_model(trainer) as model:
            task = tasks.create_task(config, model)
            sampling_fn = task.sampling_fn(shape, p_steps=_viz_p_steps(config))
            samples, _ = sampling_fn(callback_noise(trainer, step), model, y, show_evolution=show_evolution)
        up_y = _nearest_up(batch["y"], factor_fn(config))
        rows = np.concatenate([_normalise_per_image(v) for v in (up_y, _host(samples), batch["x"])], axis=2)
        _log_image(trainer, tag, image_grid(rows, nrow=1), step)

    return _FreqGated(config, fn)


@register_callback(name="bicubic_SR")
def bicubic_sr_callback(config, phase: str = "train"):
    return _sr_visualization(config, lambda c: 2, "bicubic_SR_samples")


@register_callback(name="KxSR")
def kx_sr_callback(config, phase: str = "train"):
    return _sr_visualization(config, lambda c: int(c.data.get("scale", 2)), "KxSR_samples")


@register_callback(name="2DVisualization")
def two_d_visualization_alias(config, phase: str = "train"):
    """The reference's registry name of the 2-D callback."""
    return two_d_visualization_callback(config, phase)


@register_callback(name="test_paired")
def test_paired_callback(config, phase: str = "train"):
    """No-op marker at train time: ``--mode test`` runs the harness
    (`eval/harness.py:run_test`)."""
    return lambda trainer, step: None


@register_callback(name="paired3D")
def paired3d_visualization_callback(config, phase: str = "train"):
    """Volumes: the reconstruction error of 2 eval volumes sampled by the
    recipe's 3-D model (``ddpm3D_paired``; at most 100 steps) against their
    ground truth (``val_rec_loss_pc``), and along each axis the middle
    slice's y | sample | ground truth (``paired3D_{axis}``) and a
    fly-through (``paired_video_dim_{axis}``)."""

    def fn(trainer, step):
        batch = _val_batch(trainer, 2)
        y = torch.from_numpy(batch["y"]).to(trainer.device)
        shape = (y.shape[0],) + _xshape(config)
        with ema_model(trainer) as model:
            task = tasks.create_task(config, model)
            sampling_fn = task.sampling_fn(shape, p_steps=min(100, config.model.num_scales))
            samples, _ = sampling_fn(callback_noise(trainer, step), model, y)
        samples = np.clip(_host(samples), 0, 1)
        gv = batch["x"]
        if trainer.writer is not None:
            trainer.writer.add_scalar("val_rec_loss_pc", float(np.mean(np.abs(gv - samples))), step)
        for axis, name in [(1, "axial"), (2, "coronal"), (3, "sagittal")]:
            grid, frames = _paired3d_rows(batch["y"], samples, gv, axis)
            _log_image(trainer, f"paired3D_{name}", grid, step)
            _log_video(trainer, f"paired_video_dim_{name}", frames, step, fps=10)

    return _FreqGated(config, fn)


def _xshape(config):
    """One sample's shape, channels last, from the recipe's channels-first
    ``data.shape_x`` (or ``data.shape``): (H, W, C), or (H, W, D, C) for a
    volume, where JAX's unpacks three entries and fails."""
    c, *spatial = config.data.shape_x if "shape_x" in config.data else config.data.shape
    return tuple(spatial) + (c,)


def _sample_shape(config, n):
    return (n,) + _xshape(config)


def get_callbacks(config, phase: str = "train") -> List[Callable]:
    """The callbacks of a phase (JAX `get_callbacks`): the configuration
    marker (VS-CMDE's for a decreasing-variance recipe), ``ema``, and the
    recipe's ``training.visualization_callback``; none outside training."""
    if phase != "train":
        return []
    from .schedules import is_decreasing_variance

    names = ["decreasing_variance_configuration" if is_decreasing_variance(config) else "configuration", "ema"]
    viz = config.training.get("visualization_callback", None)
    if viz:
        if viz not in registry.callbacks:
            raise ValueError(f"Unknown visualization_callback: {viz!r}; registered: {registry.callbacks.names()}")
        names.append(viz)
    return [get_callback(n)(config, phase) for n in names]
