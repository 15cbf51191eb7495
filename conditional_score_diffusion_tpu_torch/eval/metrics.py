"""PSNR, SSIM, consistency and diversity on NHWC [0, 1] image batches,
copied from the JAX package's `eval/metrics.py`.

Values are scaled to [0, 255] inside, as the reference computes them.  The
JAX functions cast to float64, which JAX runs in float32 (x64 is off); here
they run in float64, as the code asks, with TF32 off (`ops.resize.
full_float32`): SSIM's E[x^2] - mu^2 cancels at [0, 255] scale, so reduced
precision moves it (the JAX package measured 0.795 against 0.881 on the
TPU, `eval/metrics.py:_filter2d_valid`).  Inputs may be tensors or numpy
arrays; results are Python floats or float64 tensors.

LPIPS and FID (`eval/lpips.py`, `eval/inception.py`, `eval/fid.py`) need
pretrained weights that are not in the repo: the harness and the pipeline
compute them where ``CSDT_LPIPS_ALEXNET`` / ``CSDT_LPIPS_LIN`` and
``CSDT_INCEPTION_WEIGHTS`` name local files, and skip them with the JAX
package's notes otherwise (:data:`LPIPS_NOTE`, :data:`LPIPS_LIN_NOTE`,
:data:`FID_NOTE`).
The image-to-image consistency compares Canny edge maps from OpenCV; where
``cv2`` does not import, they skip it with :data:`CANNY_NOTE`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import full_float32, imresize

LPIPS_NOTE = "LPIPS needs AlexNet weights; set CSDT_LPIPS_ALEXNET to a local torchvision alexnet state dict"
LPIPS_LIN_NOTE = "LPIPS needs linear-head weights; set CSDT_LPIPS_LIN to the lpips alex.pth"
FID_NOTE = (
    "FID inception weights not found; set CSDT_INCEPTION_WEIGHTS to a local pt_inception-2015-12-05-6726825d.pth"
)
CANNY_NOTE = "the image-to-image consistency compares OpenCV Canny edge maps, and cv2 does not import"


class ConsistencyUnavailable(NotImplementedError):
    """A task's consistency needs a package that does not import here."""


def _f64(img) -> torch.Tensor:
    return torch.as_tensor(img).double()


def psnr(img1, img2) -> torch.Tensor:
    """Per-image PSNR on [0, 1] NHWC batches (range 255)."""
    x1, x2 = _f64(img1) * 255.0, _f64(img2) * 255.0
    mse = torch.mean((x1 - x2) ** 2, dim=tuple(range(1, x1.ndim)))
    return 20 * torch.log10(255.0 / torch.sqrt(mse))


def mean_psnr(img1, img2) -> float:
    return float(psnr(img1, img2).mean())


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # cv2.getGaussianKernel equivalent
    x = np.arange(size) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    k = k / k.sum()
    return np.outer(k, k).astype(np.float64)


def _filter2d_valid(img: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Depthwise valid-mode correlation of NHWC images with a 2-D window."""
    C = img.shape[-1]
    k = torch.as_tensor(window, dtype=img.dtype, device=img.device)[None, None].repeat(C, 1, 1, 1)
    with full_float32():
        out = F.conv2d(img.permute(0, 3, 1, 2), k, groups=C)
    return out.permute(0, 2, 3, 1)


def ssim(img1, img2) -> torch.Tensor:
    """Per-image MATLAB-equivalent SSIM on [0, 1] NHWC batches: 11x11
    Gaussian with sigma 1.5, valid region, [0, 255] constants, channels
    averaged."""
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    x1, x2 = _f64(img1) * 255.0, _f64(img2) * 255.0
    w = _gaussian_window()

    mu1 = _filter2d_valid(x1, w)
    mu2 = _filter2d_valid(x2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    s1 = _filter2d_valid(x1 * x1, w) - mu1_sq
    s2 = _filter2d_valid(x2 * x2, w) - mu2_sq
    s12 = _filter2d_valid(x1 * x2, w) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return torch.mean(ssim_map, dim=(1, 2, 3))


def mean_ssim(img1, img2) -> float:
    return float(ssim(img1, img2).mean())


def diversity(draws) -> float:
    """Pixel-wise std (population) across sample draws, averaged.
    ``draws``: [D, B, H, W, C]."""
    return float(torch.std(_f64(draws), dim=0, correction=0).mean())


def get_consistency_fn(task: str) -> Callable:
    """Forward-operator consistency of ``task``: super-resolution (bicubic
    down by ``scale``, then PSNR), inpainting (PSNR of the known region) or
    image-to-image (PSNR of Canny edge maps; raises
    :class:`ConsistencyUnavailable` where cv2 does not import)."""
    if task == "super-resolution":

        def consistency_fn(samples, hr_gt, scale):
            lr_fake = imresize(torch.as_tensor(samples), scale=1.0 / scale)
            lr_gt = imresize(torch.as_tensor(hr_gt), scale=1.0 / scale)
            return mean_psnr(lr_fake, lr_gt)

        return consistency_fn

    if task == "inpainting":

        def consistency_fn(samples, gt, mask):
            """mask: 1 inside the inpainted square; compare the known region."""
            keep = 1.0 - torch.as_tensor(mask)
            return mean_psnr(torch.as_tensor(samples) * keep, torch.as_tensor(gt) * keep)

        return consistency_fn

    if task == "image-to-image":
        try:
            import cv2
        except ImportError:
            raise ConsistencyUnavailable(CANNY_NOTE) from None

        def consistency_fn(samples, gt):
            def edges(img):
                u8 = np.clip(torch.as_tensor(img).detach().cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
                out = []
                for i in range(u8.shape[0]):
                    gray = cv2.cvtColor(u8[i], cv2.COLOR_RGB2GRAY)
                    blur = cv2.GaussianBlur(gray, (3, 3), sigmaX=0.5, sigmaY=0.5)
                    out.append(cv2.Canny(blur.astype(np.uint8), 10, 100, L2gradient=True))
                return np.stack(out).astype(np.float32)[..., None] / 255.0

            return mean_psnr(edges(samples), edges(gt))

        return consistency_fn

    raise NotImplementedError(f"The forward operator for task {task!r} is not supported.")
