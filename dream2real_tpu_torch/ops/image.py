"""Image ops (port of the parts of dream2real_tpu/ops/image.py on the
imagine-and-score path): center crop, cv2-exact cubic resize, torchvision-
exact gaussian blur, linear -> sRGB."""

from __future__ import annotations

import numpy as np
import torch


def center_crop_square(img: torch.Tensor) -> torch.Tensor:
    """Center-crop (H, W, ...) to a square of side min(H, W)."""
    h, w = img.shape[0], img.shape[1]
    if h > w:
        start = (h - w) // 2
        return img[start : start + w]
    start = (w - h) // 2
    return img[:, start : start + h]


def _cv2_cubic_weight(x, a: float = -0.75):
    """cv2's bicubic kernel (a = -0.75)."""
    ax = abs(x)
    if ax <= 1.0:
        return (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0
    if ax < 2.0:
        return a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a
    return 0.0


def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) matrix reproducing cv2.INTER_CUBIC sampling (no
    anti-aliasing, replicated border, coefficients quantised to 1/2048 as cv2
    does even for float images)."""
    W = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        frac = src - i0
        ws = [_cv2_cubic_weight(k - frac) for k in range(-1, 3)]
        ws = [round(w * 2048.0) / 2048.0 for w in ws]
        for k, w in zip(range(-1, 3), ws):
            idx = min(max(i0 + k, 0), n_in - 1)
            W[i, idx] += w
    return W


def resize_image(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_CUBIC resize of the leading two spatial dims, as two f32
    matmuls (TF32 is off package-wide)."""
    img = img.to(torch.float32)
    Wr = torch.as_tensor(_cubic_resize_matrix(img.shape[0], out_hw[0]), device=img.device)
    Wc = torch.as_tensor(_cubic_resize_matrix(img.shape[1], out_hw[1]), device=img.device)
    out = torch.tensordot(Wr, img, dims=([1], [0]))  # (h_out, w_in, ...)
    return torch.movedim(torch.tensordot(Wc, out, dims=([1], [1])), 0, 1)


def gaussian_kernel1d(kernel_size: int, sigma: float, dtype=torch.float32, device=None):
    """torchvision's gaussian kernel: normalized exp(-x^2 / (2 sigma^2))."""
    half = (kernel_size - 1) * 0.5
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float32, device=device)
    k = torch.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).to(dtype)


def gaussian_blur(img: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Separable gaussian blur over the last two axes with torchvision's
    internal reflect padding. img: (..., H, W)."""
    k = gaussian_kernel1d(kernel_size, sigma, img.dtype, img.device)
    pad = kernel_size // 2

    def conv_last(x):
        xp = torch.cat(
            [x[..., 1 : pad + 1].flip(-1), x, x[..., -pad - 1 : -1].flip(-1)], dim=-1
        )
        windows = torch.stack(
            [xp[..., i : i + x.shape[-1]] for i in range(kernel_size)], dim=-1
        )
        return windows @ k

    out = conv_last(img)
    return conv_last(out.transpose(-1, -2)).transpose(-1, -2)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer (instant-ngp semantics)."""
    x = torch.clamp(x, 0.0, 1.0)
    lo = x <= 0.0031308
    x_safe = torch.where(lo, torch.full_like(x, 0.0031308), x)
    return torch.where(lo, 12.92 * x, 1.055 * torch.pow(x_safe, 1.0 / 2.4) - 0.055)
