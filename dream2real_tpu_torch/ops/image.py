"""Image ops (port of dream2real_tpu/ops/image.py): erosion and dilation with
a square all-ones kernel, center crop, cv2-exact cubic resize, depth / mask
rectification to the CLIP view, torchvision-exact gaussian blur, linear <->
sRGB."""

from __future__ import annotations

import numpy as np
import torch


def _window_extreme(x: torch.Tensor, k: int, take_min: bool,
                    cv2_anchor: bool = False) -> torch.Tensor:
    """Min (max) of x over a k x k window of its last two axes, placed as
    ``lax.reduce_window(..., "SAME")`` places it: (k - 1) // 2 before and
    k // 2 after each pixel, or with ``cv2_anchor`` as cv2 anchors it, k // 2
    before (the two sit one pixel apart for even k). Outside the image the
    window sees the identity of the reduction (+-inf, the integer dtype's
    max / min, True / False)."""
    if x.dtype == torch.bool:
        fill, op = take_min, (torch.logical_and if take_min else torch.logical_or)
    elif x.dtype.is_floating_point:
        fill, op = (float("inf") if take_min else float("-inf")), (
            torch.minimum if take_min else torch.maximum)
    else:
        info = torch.iinfo(x.dtype)
        fill, op = (info.max if take_min else info.min), (
            torch.minimum if take_min else torch.maximum)
    lo, hi = (k - 1) // 2, k // 2
    if cv2_anchor:
        lo, hi = hi, lo
    for axis in (-2, -1):
        n = x.shape[axis]
        pad_shape = list(x.shape)
        pad_shape[axis] = lo
        before = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
        pad_shape[axis] = hi
        after = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
        xp = torch.cat([before, x, after], dim=axis)
        out = xp.narrow(axis, 0, n)
        for i in range(1, k):
            out = op(out, xp.narrow(axis, i, n))
        x = out
    return x


def erode(mask: torch.Tensor, kernel_size: int, cv2_anchor: bool = False) -> torch.Tensor:
    """Erosion with an all-ones square kernel over the last two axes of a
    (..., H, W) float, integer or bool tensor (the JAX package's erode;
    cv2.erode's placement with ``cv2_anchor``)."""
    return _window_extreme(mask, kernel_size, take_min=True, cv2_anchor=cv2_anchor)


def dilate(mask: torch.Tensor, kernel_size: int, cv2_anchor: bool = False) -> torch.Tensor:
    """Dilation with an all-ones square kernel over the last two axes of a
    (..., H, W) float, integer or bool tensor (the JAX package's dilate;
    cv2.dilate's placement with ``cv2_anchor``)."""
    return _window_extreme(mask, kernel_size, take_min=False, cv2_anchor=cv2_anchor)


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


def rectify_depth(depth: torch.Tensor, resolution: int = 336) -> torch.Tensor:
    """GT depth (H, W) -> CLIP-view depth (res, res): center crop + cubic."""
    return resize_image(center_crop_square(depth), (resolution, resolution))


def rectify_mask(mask: torch.Tensor, resolution: int = 336) -> torch.Tensor:
    """GT mask (H, W) -> CLIP-view mask (res, res), resized as float; the
    caller compares against 0."""
    return resize_image(center_crop_square(mask.to(torch.float32)), (resolution, resolution))


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


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear transfer (the training targets)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92, torch.pow((x + 0.055) / 1.055, 2.4))
