"""Image metrics and PNG helpers: SSIM for golden-image tests.

Port of ``raytracerfacility_tpu/utils/image.py`` (``ssim``, ``mse``,
``write_png``, ``read_png``), unchanged: host numpy in float64.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable valid-mode convolution over the first two axes."""
    from numpy.lib.stride_tricks import sliding_window_view

    k = kernel.size
    win = sliding_window_view(img, k, axis=0)
    img = np.tensordot(win, kernel, axes=([-1], [0]))
    win = sliding_window_view(img, k, axis=1)
    return np.tensordot(win, kernel, axes=([-1], [0]))


def ssim(
    a: np.ndarray,
    b: np.ndarray,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
) -> float:
    """Mean structural similarity (Wang et al. 2004) over HxW[xC] images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"ssim of images of shapes {a.shape} and {b.shape}")
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    kernel = _gaussian_kernel(kernel_size, sigma)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    values = []
    for c in range(a.shape[-1]):
        x = a[..., c]
        y = b[..., c]
        mu_x = _filter2d(x, kernel)
        mu_y = _filter2d(y, kernel)
        mu_xx = mu_x * mu_x
        mu_yy = mu_y * mu_y
        mu_xy = mu_x * mu_y
        sigma_xx = _filter2d(x * x, kernel) - mu_xx
        sigma_yy = _filter2d(y * y, kernel) - mu_yy
        sigma_xy = _filter2d(x * y, kernel) - mu_xy
        s = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
            (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
        )
        values.append(s.mean())
    return float(np.mean(values))


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def write_png(path: str, image: np.ndarray) -> None:
    """Gamma-encoded [0, 1] float image -> PNG (the screenshot export,
    ref RayTracerCamera.cpp:38-41): clip, scale by 255, truncate."""
    from PIL import Image

    arr = (np.clip(np.asarray(image)[..., :3], 0.0, 1.0) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), np.float32) / 255.0
