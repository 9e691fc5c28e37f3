"""Image and video quality metrics, PSNR and SSIM, in numpy and scipy on the
host (counterpart of imagine360_tpu/utils/metrics.py)."""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0, win: int = 7) -> float:
    """Mean structural similarity over [..., H, W, C] arrays (uniform window,
    the standard K1/K2 constants, the window's border cropped); a video
    [F, H, W, C] is the mean over its frames."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 4:
        return float(np.mean([ssim(x, y, data_range, win) for x, y in zip(a, b)]))
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    size = (win, win, 1) if a.ndim == 3 else (win, win)

    mu_a = uniform_filter(a, size)
    mu_b = uniform_filter(b, size)
    var_a = uniform_filter(a * a, size) - mu_a ** 2
    var_b = uniform_filter(b * b, size) - mu_b ** 2
    cov = uniform_filter(a * b, size) - mu_a * mu_b

    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    h = win // 2
    return float((num / den)[h:-h, h:-h].mean())
