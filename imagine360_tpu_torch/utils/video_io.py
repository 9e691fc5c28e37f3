"""Video IO and frame helpers (counterpart of
imagine360_tpu/utils/video_io.py).

numpy alone reads and writes `.npy` clips; cv2 or imageio, where installed,
read and write video files, and cv2 draws the mask boundary. Each is
imported inside the function that needs it, so the module imports on a
machine that has neither. The batch resize and the feathered composite run
in torch on a device.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..native import u8_to_model_range
from .device import require_device

VIDEO_SUFFIXES = (".mp4", ".mov", ".webm", ".avi")


def read_video(path: str, num_frames: Optional[int] = None) -> np.ndarray:
    """Read a clip (`.npy` [F, H, W, 3], or a video file through cv2 or
    imageio), uniformly subsampled to num_frames. Returns [F, H, W, 3]
    uint8."""
    if path.endswith(".npy"):
        frames = np.load(path)
    else:
        frames = _read_video_cv2(path) if path.endswith(VIDEO_SUFFIXES) else None
        if frames is None:
            try:
                import imageio.v3 as iio
            except ImportError as e:
                raise ImportError(f"reading {path} needs cv2 or imageio; "
                                  "a .npy clip needs neither") from e
            frames = iio.imread(path)
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    if num_frames is not None and frames.shape[0] != num_frames:
        total = frames.shape[0]
        if total >= num_frames:
            idx = np.linspace(0, total - 1, num_frames).round().astype(int)
        else:
            idx = np.arange(num_frames) % total
        frames = frames[idx]
    return frames[..., :3]


def _read_video_cv2(path: str):
    """[F, H, W, 3] RGB uint8 through OpenCV, or None when cv2 is absent or
    cannot open the file."""
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            return None
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return np.stack(frames) if frames else None


def save_video(frames: np.ndarray, path: str, fps: int = 8) -> str:
    """frames [F, H, W, 3], float in [0, 1] or uint8, written to `path`
    through imageio or cv2; where neither can write a video, the uint8
    frames go to `<path without suffix>.npy`. Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    if not path.endswith(".npy") and (_save_video_imageio(frames, path, fps)
                                      or _save_video_cv2(frames, path, fps)):
        return path
    out = os.path.splitext(path)[0] + ".npy"
    np.save(out, frames)
    return out


def _save_video_imageio(frames: np.ndarray, path: str, fps: int) -> bool:
    try:
        import imageio
    except ImportError:
        return False
    try:
        imageio.mimsave(path, list(frames), fps=fps)
    except (ValueError, OSError, ImportError, RuntimeError):
        return False      # no codec/plugin for this container
    return os.path.exists(path) and os.path.getsize(path) > 0


def _save_video_cv2(frames: np.ndarray, path: str, fps: int) -> bool:
    try:
        import cv2
    except ImportError:
        return False
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        if not vw.isOpened():
            return False
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        vw.release()
    return os.path.exists(path) and os.path.getsize(path) > 0


def to_model_range(frames_u8: np.ndarray, backend: str = "library") -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1], on the host library unless
    `backend` names numpy."""
    return u8_to_model_range(frames_u8, backend=backend)


def from_model_range(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 1] float."""
    return np.clip(frames / 2 + 0.5, 0.0, 1.0)


def resize_bilinear(img: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear resize of one [H, W, C] or [H, W] image, pixel centres at
    half-integers and edge taps clamped: the sampling of cv2.resize with
    INTER_LINEAR. A float image gives float32 within rounding of cv2's; a
    uint8 image is rounded half up, where cv2's fixed-point weights (11
    bits) can land one level away. The port's one resize routine."""
    H, W = img.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])

    def taps(n_in, n_out):
        c = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(c)
        w1 = c - i0
        i0 = i0.astype(np.int64)
        return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w1

    y0, y1, wy = taps(H, oh)
    x0, x1, wx = taps(W, ow)
    src = img.astype(np.float32)
    wy = wy.astype(np.float32).reshape((-1,) + (1,) * (img.ndim - 1))
    rows = src[y0] * (1 - wy) + src[y1] * wy
    wx = wx.astype(np.float32).reshape((1, -1) + (1,) * (img.ndim - 2))
    out = rows[:, x0] * (1 - wx) + rows[:, x1] * wx
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(np.float32)


def resize_bilinear_tensor(frames: torch.Tensor, out_hw) -> torch.Tensor:
    """`resize_bilinear` of a batch [F, H, W, C] on its device:
    F.interpolate, bilinear, align_corners=False, no antialias (half-pixel
    centres, edge taps clamped: the sampling of cv2 INTER_LINEAR), in
    float32; uint8 frames come back uint8, rounded half up."""
    x = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(int(out_hw[0]), int(out_hw[1])),
                      mode="bilinear", align_corners=False, antialias=False)
    x = x.permute(0, 2, 3, 1)
    if frames.dtype == torch.uint8:
        return torch.floor(x + 0.5).clamp_(0, 255).to(torch.uint8)
    return x


def resize_frames(frames: np.ndarray, hw) -> np.ndarray:
    """[F, H, W, C] -> [F, hw[0], hw[1], C], bilinear."""
    return np.stack([resize_bilinear(f, hw) for f in frames])


def draw_mask_boundary(frames: np.ndarray, mask: np.ndarray, color=(1.0, 0.0, 0.0),
                       thickness: int = 2) -> np.ndarray:
    """Overlay the outpaint mask's outer contours on frames, for debugging
    (reference get_boundingbox, animatediff/utils/util.py:114-163).
    frames [F, H, W, 3] in [0, 1]; mask [F, H, W, 1]. Needs cv2."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("draw_mask_boundary needs cv2 (OpenCV) to find and draw the "
                          "mask's contours") from e
    out = frames.copy()
    for f in range(frames.shape[0]):
        m = (mask[f, ..., 0] > 0.5).astype(np.uint8)
        contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        img = np.ascontiguousarray(out[f])
        cv2.drawContours(img, contours, -1, color, thickness)
        out[f] = img
    return out


def gaussian_taps(sigma: float) -> np.ndarray:
    """The 1-D kernel of cv2.GaussianBlur with ksize (0, 0) on a float
    image: round(8 sigma + 1) taps made odd, exp(-x^2 / (2 sigma^2))
    normalised in float64 (cv2.getGaussianKernel), then float32."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (k / k.sum()).astype(np.float32)


def feathered_replace(generated: np.ndarray, source: np.ndarray, mask: np.ndarray,
                      sigma: float = 8.0, device="cuda") -> np.ndarray:
    """Composite the known (input) region back over the generated pano with
    a gaussian-feathered seam (reference replace_video,
    animatediff/utils/util.py:75-111): soft = clip(blur(mask), 0, 1), out =
    generated * soft + source * (1 - soft). All [F, H, W, C] in [0, 1];
    mask [F, H, W, 1], 1 = generated region. The blur is cv2.GaussianBlur's
    with ksize (0, 0) (`gaussian_taps`) and its default border,
    BORDER_REFLECT_101 (torch's "reflect" padding; H and W must exceed
    4 sigma), separable, rows then columns, in float32 on `device` (the
    card unless the caller asks for "cpu"). Returns float32 numpy."""
    dev = require_device(device)
    k = torch.from_numpy(gaussian_taps(sigma)).to(dev)
    r = k.numel() // 2
    m = torch.from_numpy(np.ascontiguousarray(mask[..., 0], np.float32)).to(dev)[:, None]
    m = F.conv2d(F.pad(m, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    m = F.conv2d(F.pad(m, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))
    soft = m.clamp_(0, 1)[:, 0, ..., None]
    gen = torch.from_numpy(np.ascontiguousarray(generated, np.float32)).to(dev)
    src = torch.from_numpy(np.ascontiguousarray(source, np.float32)).to(dev)
    return (gen * soft + src * (1 - soft)).cpu().numpy()
