"""Per-frame camera pitch estimation and perspective -> ERP warping of the
input video (host side; counterpart of
imagine360_tpu/pipeline/elevation.py): estimate a pitch per frame, smooth it
with a least-squares line over the frame index, then warp each frame to ERP
at its fitted pitch, producing pano frames and outpaint masks.

`linear_fit` and `none` need numpy alone. The horizon estimator behind
`geocalib` / `perspectivefields` needs cv2 and raises ImportError without
it.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .anchor import pers_to_erp_frame


def linear_fit_pitch(pitches: Sequence[float]) -> np.ndarray:
    """Closed-form least-squares line over frame index
    (replaces sklearn LinearRegression at inference_dual_p2e.py:286-291)."""
    y = np.asarray(pitches, np.float64)
    x = np.arange(len(y), dtype=np.float64)
    xm, ym = x.mean(), y.mean()
    denom = ((x - xm) ** 2).sum()
    slope = 0.0 if denom == 0 else ((x - xm) * (y - ym)).sum() / denom
    return (ym + slope * (x - xm)).astype(np.float32)


def weighted_linear_fit_pitch(pitches: Sequence[float],
                              weights: Sequence[float]) -> np.ndarray:
    """Weighted least-squares line over frame index; frames with zero weight
    (no estimate) get the fitted value. Degenerate fallbacks: all-zero
    weights -> zeros; exactly one frame with signal -> that frame's pitch
    as a constant."""
    y = np.asarray(pitches, np.float64)
    w = np.asarray(weights, np.float64)
    n = len(y)
    if w.sum() <= 0:
        return np.zeros((n,), np.float32)
    if (w > 0).sum() == 1:
        return np.full((n,), float(y[w > 0][0]), np.float32)
    x = np.arange(n, dtype=np.float64)
    xm = (w * x).sum() / w.sum()
    ym = (w * y).sum() / w.sum()
    denom = (w * (x - xm) ** 2).sum()
    slope = 0.0 if denom == 0 else (w * (x - xm) * (y - ym)).sum() / denom
    return (ym + slope * (x - xm)).astype(np.float32)


def robust_fit_pitch(raw: Sequence[float], weights: Sequence[float],
                     clamp_deg: float = 45.0, min_support: float = 0.5,
                     max_resid_std: float = 5.0,
                     max_scatter: float = 15.0) -> np.ndarray:
    """Weighted linear fit with real-footage guards.

    On the reference's own example clips (tools/elevation_real.py) the
    bare weighted fit extrapolates wildly when horizon evidence is sparse
    or scattered: cherryblossom (69% frames without a detection,
    raw sigma 15.9 deg) fitted -54.8 -> +53.2 deg — beyond the per-frame
    45-deg plausibility clamp — and indoor (raw sigma 20 deg, no true
    horizon) fitted a confident 13.6 -> 31.2 deg ramp from noise. Guards:

    - if fewer than `min_support` of the frames carry evidence, or the
      weighted residual std of the detections against the fitted line
      exceeds `max_resid_std` degrees, the slope is untrustworthy
      extrapolation: fall back to a CONSTANT weighted-median pitch of the
      detected frames (pitch trajectories in handheld/tripod clips are
      near-constant; the reference's linear fit over GeoCalib estimates
      relies on dense, consistent per-frame evidence it gets from a
      learned model, inference_dual_p2e.py:286-291);
    - the returned trajectory is clamped to +-clamp_deg (matching the
      per-frame misdetection clamp in estimate_pitch_horizon).
    """
    y = np.asarray(raw, np.float64)
    w = np.asarray(weights, np.float64)
    n = len(y)
    fit = weighted_linear_fit_pitch(raw, weights)
    det = w > 0
    if det.any():
        # self-contradictory evidence (detections scattered tens of
        # degrees — e.g. indoor furniture edges, raw sigma 20 deg on the
        # reference's indoor.mp4) means there is no real horizon: zero
        # pitch beats committing to a confident misdetection
        ymu = np.average(y[det], weights=w[det])
        scatter = float(np.sqrt(np.average((y[det] - ymu) ** 2,
                                           weights=w[det])))
        if scatter > max_scatter:
            return np.zeros((n,), np.float32)
        support = float(det.mean())
        resid = y[det] - fit[det]
        wstd = float(np.sqrt(np.average(resid ** 2, weights=w[det])))
        if support < min_support or wstd > max_resid_std:
            order = np.argsort(y[det])
            cw = np.cumsum(w[det][order])
            const = float(y[det][order][np.searchsorted(cw, 0.5 * cw[-1])])
            fit = np.full((n,), const, np.float32)
    return np.clip(fit, -clamp_deg, clamp_deg).astype(np.float32)


def estimate_pitch_horizon(frame_u8: np.ndarray,
                           fov_deg: float = 90.0):
    """Self-contained single-frame pitch estimate (degrees) from the visual
    horizon: near-horizontal Hough line segments vote (length-weighted) for
    the horizon row; pitch = atan((y_horizon - cy) / f) with f from the
    pipeline's 90-degree warp FoV. Replaces the reference's external
    GeoCalib CUDA model (inference_dual_p2e.py:263-273) with a classic
    estimator so `angle_adapt: geocalib` configs run with no user code.

    Returns (pitch_degrees, confidence weight in [0, inf)); weight 0 means
    "no horizon evidence in this frame".

    Sign convention matches the reference (positive pitch = camera looking
    up, so the horizon projects BELOW the image center): GeoCalib's
    gravity.rp pitch feeds P2E.Perspective(..., phi) unchanged
    (inference_dual_p2e.py:270-295).
    """
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the horizon pitch estimator needs cv2 (OpenCV); use "
                          "angle_adapt 'linear_fit' or 'none', or pass an estimator "
                          "callable to PitchEstimator") from e

    h, w = frame_u8.shape[:2]
    gray = cv2.cvtColor(frame_u8, cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, 50, 150)
    lines = cv2.HoughLinesP(edges, 1, np.pi / 180, threshold=40,
                            minLineLength=max(16, w // 8), maxLineGap=5)
    if lines is None:
        return 0.0, 0.0
    ys, wts = [], []
    for x1, y1, x2, y2 in np.asarray(lines).reshape(-1, 4):
        dx, dy = float(x2 - x1), float(y2 - y1)
        length = float(np.hypot(dx, dy))
        if length < 1:
            continue
        angle = abs(np.degrees(np.arctan2(dy, dx)))
        angle = min(angle, 180.0 - angle)
        if angle > 10.0:            # not horizon-like
            continue
        ys.append(0.5 * (y1 + y2))
        wts.append(length * np.cos(np.radians(angle)))
    if not ys:
        return 0.0, 0.0
    ys = np.asarray(ys)
    wts = np.asarray(wts)
    # weighted median is robust to off-horizon structure (tables, rooflines)
    order = np.argsort(ys)
    csum = np.cumsum(wts[order])
    y_h = float(ys[order][np.searchsorted(csum, 0.5 * csum[-1])])
    f = (w / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    cy = (h - 1) / 2.0
    pitch = float(np.degrees(np.arctan2(y_h - cy, f)))
    # clamp: horizons outside +-45 deg are nearly always misdetections
    if abs(pitch) > 45.0:
        return 0.0, 0.0
    return pitch, float(wts.sum() / (w * 0.5))


class PitchEstimator:
    """Pluggable per-frame pitch estimation.

    mode:
      "none"      — all zeros (angle_adapt: none)
      "linear_fit"— fit a line through externally provided raw pitches
      "geocalib" / "perspectivefields" — per-frame estimator + linear fit
                    over frame index (reference inference_dual_p2e.py:
                    256-307). The reference calls external CUDA models
                    (GeoCalib via pip; PerspectiveFields via a module absent
                    from its repo). Here a user callable
                    fn(frame_u8) -> pitch_degrees may be injected; without
                    one, the self-contained horizon estimator
                    (estimate_pitch_horizon) runs, so the reference default
                    config works out of the box.
    """

    def __init__(self, mode: str = "linear_fit",
                 estimator: Optional[Callable] = None):
        self.mode = mode
        self.estimator = estimator

    def __call__(self, frames_u8: np.ndarray,
                 raw_pitches: Optional[Sequence[float]] = None) -> np.ndarray:
        n = frames_u8.shape[0]
        if self.mode == "none":
            return np.zeros((n,), np.float32)
        if self.mode in ("geocalib", "perspectivefields"):
            if self.estimator is not None:
                raw = [float(self.estimator(f)) for f in frames_u8]
                return linear_fit_pitch(raw)
            est = [estimate_pitch_horizon(f) for f in frames_u8]
            return robust_fit_pitch([p for p, _ in est],
                                    [w for _, w in est])
        if raw_pitches is None:
            return np.zeros((n,), np.float32)
        return linear_fit_pitch(raw_pitches)


def pers_video_to_pano(frames: np.ndarray, pitches: np.ndarray,
                       pano_hw, fov: float = 90.0, theta: float = 0.0,
                       backend: str = "library", timer=None):
    """frames [F, h, w, 3] in [-1, 1] -> (pano [F, H, W, 3], mask [F, H, W, 1])
    with mask 1 where content must be outpainted
    (reference inference_dual_p2e.py:293-301). The remaps run on the host
    library unless `backend` names numpy; with a StageTimer, the grids and
    remaps are its splits "warp grids" and "warp remap"."""
    F = frames.shape[0]
    panos, masks = [], []
    for i in range(F):
        pano, cover = pers_to_erp_frame(frames[i], fov, theta, float(pitches[i]), pano_hw,
                                        backend, timer, prefix="warp")
        panos.append(pano)
        masks.append((1.0 - cover.astype(np.float32))[..., None])
    return (np.stack(panos).astype(np.float32),
            np.stack(masks).astype(np.float32))
