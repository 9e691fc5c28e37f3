"""Equirectangular <-> perspective sample grids (numpy, host side) and the
nearest-neighbour resample used for the shared initial noise (counterpart
of imagine360_tpu/geometry/projection.py; the grid builders are the same
numpy code, so grids, masks and PEs agree bit for bit).

Grid values are absolute pixel coordinates into the source image,
align_corners=True convention. `equi_pix_to_pers_grid` keeps the
reference's scaling of the valid frustum to [0, pw] rather than [0, pw-1].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .sphere import view_rotation

# ---------------------------------------------------------------------------
# Host-side grid builders (numpy, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=512)
def _pers_to_equi_coords_cached(fov: float, theta: float, phi: float,
                                h: int, w: int):
    hfov = float(h) / w * fov
    w_len = np.tan(np.radians(fov / 2.0))
    h_len = np.tan(np.radians(hfov / 2.0))

    x_map = np.ones([h, w], np.float64)
    y_map = np.tile(np.linspace(-w_len, w_len, w), [h, 1])
    z_map = -np.tile(np.linspace(-h_len, h_len, h), [w, 1]).T

    d = np.sqrt(x_map ** 2 + y_map ** 2 + z_map ** 2)
    xyz = np.stack((x_map, y_map, z_map), axis=2) / d[:, :, None]

    R1, R2 = view_rotation(theta, phi)
    xyz = xyz.reshape([h * w, 3]).T
    xyz = (R2 @ (R1 @ xyz)).T
    lat = np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0))
    lon = np.arctan2(xyz[:, 1], xyz[:, 0])

    lon = lon.reshape([h, w])
    lat = -lat.reshape([h, w])
    return lon, lat


def pers_to_equi_coords(fov, theta, phi, h, w):
    """(lon, lat) radians of each perspective pixel on the sphere.

    Matches reference e2p.py:9-36 (`map_pers_coords_to_equi`).
    """
    return _pers_to_equi_coords_cached(float(fov), float(theta), float(phi),
                                       int(h), int(w))


def pers_pix_to_equi_grid(eh, ew, fov, theta, phi, h, w):
    """Absolute ERP pixel coords (x, y) sampled by each perspective pixel.

    Matches reference e2p.py:39-51 (`map_pers_pix_to_equi`).
    """
    lon, lat = pers_to_equi_coords(fov, theta, phi, h, w)
    equ_cx = (ew - 1) / 2.0
    equ_cy = (eh - 1) / 2.0
    x = lon / np.pi * equ_cx + equ_cx
    y = lat / (np.pi / 2) * equ_cy + equ_cy
    return x.astype(np.float32), y.astype(np.float32)


@functools.lru_cache(maxsize=512)
def _equi_pix_to_pers_grid_cached(ph: int, pw: int, fov: float, theta: float,
                                  phi: float, h: int, w: int):
    hfov = float(ph) / pw * fov
    w_len = np.tan(np.radians(fov / 2.0))
    h_len = np.tan(np.radians(hfov / 2.0))

    x, y = np.meshgrid(np.linspace(-180, 180, w), np.linspace(90, -90, h))
    x_map = np.cos(np.radians(x)) * np.cos(np.radians(y))
    y_map = np.sin(np.radians(x)) * np.cos(np.radians(y))
    z_map = np.sin(np.radians(y))
    xyz = np.stack((x_map, y_map, z_map), axis=2)

    R1, R2 = view_rotation(theta, phi)
    R1i, R2i = np.linalg.inv(R1), np.linalg.inv(R2)
    xyz = xyz.reshape([h * w, 3]).T
    xyz = (R1i @ (R2i @ xyz)).T.reshape([h, w, 3])

    front = xyz[:, :, 0] > 0
    # Perspective divide (guard x==0; masked out below anyway).
    denom = np.where(np.abs(xyz[:, :, 0]) < 1e-12, 1e-12, xyz[:, :, 0])
    yy = xyz[:, :, 1] / denom
    zz = xyz[:, :, 2] / denom

    in_fov = ((-w_len < yy) & (yy < w_len) & (-h_len < zz) & (zz < h_len))
    # NOTE: reference scales to [0, pw] / [0, ph] (p2e.py:41-44), not pw-1.
    gx = np.where(in_fov, (yy + w_len) / 2 / w_len * pw, 0.0)
    gy = np.where(in_fov, (-zz + h_len) / 2 / h_len * ph, 0.0)
    mask = in_fov & front
    return gx.astype(np.float32), gy.astype(np.float32), mask


def equi_pix_to_pers_grid(ph, pw, fov, theta, phi, h, w):
    """Per-ERP-pixel sampling coords into a (ph, pw) perspective view + mask.

    Matches reference p2e.py:9-49 (`map_equi_pix_to_pers`).
    """
    return _equi_pix_to_pers_grid_cached(int(ph), int(pw), float(fov),
                                         float(theta), float(phi),
                                         int(h), int(w))


# ---------------------------------------------------------------------------
# Device-side resampling (torch)
# ---------------------------------------------------------------------------


def remap_nearest(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour resample of img [..., H, W] at absolute pixel
    coords (x, y) (grid_sample nearest, align_corners=True, zero border):
    rounds half to even like jnp.round, and out-of-range taps give 0.
    Returns [..., *x.shape]."""
    H, W = img.shape[-2], img.shape[-1]
    xi = torch.round(x).long()
    yi = torch.round(y).long()
    valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
    out = img[..., yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
    return torch.where(valid, out, torch.zeros((), dtype=img.dtype, device=img.device))


# ---------------------------------------------------------------------------
# Grids over a camera rig
# ---------------------------------------------------------------------------


def _rig_fields(cameras) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Accept a CameraRig or a dict with FoV/theta/phi arrays (degrees)."""
    if hasattr(cameras, "fov"):
        return (np.asarray(cameras.fov), np.asarray(cameras.theta),
                np.asarray(cameras.phi))
    return (np.asarray(cameras["FoV"]), np.asarray(cameras["theta"]),
            np.asarray(cameras["phi"]))


def e2p_grids(cameras, equi_hw, out_hw) -> tuple[np.ndarray, np.ndarray]:
    """Stacked [m, h, w] sample grids for ERP -> each perspective view."""
    fovs, thetas, phis = _rig_fields(cameras)
    eh, ew = equi_hw
    h, w = out_hw
    xs, ys = [], []
    for fov, th, ph in zip(fovs, thetas, phis):
        x, y = pers_pix_to_equi_grid(eh, ew, fov, th, ph, h, w)
        xs.append(x)
        ys.append(y)
    return np.stack(xs), np.stack(ys)


def p2e_grids(cameras, pers_hw, out_hw):
    """Stacked [m, eh, ew] grids + masks for perspective views -> ERP."""
    fovs, thetas, phis = _rig_fields(cameras)
    ph, pw = pers_hw
    eh, ew = out_hw
    xs, ys, ms = [], [], []
    for fov, th, p in zip(fovs, thetas, phis):
        x, y, m = equi_pix_to_pers_grid(ph, pw, fov, th, p, eh, ew)
        xs.append(x)
        ys.append(y)
        ms.append(m)
    return np.stack(xs), np.stack(ys), np.stack(ms)
