"""Equirectangular <-> perspective sample grids (numpy, host side), the
bilinear and nearest-neighbour resamples, and the warps over a camera rig
(counterpart of imagine360_tpu/geometry/projection.py; the grid functions
are the same numpy code, so grids, masks and PEs agree bit for bit).

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


def remap_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   border: str = "zero") -> torch.Tensor:
    """Bilinear resample of img [..., H, W] at absolute pixel coords (x, y),
    pixel centres at integers.

    border:
      "zero": out-of-range taps contribute 0 (grid_sample zero padding);
      "wrap": wrap horizontally, clamp vertically (the 360-degree seam).

    Returns [..., *x.shape] in img.dtype."""
    H, W = img.shape[-2], img.shape[-1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = x0i + 1, y0i + 1
    ys = (y0i.clamp(0, H - 1), y1i.clamp(0, H - 1))
    if border == "wrap":
        xs = (torch.remainder(x0i, W), torch.remainder(x1i, W))
        taps = [img[..., ys[j], xs[i]] for j in (0, 1) for i in (0, 1)]
    elif border == "zero":
        xs = (x0i.clamp(0, W - 1), x1i.clamp(0, W - 1))
        vx = [(i >= 0) & (i <= W - 1) for i in (x0i, x1i)]
        vy = [(i >= 0) & (i <= H - 1) for i in (y0i, y1i)]
        zero = torch.zeros((), dtype=img.dtype, device=img.device)
        taps = [torch.where(vx[i] & vy[j], img[..., ys[j], xs[i]], zero)
                for j in (0, 1) for i in (0, 1)]
    else:
        raise ValueError(f"unknown border mode {border!r}")
    v00, v10, v01, v11 = taps
    out = (v00 * ((1 - wx) * (1 - wy)) + v10 * (wx * (1 - wy))
           + v01 * ((1 - wx) * wy) + v11 * (wx * wy))
    return out.to(img.dtype)


def remap_nearest(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  border: str = "zero") -> torch.Tensor:
    """Nearest-neighbour resample of img [..., H, W] at absolute pixel
    coords (x, y) (grid_sample nearest, align_corners=True): rounds half to
    even like jnp.round; out-of-range taps give 0 ("zero") or wrap in x and
    clamp in y ("wrap"). Returns [..., *x.shape]."""
    H, W = img.shape[-2], img.shape[-1]
    xi = torch.round(x).long()
    yi = torch.round(y).long()
    if border == "wrap":
        return img[..., yi.clamp(0, H - 1), torch.remainder(xi, W)]
    valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
    out = img[..., yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
    return torch.where(valid, out, torch.zeros((), dtype=img.dtype, device=img.device))


_REMAPS = {"bilinear": remap_bilinear, "nearest": remap_nearest}


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


# ---------------------------------------------------------------------------
# Warps over a camera rig (torch, on the image's device)
# ---------------------------------------------------------------------------


def _per_view(remap, imgs: torch.Tensor, gx: np.ndarray, gy: np.ndarray, border: str):
    """imgs [c, H, W] (one image for all views) or [m, c, H, W] (one per
    view), grids [m, h, w] -> [m, c, h, w]."""
    x = torch.from_numpy(gx).to(imgs.device)
    y = torch.from_numpy(gy).to(imgs.device)
    if imgs.dim() == 3:
        return remap(imgs, x, y, border=border).transpose(0, 1)
    return torch.stack([remap(imgs[i], x[i], y[i], border=border)
                        for i in range(imgs.shape[0])])


def e2p(e_img: torch.Tensor, cameras, out_hw, mode: str = "bilinear",
        border: str = "zero") -> torch.Tensor:
    """ERP image(s) -> m perspective views.

    e_img: [c, H, W] (broadcast to all views) or [m, c, H, W] (one per view).
    Returns [m, c, h, w]."""
    gx, gy = e2p_grids(cameras, e_img.shape[-2:], out_hw)
    return _per_view(_REMAPS[mode], e_img, gx, gy, border)


def p2e(p_img: torch.Tensor, cameras, out_hw, mode: str = "bilinear",
        border: str = "zero"):
    """Perspective views -> ERP, masked outside each view's frustum.

    p_img: [m, c, h, w]. Returns (equi [m, c, eh, ew], mask [m, eh, ew]
    bool)."""
    gx, gy, mask = p2e_grids(cameras, p_img.shape[-2:], out_hw)
    out = _per_view(_REMAPS[mode], p_img, gx, gy, border)
    m = torch.from_numpy(mask).to(p_img.device)
    return out * m[:, None].to(out.dtype), m


def mp2e(p_imgs: torch.Tensor, cameras, out_hw, mode: str = "bilinear",
         fill_value: float = 1.0) -> torch.Tensor:
    """Multi-view blend into one ERP image with linear ramp weights: per
    view a horizontal triangle-ramp weight image is warped to ERP and used
    as the blend weight; uncovered pixels get `fill_value`.

    p_imgs: [m, c, h, w] -> [c, eh, ew]."""
    m, c, h, w = p_imgs.shape
    ramp = np.zeros((w,), np.float32)
    half = w // 2
    ramp[:half] = np.linspace(0, 1, half)
    ramp[half:] = np.linspace(1, 0, w - half)
    weight = torch.from_numpy(ramp).to(p_imgs.device).expand(m, 1, h, w)
    img_e, _ = p2e(p_imgs, cameras, out_hw, mode=mode, border="wrap")
    wgt_e, _ = p2e(weight, cameras, out_hw, mode=mode, border="wrap")
    num = (img_e * wgt_e).sum(dim=0)
    den = wgt_e.sum(dim=0)
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den[:1] == 0, torch.full_like(num, fill_value), num / safe)
