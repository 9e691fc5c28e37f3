"""Equirectangular <-> cubemap conversions (counterpart of
imagine360_tpu/geometry/cubemap.py, the py360convert subset the reference
vendors): `e2c`, `c2e` and the cube layout utilities. Face order is the
'horizon' layout [F R B L U D] concatenated along the width.

The sample grids are host numpy, as in the JAX package; the resampling runs
in torch on `device` (the card unless the caller asks for "cpu") through
geometry/projection.py's remaps. Arrays go in and come out as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import require_device
from .projection import remap_bilinear, remap_nearest

_FACES = ("F", "R", "B", "L", "U", "D")
_REMAPS = {"bilinear": remap_bilinear, "nearest": remap_nearest}


def _xyz_cube(face_w: int):
    """Unit-cube sample directions per face, each [face_w, face_w, 3]
    (x forward, y right, z up)."""
    rng = (np.arange(face_w) + 0.5) / face_w * 2 - 1      # (-1, 1)
    u, v = np.meshgrid(rng, -rng)                         # u right, v up
    ones = np.ones_like(u)
    return {
        "F": np.stack([ones, u, v], -1),
        "R": np.stack([-u, ones, v], -1),
        "B": np.stack([-ones, -u, v], -1),
        "L": np.stack([u, -ones, v], -1),
        "U": np.stack([-v, u, ones], -1),
        "D": np.stack([v, u, -ones], -1),
    }


def _remap(img: np.ndarray, gx: np.ndarray, gy: np.ndarray, mode: str, border: str,
           dev: torch.device) -> np.ndarray:
    """[H, W, C] numpy sampled at grids [h, w] on `dev` -> [h, w, C] numpy."""
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(img, -1, 0))).to(dev)
    x = torch.from_numpy(gx.astype(np.float32)).to(dev)
    y = torch.from_numpy(gy.astype(np.float32)).to(dev)
    return np.moveaxis(_REMAPS[mode](t, x, y, border=border).cpu().numpy(), 0, -1)


def e2c(e_img: np.ndarray, face_w: int = 256, mode: str = "bilinear",
        device="cuda") -> np.ndarray:
    """ERP [H, W, C] -> horizon cubemap [face_w, 6*face_w, C]; the ERP wraps
    in x and clamps in y."""
    dev = require_device(device)
    H, W = e_img.shape[:2]
    gxs, gys = [], []
    for xyz in (_xyz_cube(face_w)[name] for name in _FACES):
        lon = np.arctan2(xyz[..., 1], xyz[..., 0])
        lat = np.arcsin(xyz[..., 2] / np.linalg.norm(xyz, axis=-1))
        gxs.append((lon / (2 * np.pi) + 0.5) * (W - 1))
        gys.append((0.5 - lat / np.pi) * (H - 1))
    # the six faces side by side are one [face_w, 6*face_w] grid
    return _remap(e_img, np.concatenate(gxs, axis=1), np.concatenate(gys, axis=1), mode,
                  "wrap", dev)


def c2e(cubemap: np.ndarray, h: int, w: int, mode: str = "bilinear",
        device="cuda") -> np.ndarray:
    """horizon cubemap [fw, 6*fw, C] -> ERP [h, w, C]; each ERP pixel reads
    its face, taps off the cube image give 0."""
    dev = require_device(device)
    fw = cubemap.shape[0]
    if cubemap.shape[1] != 6 * fw:
        raise ValueError(f"a horizon cubemap is [fw, 6*fw, C], got {cubemap.shape}")
    lon = (np.arange(w) + 0.5) / w * 2 * np.pi - np.pi
    lat = np.pi / 2 - (np.arange(h) + 0.5) / h * np.pi
    lon, lat = np.meshgrid(lon, lat)
    x = np.cos(lat) * np.cos(lon)
    y = np.cos(lat) * np.sin(lon)
    z = np.sin(lat)

    ax = np.argmax(np.abs(np.stack([x, y, z], 0)), axis=0)
    face_idx = np.zeros((h, w), np.int64)
    face_idx[(ax == 0) & (x > 0)] = 0   # F
    face_idx[(ax == 1) & (y > 0)] = 1   # R
    face_idx[(ax == 0) & (x <= 0)] = 2  # B
    face_idx[(ax == 1) & (y <= 0)] = 3  # L
    face_idx[(ax == 2) & (z > 0)] = 4   # U
    face_idx[(ax == 2) & (z <= 0)] = 5  # D

    # per-face (u, v) in (-1, 1)
    uv = np.zeros((h, w, 2))
    eps = 1e-12
    for i, name in enumerate(_FACES):
        m = face_idx == i
        if name == "F":
            uv[m] = np.stack([y[m] / (x[m] + eps), z[m] / (x[m] + eps)], -1)
        elif name == "R":
            uv[m] = np.stack([-x[m] / (y[m] + eps), z[m] / (y[m] + eps)], -1)
        elif name == "B":
            uv[m] = np.stack([y[m] / (x[m] - eps), -z[m] / (x[m] - eps)], -1)
        elif name == "L":
            uv[m] = np.stack([-x[m] / (y[m] - eps), -z[m] / (y[m] - eps)], -1)
        elif name == "U":
            uv[m] = np.stack([y[m] / (z[m] + eps), -x[m] / (z[m] + eps)], -1)
        else:
            uv[m] = np.stack([-y[m] / (z[m] - eps), x[m] / (z[m] - eps)], -1)

    px = (uv[..., 0] + 1) * 0.5 * fw - 0.5
    py = (0.5 - uv[..., 1] * 0.5) * fw - 0.5
    gx = np.clip(px, 0, fw - 1) + face_idx * fw
    gy = np.clip(py, 0, fw - 1)
    return _remap(cubemap, gx, gy, mode, "zero", dev)


def cube_h2list(cube_h: np.ndarray):
    fw = cube_h.shape[0]
    return [cube_h[:, i * fw:(i + 1) * fw] for i in range(6)]


def cube_list2h(faces):
    return np.concatenate(faces, axis=1)


def cube_h2dict(cube_h: np.ndarray):
    return dict(zip(_FACES, cube_h2list(cube_h)))


def cube_dict2h(d):
    return cube_list2h([d[k] for k in _FACES])
