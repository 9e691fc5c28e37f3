"""Spherical math primitives (pure numpy — these run at trace/host time).

The camera/world convention follows the reference implementation
(reference src/utils/Perspective_and_Equirectangular/e2p.py:9-36):
x is the forward axis, y points right, z points up; longitude is measured
around +z from +x toward +y, latitude is arcsin(z) (then negated where the
reference negates).
"""
from __future__ import annotations

import numpy as np


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle rotation vector -> 3x3 rotation matrix (closed form).

    Equivalent to cv2.Rodrigues for a vector input
    (reference e2p.py:25-26 / pano.py:115-116 use cv2.Rodrigues).
    """
    rvec = np.asarray(rvec, dtype=np.float64)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([
        [0.0, -k[2], k[1]],
        [k[2], 0.0, -k[0]],
        [-k[1], k[0], 0.0],
    ])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def lonlat_to_xyz(lon: np.ndarray, lat: np.ndarray) -> np.ndarray:
    """(lon, lat) radians -> unit xyz, stacked on the last axis."""
    x = np.cos(lat) * np.cos(lon)
    y = np.cos(lat) * np.sin(lon)
    z = np.sin(lat)
    return np.stack([x, y, z], axis=-1)


def xyz_to_lonlat(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """unit xyz (last axis 3) -> (lon, lat) radians."""
    lon = np.arctan2(xyz[..., 1], xyz[..., 0])
    lat = np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0))
    return lon, lat


def view_rotation(theta_deg: float, phi_deg: float) -> tuple[np.ndarray, np.ndarray]:
    """The (R1, R2) pair used by the reference perspective<->equirect warps.

    R1 yaws around +z by theta; R2 pitches around the yawed +y axis by -phi
    (reference e2p.py:23-26, p2e.py:23-26).
    """
    y_axis = np.array([0.0, 1.0, 0.0])
    z_axis = np.array([0.0, 0.0, 1.0])
    R1 = rodrigues(z_axis * np.radians(theta_deg))
    R2 = rodrigues((R1 @ y_axis) * np.radians(-phi_deg))
    return R1, R2
