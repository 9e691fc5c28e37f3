"""Camera rigs: the 20-view icosahedron sampling and pinhole K/R builders.

Mirrors the behavior of reference src/utils/pano.py:35-118 but with a
closed-form Rodrigues (no cv2 dependency) and a batched CameraRig container
that is a pytree-friendly dict of numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .sphere import rodrigues


def icosahedron_rig() -> tuple[np.ndarray, np.ndarray]:
    """20 view directions (theta, phi) in radians, one per icosahedron face.

    Matches reference src/utils/pano.py:35-72 exactly (same face ordering:
    5 up, 5 middle-up, 5 middle-down, 5 down).
    """
    radius_circumscribed = np.sin(2 * np.pi / 5.0)
    radius_inscribed = np.sqrt(3) / 12.0 * (3 + np.sqrt(5))
    radius_midradius = np.cos(np.pi / 5.0)
    step = 2.0 * np.pi / 5.0

    top_phi = np.pi / 2 - np.arccos(radius_inscribed / radius_circumscribed)
    mid_phi = top_phi - 2 * np.arccos(radius_inscribed / radius_midradius)

    thetas, phis = [], []
    for i in range(5):  # top cap
        thetas.append(-np.pi + step / 2.0 + i * step)
        phis.append(top_phi)
    for i in range(5):  # middle-up
        thetas.append(-np.pi + step / 2.0 + i * step)
        phis.append(mid_phi)
    for i in range(5):  # middle-down
        thetas.append(-np.pi + i * step)
        phis.append(-mid_phi)
    for i in range(5):  # bottom cap
        thetas.append(-np.pi + i * step)
        phis.append(-top_phi)
    return np.array(thetas), np.array(phis)


def horizon_rig(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n equally spaced horizontal views (reference pano.py:29-32)."""
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return theta, np.zeros_like(theta)


def random_rig(n: int, rng: np.random.Generator | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """n uniformly random view directions on the sphere
    (reference pano.py:16-26 random_sample_camera)."""
    rng = rng or np.random.default_rng()
    xyz = rng.normal(size=(n, 3))
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True) + 1e-9
    phi = np.arcsin(np.clip(xyz[:, 2], -1, 1))
    theta = np.arctan2(xyz[:, 0], xyz[:, 1])
    return theta, phi


def get_K_R(fov_deg: float, theta_deg: float, phi_deg: float,
            height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Pinhole intrinsics + world rotation for a (FoV, yaw, pitch) view.

    Matches reference src/utils/pano.py:103-118 (yaw about +y, then pitch
    about the yawed +x axis).
    """
    f = 0.5 * width / np.tan(0.5 * np.radians(fov_deg))
    cx = (width - 1) / 2.0
    cy = (height - 1) / 2.0
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], dtype=np.float32)

    y_axis = np.array([0.0, 1.0, 0.0])
    x_axis = np.array([1.0, 0.0, 0.0])
    R1 = rodrigues(y_axis * np.radians(theta_deg))
    R2 = rodrigues((R1 @ x_axis) * np.radians(phi_deg))
    return K, (R2 @ R1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CameraRig:
    """A batch of m cameras. Angles in degrees (matching the reference's
    camera dict built at inference_dual_p2e.py:79-110)."""

    fov: np.ndarray    # [m]
    theta: np.ndarray  # [m] yaw, degrees
    phi: np.ndarray    # [m] pitch, degrees
    height: np.ndarray  # [m] image height per view
    width: np.ndarray   # [m]
    K: np.ndarray      # [m, 3, 3]
    R: np.ndarray      # [m, 3, 3]

    @property
    def num_views(self) -> int:
        return int(self.fov.shape[0])

    @classmethod
    def icosahedron(cls, image_size: int, fov_deg: float = 90.0) -> "CameraRig":
        """The default Imagine360 rig: 20 icosahedron views, square images
        (reference inference_dual_p2e.py:79-110 with FoV 90)."""
        thetas, phis = icosahedron_rig()
        thetas_deg = np.degrees(thetas)
        phis_deg = np.degrees(phis)
        Ks, Rs = [], []
        for t, p in zip(thetas_deg, phis_deg):
            K, R = get_K_R(fov_deg, t, p, image_size, image_size)
            Ks.append(K)
            Rs.append(R)
        m = len(thetas_deg)
        return cls(
            fov=np.full((m,), fov_deg, dtype=np.float32),
            theta=thetas_deg.astype(np.float32),
            phi=phis_deg.astype(np.float32),
            height=np.full((m,), image_size, dtype=np.int32),
            width=np.full((m,), image_size, dtype=np.int32),
            K=np.stack(Ks),
            R=np.stack(Rs),
        )

    def take(self, m: int) -> "CameraRig":
        """First m views (tiny configs / tests)."""
        return CameraRig(self.fov[:m], self.theta[:m], self.phi[:m],
                         self.height[:m], self.width[:m], self.K[:m],
                         self.R[:m])

    def as_dict(self) -> dict:
        return {
            "FoV": self.fov, "theta": self.theta, "phi": self.phi,
            "height": self.height, "width": self.width, "K": self.K, "R": self.R,
        }
