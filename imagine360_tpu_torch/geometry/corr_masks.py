"""Cross-branch attention bias masks + spherical positional encodings
(numpy copy of imagine360_tpu/geometry/corr_masks.py, so both mask
variants and the PEs equal the JAX package's bit for bit).

The masks are computed once per (camera rig, resolution) from the analytic
bilinear footprints of the warp grids, cached, and moved to the device by
pipeline/sampler.build_dual_warp_geoms. The stochastic antipodal variant is
a second precomputed bias tensor, chosen per step and site.
"""
from __future__ import annotations

import functools

import numpy as np
from scipy.ndimage import convolve1d

from .projection import e2p_grids, p2e_grids, pers_to_equi_coords


# ---------------------------------------------------------------------------
# Bilinear footprint scatter
# ---------------------------------------------------------------------------


def _footprint_scatter(gx, gy, src_h, src_w, valid=None):
    """Given sample grids gx/gy [m, oh, ow] into a (src_h, src_w) image,
    build dense footprint[m, src_h*src_w, oh*ow]: the bilinear weight each
    source pixel contributes to each output pixel (zero border: taps outside
    the source are dropped, matching kornia remap padding_mode='zeros')."""
    m, oh, ow = gx.shape
    out = np.zeros((m, src_h * src_w, oh * ow), np.float32)
    x0 = np.floor(gx)
    y0 = np.floor(gy)
    wx = gx - x0
    wy = gy - y0
    o_idx = np.broadcast_to(np.arange(oh * ow).reshape(1, oh, ow), gx.shape)
    v_idx = np.broadcast_to(np.arange(m).reshape(m, 1, 1), gx.shape)
    for dy, dx, w in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                      (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        xi = x0.astype(np.int64) + dx
        yi = y0.astype(np.int64) + dy
        ok = (xi >= 0) & (xi < src_w) & (yi >= 0) & (yi < src_h)
        if valid is not None:
            ok = ok & valid
        s_idx = np.clip(yi, 0, src_h - 1) * src_w + np.clip(xi, 0, src_w - 1)
        np.add.at(out, (v_idx[ok], s_idx[ok], o_idx[ok]),
                  w.astype(np.float32)[ok])
    return out


def _rig_key(cameras) -> tuple:
    if hasattr(cameras, "fov"):
        f, t, p = cameras.fov, cameras.theta, cameras.phi
    else:
        f, t, p = cameras["FoV"], cameras["theta"], cameras["phi"]
    return (tuple(np.asarray(f, np.float64).tolist()),
            tuple(np.asarray(t, np.float64).tolist()),
            tuple(np.asarray(p, np.float64).tolist()))


class _RigView:
    """Hashable lightweight rig for lru_cache keys."""

    def __init__(self, key):
        self.fov = np.array(key[0])
        self.theta = np.array(key[1])
        self.phi = np.array(key[2])

    def __hash__(self):
        return hash((self.fov.tobytes(), self.theta.tobytes(),
                     self.phi.tobytes()))

    def __eq__(self, other):
        return (np.array_equal(self.fov, other.fov)
                and np.array_equal(self.theta, other.theta)
                and np.array_equal(self.phi, other.phi))

    def shifted(self, dtheta):
        k = (tuple(self.fov.tolist()),
             tuple((self.theta + dtheta).tolist()),
             tuple(self.phi.tolist()))
        return _RigView(k)


@functools.lru_cache(maxsize=64)
def _raw_masks(rig: _RigView, pers_h: int, pers_w: int,
               equi_h: int, equi_w: int, antipodal: bool):
    """Correspondence masks after the reference's 'fix missing pixels'
    transpose-add, before blur/normalize (reference utils.py:43-142).

    Returns (pers_masks [m, eh*ew, ph*pw], equi_masks [m, ph*pw, eh*ew]).
    """
    m = rig.fov.shape[0]
    # pers footprint of each ERP pixel: e2p sample grids into the ERP image
    gx_e, gy_e = e2p_grids(rig, (equi_h, equi_w), (pers_h, pers_w))
    pers = _footprint_scatter(gx_e, gy_e, equi_h, equi_w)  # [m, E, P]
    if antipodal:
        # one-hot channels hold deltas at the *antipodal* column
        # (reference utils.py:107-110): index remap along ERP x
        pers = pers.reshape(m, equi_h, equi_w, -1)
        pers = np.roll(pers, -(equi_w // 2), axis=2).reshape(m, equi_h * equi_w, -1)

    # ERP footprint of each pers pixel: p2e sample grids into the pers image
    rig_e = rig.shifted(180.0) if antipodal else rig
    gx_p, gy_p, mask_p = p2e_grids(rig_e, (pers_h, pers_w), (equi_h, equi_w))
    equi = _footprint_scatter(gx_p, gy_p, pers_h, pers_w, valid=mask_p)

    # fix missing pixels: transpose-add + clamp, pers first then equi
    # (reference utils.py:80-87 / 133-140)
    pers = np.clip(pers + np.transpose(equi, (0, 2, 1)), 0.0, 1.0)
    equi = np.clip(equi + np.transpose(pers, (0, 2, 1)), 0.0, 1.0)
    return pers, equi


_G5 = None


def _gauss5():
    global _G5
    if _G5 is None:
        x = np.arange(5, dtype=np.float64) - 2
        k = np.exp(-(x ** 2) / 2.0)
        _G5 = (k / k.sum()).astype(np.float32)
    return _G5


def _blur_maps(x, wrap_w: bool):
    """Separable 5x5 sigma-1 gaussian blur over the last two axes.
    Vertical border replicate; horizontal replicate or circular
    (reference utils.py:23-29: pers replicate, equi circularly padded)."""
    k = _gauss5()
    x = convolve1d(x, k, axis=-2, mode="nearest")
    x = convolve1d(x, k, axis=-1, mode="wrap" if wrap_w else "nearest")
    return x


@functools.lru_cache(maxsize=64)
def _merged_masks_cached(rig: _RigView, pers_h: int, pers_w: int,
                         equi_h: int, equi_w: int, antipodal: bool):
    pers, equi = _raw_masks(rig, pers_h, pers_w, equi_h, equi_w, antipodal)
    m = pers.shape[0]
    # blur over the *target* map of each mask
    pers = _blur_maps(pers.reshape(m, -1, pers_h, pers_w), wrap_w=False)
    equi = _blur_maps(equi.reshape(m, -1, equi_h, equi_w), wrap_w=True)
    # normalize each target map to max 1 (0-max kept), then to [-1, 1]
    pm = pers.max(axis=(-2, -1), keepdims=True)
    pers = pers / np.where(pm == 0, 1.0, pm) * 2.0 - 1.0
    em = equi.max(axis=(-2, -1), keepdims=True)
    equi = equi / np.where(em == 0, 1.0, em) * 2.0 - 1.0
    return (pers.reshape(m, equi_h * equi_w, pers_h * pers_w),
            equi.reshape(m, pers_h * pers_w, equi_h * equi_w))


def merged_masks(cameras, pers_hw, equi_hw, antipodal: bool = False):
    """Blurred, [-1, 1]-normalized attention bias masks
    (reference get_merged_masks, utils.py:12-41, with the variant choice
    lifted out as the `antipodal` argument).

    Returns:
      pers_masks [m, eh*ew, ph*pw] — bias for ERP queries over pers keys
      equi_masks [m, ph*pw, eh*ew] — bias for pers queries over ERP keys
    """
    rig = _RigView(_rig_key(cameras))
    return _merged_masks_cached(rig, int(pers_hw[0]), int(pers_hw[1]),
                                int(equi_hw[0]), int(equi_hw[1]), antipodal)


# ---------------------------------------------------------------------------
# Spherical positional encoding (reference src/modules/transformer.py:170-206)
# ---------------------------------------------------------------------------


def spherical_pe(coords: np.ndarray, n_freqs: int) -> np.ndarray:
    """coords [..., 2] (lon, lat radians) -> [..., 4*n_freqs]:
    [sin(lon*f), sin(lat*f), cos(lon*f), cos(lat*f)]."""
    if n_freqs <= 80:
        base = 2.0
    else:
        base = 5000.0 ** (1.0 / (n_freqs / 2.5))
    freqs = base ** np.linspace(0.0, n_freqs - 1, n_freqs)
    enc = coords[..., :, None].astype(np.float64) * freqs  # [..., 2, N]
    out = np.concatenate([np.sin(enc[..., 0, :]), np.sin(enc[..., 1, :]),
                          np.cos(enc[..., 0, :]), np.cos(enc[..., 1, :])],
                         axis=-1)
    return out.astype(np.float32)


def rig_coords(cameras, pers_hw, equi_hw):
    """Per-pixel (lon, lat) for pers views and the ERP grid
    (reference src/utils/utils.py:145-164 get_coords)."""
    fovs = np.asarray(cameras.fov if hasattr(cameras, "fov") else cameras["FoV"])
    thetas = np.asarray(cameras.theta if hasattr(cameras, "theta") else cameras["theta"])
    phis = np.asarray(cameras.phi if hasattr(cameras, "phi") else cameras["phi"])
    ph, pw = pers_hw
    eh, ew = equi_hw
    lon, lat = np.meshgrid(np.linspace(-np.pi, np.pi, ew),
                           np.linspace(np.pi / 2, -np.pi / 2, eh))
    equi_coords = np.stack([lon, lat], axis=-1)  # [eh, ew, 2]
    pers = []
    for f, t, p in zip(fovs, thetas, phis):
        lo, la = pers_to_equi_coords(f, t, p, ph, pw)
        pers.append(np.stack([lo, la], axis=-1))
    return np.stack(pers), equi_coords  # [m, ph, pw, 2], [eh, ew, 2]


def warp_geometry(cameras, pers_hw, equi_hw, dim: int):
    """Everything WarpAttn needs at one feature resolution, precomputed:

    dict with
      pers_bias / pers_bias_opp: [eh*ew, m*ph*pw] float32
      equi_bias / equi_bias_opp: [m*ph*pw, eh*ew] float32
      pers_pe: [m, ph, pw, dim]; equi_pe: [eh, ew, dim]
    """
    m = len(np.asarray(cameras.fov if hasattr(cameras, "fov")
                       else cameras["FoV"]))
    out = {}
    for tag, anti in (("", False), ("_opp", True)):
        pers_m, equi_m = merged_masks(cameras, pers_hw, equi_hw, anti)
        # queries = ERP pixels, keys = (view, pers pixel)
        out[f"pers_bias{tag}"] = np.ascontiguousarray(
            np.transpose(pers_m, (1, 0, 2)).reshape(pers_m.shape[1], -1))
        # queries = (view, pers pixel), keys = ERP pixels
        out[f"equi_bias{tag}"] = np.ascontiguousarray(
            equi_m.reshape(-1, equi_m.shape[-1]))
    pers_coords, equi_coords = rig_coords(cameras, pers_hw, equi_hw)
    out["pers_pe"] = spherical_pe(pers_coords, dim // 4)
    out["equi_pe"] = spherical_pe(equi_coords, dim // 4)
    return out
