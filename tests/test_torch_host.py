"""Host pipeline and geometry of the PyTorch port against the JAX package:
the bilinear/nearest remaps and the rig warps (<= 1e-5 abs, the 360-degree
wrap seam included), circular padding, the numpy host stages (largest
inscribed rectangle, remap, pitch fits, perspective -> ERP warp, anchors),
the one bilinear resize against cv2.resize, video IO and the run config.

The JAX package's host stages may run its compiled helper library, whose
float32 arithmetic differs in the last bits from numpy's: the port is held
exactly to the JAX package's numpy versions, and to 1e-5 to whatever the
JAX package's public functions ran.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu import config as jconfig
from imagine360_tpu.geometry import CameraRig, pano as jpano, projection as jproj
from imagine360_tpu.pipeline import anchor as janchor, elevation as jelev
from imagine360_tpu.utils import video_io as jvio

from imagine360_tpu_torch import config as tconfig, native as tnative
from imagine360_tpu_torch.geometry import pano as tpano, projection as tproj
from imagine360_tpu_torch.geometry.cameras import CameraRig as TCameraRig
from imagine360_tpu_torch.pipeline import anchor as tanchor, elevation as telev
from imagine360_tpu_torch.utils import observability as tobs, video_io as tvio

from torch_parity import max_abs_err

M = 6


def _rigs(size):
    return CameraRig.icosahedron(image_size=size).take(M), \
        TCameraRig.icosahedron(size).take(M)


# ---- geometry ---------------------------------------------------------------


@pytest.mark.parametrize("border", ["zero", "wrap"])
@pytest.mark.parametrize("fn", ["remap_bilinear", "remap_nearest"])
def test_remap_matches_jax_across_the_seam(fn, border):
    """Sample points run from 3 px left of the image to 3 px right of it and
    above and below it, so both borders and the wrap seam are hit."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    x = rng.uniform(-3, 19, (7, 40)).astype(np.float32)
    y = rng.uniform(-2, 11, (7, 40)).astype(np.float32)
    x[0, :4] = [-0.5, 15.0, 15.5, 16.0]     # on and around the seam column
    want = getattr(jproj, fn)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), border=border)
    got = getattr(tproj, fn)(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y),
                             border=border)
    assert tuple(got.shape) == want.shape == (2, 3, 7, 40)
    assert max_abs_err(got, want) <= 1e-5


@pytest.mark.parametrize("per_view", [False, True], ids=["one_erp", "erp_per_view"])
@pytest.mark.parametrize("mode,border", [("bilinear", "zero"), ("bilinear", "wrap"),
                                         ("nearest", "zero")])
def test_e2p_matches_jax(mode, border, per_view):
    rig, trig = _rigs(16)
    shape = (M, 3, 32, 64) if per_view else (3, 32, 64)
    erp = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jproj.e2p(jnp.asarray(erp), rig, (16, 16), mode=mode, border=border)
    got = tproj.e2p(torch.from_numpy(erp), trig, (16, 16), mode=mode, border=border)
    assert tuple(got.shape) == want.shape == (M, 3, 16, 16)
    assert max_abs_err(got, want) <= 1e-5


@pytest.mark.parametrize("border", ["zero", "wrap"])
def test_p2e_matches_jax(border):
    rig, trig = _rigs(16)
    views = np.random.default_rng(2).standard_normal((M, 3, 16, 16)).astype(np.float32)
    want, wmask = jproj.p2e(jnp.asarray(views), rig, (32, 64), border=border)
    got, gmask = tproj.p2e(torch.from_numpy(views), trig, (32, 64), border=border)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert max_abs_err(got, want) <= 1e-5


def test_mp2e_matches_jax():
    rig, trig = _rigs(16)
    views = np.random.default_rng(3).standard_normal((M, 3, 16, 16)).astype(np.float32)
    want = jproj.mp2e(jnp.asarray(views), rig, (32, 64))
    got = tproj.mp2e(torch.from_numpy(views), trig, (32, 64))
    assert tuple(got.shape) == want.shape == (3, 32, 64)
    assert max_abs_err(got, want) <= 1e-5


@pytest.mark.parametrize("padding", [0, 1, 4])
def test_pad_pano_matches_jax(padding):
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 12)).astype(np.float32)
    got = tpano.pad_pano(torch.from_numpy(x), padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpano.pad_pano(jnp.asarray(x),
                                                                         padding)))
    np.testing.assert_array_equal(tpano.unpad_pano(got, padding).numpy(), x)


# ---- numpy host stages --------------------------------------------------------


def _blob_mask(rng, h, w):
    """A mask like a view's footprint on the ERP grid: a filled ellipse with
    a ragged edge, sometimes cut by the image border."""
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
    ry, rx = rng.uniform(0.15, 0.5) * h, rng.uniform(0.15, 0.5) * w
    m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    return m & (rng.random((h, w)) > 0.02)


@pytest.mark.parametrize("seed", range(6))
def test_max_inscribed_rect_equals_jax_python_version(seed):
    rng = np.random.default_rng(seed)
    mask = _blob_mask(rng, 40, 64) if seed % 2 else rng.random((24, 31)) > 0.3
    want = janchor._max_inscribed_rect_py(mask)
    assert tnative.max_inscribed_rect(mask) == tuple(int(v) for v in want)
    top, left, w, h = want
    assert mask[top:top + h, left:left + w].all()


def test_max_inscribed_rect_empty_and_full():
    assert tnative.max_inscribed_rect(np.zeros((5, 7), bool)) == (0, 0, 0, 0)
    assert tnative.max_inscribed_rect(np.ones((5, 7), bool)) == (0, 0, 7, 5)


@pytest.mark.parametrize("wrap", [True, False])
def test_native_remap_equals_jax_numpy_version(wrap):
    """The port's numpy version (its plain one) against the JAX package's;
    the library route is held in tests/test_torch_host_native.py."""
    rng = np.random.default_rng(5)
    img = rng.standard_normal((9, 16, 3)).astype(np.float32)
    gx = rng.uniform(-3, 19, (7, 11)).astype(np.float32)
    gy = rng.uniform(-2, 11, (7, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        tnative.remap_bilinear(img, gx, gy, wrap_x=wrap, backend="numpy"),
        janchor._remap_np(img, gx, gy, wrap=wrap))
    # a single-channel image keeps its rank
    assert tnative.remap_bilinear(img[..., 0], gx, gy, wrap_x=wrap,
                                  backend="numpy").shape == (7, 11)


def test_u8_to_model_range_equals_jax():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    np.testing.assert_array_equal(tvio.to_model_range(u8), jvio.to_model_range(u8))
    x = tvio.to_model_range(u8)
    np.testing.assert_array_equal(tvio.from_model_range(x), jvio.from_model_range(x))


def test_pitch_fits_equal_jax():
    rng = np.random.default_rng(6)
    raw = rng.uniform(-30, 30, 12)
    w = (rng.random(12) > 0.3) * rng.random(12)
    np.testing.assert_array_equal(telev.linear_fit_pitch(raw), jelev.linear_fit_pitch(raw))
    np.testing.assert_array_equal(telev.weighted_linear_fit_pitch(raw, w),
                                  jelev.weighted_linear_fit_pitch(raw, w))
    for scale in (1.0, 0.1):       # scattered evidence, then consistent evidence
        np.testing.assert_array_equal(telev.robust_fit_pitch(raw * scale, w),
                                      jelev.robust_fit_pitch(raw * scale, w))
    frames = np.zeros((12, 8, 8, 3), np.uint8)
    for mode, rp in (("none", raw), ("linear_fit", raw), ("linear_fit", None)):
        np.testing.assert_array_equal(telev.PitchEstimator(mode)(frames, rp),
                                      jelev.PitchEstimator(mode)(frames, rp))
    est = lambda f: 3.0
    np.testing.assert_array_equal(telev.PitchEstimator("geocalib", est)(frames),
                                  jelev.PitchEstimator("geocalib", est)(frames))


def test_horizon_estimator_equals_jax():
    """Runs where cv2 is installed; without it the port raises ImportError
    and names the modes that need none."""
    pytest.importorskip("cv2")
    frame = np.zeros((64, 64, 3), np.uint8)
    frame[40:] = 255
    assert telev.estimate_pitch_horizon(frame) == jelev.estimate_pitch_horizon(frame)


@pytest.fixture(scope="module")
def warped():
    rng = np.random.default_rng(7)
    frames = rng.uniform(-1, 1, (3, 24, 24, 3)).astype(np.float32)
    pitches = np.array([-20.0, 0.0, 35.0], np.float32)
    return frames, pitches, jelev.pers_video_to_pano(frames, pitches, (32, 64))


def test_pers_video_to_pano_matches_jax(warped):
    frames, pitches, (wpano, wmask) = warped
    pano, mask = telev.pers_video_to_pano(frames, pitches, (32, 64))
    np.testing.assert_array_equal(mask, wmask)
    assert pano.dtype == np.float32 and max_abs_err(pano, wpano) <= 1e-5
    # and the port's numpy version exactly the JAX package's numpy path
    pano_np, _ = telev.pers_video_to_pano(frames, pitches, (32, 64), backend="numpy")
    gx, gy, cover = jproj.equi_pix_to_pers_grid(24, 24, 90.0, 0.0, 35.0, 32, 64)
    want = (janchor._remap_np(frames[2], gx, gy) * cover[..., None]).astype(np.float32)
    np.testing.assert_array_equal(pano_np[2], want)


def test_get_anchor_target_matches_jax(warped):
    _, pitches, (wpano, _) = warped
    want = janchor.get_anchor_target(wpano, pitches, anchor_size=16)
    got = tanchor.get_anchor_target(wpano, pitches, anchor_size=16)
    assert set(got) == set(want)
    for k in ("masks", "relative_position", "pitch"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("anchor", "anchor_pers"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert max_abs_err(got[k], want[k]) <= 1e-5, k


# ---- the one resize -------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [((37, 53, 3), (256, 256)), ((128, 128, 3), (96, 200)),
                                       ((300, 200, 3), (64, 64)), ((20, 30), (11, 17))])
def test_resize_bilinear_against_cv2(shape, out):
    """float32: within 1e-6 of cv2.resize(INTER_LINEAR) (measured 2.4e-7).
    uint8: at most one level away; cv2 rounds fixed-point weights."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(8)
    f = rng.uniform(-1, 1, shape).astype(np.float32)
    want = cv2.resize(f, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
    got = tvio.resize_bilinear(f, out)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    want = cv2.resize(u8, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
    got = tvio.resize_bilinear(u8, out)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_resize_frames_matches_jax():
    pytest.importorskip("cv2")
    f = np.random.default_rng(9).uniform(0, 1, (3, 20, 30, 3)).astype(np.float32)
    assert np.abs(tvio.resize_frames(f, (32, 48)) - jvio.resize_frames(f, (32, 48))).max() \
        <= 1e-6


# ---- video IO, config, observability ----------------------------------------------


def test_read_video_npy_subsamples_like_jax(tmp_path):
    clip = np.random.default_rng(10).integers(0, 256, (10, 8, 8, 4)).astype(np.uint8)
    path = str(tmp_path / "clip.npy")
    np.save(path, clip)
    for n in (None, 4, 10, 13):
        np.testing.assert_array_equal(tvio.read_video(path, n), jvio.read_video(path, n))
    assert tvio.read_video(path, 4).shape == (4, 8, 8, 3)


def test_save_video_npy_round_trip(tmp_path):
    frames = np.random.default_rng(11).random((3, 8, 8, 3)).astype(np.float32)
    out = tvio.save_video(frames, str(tmp_path / "sub" / "clip.npy"))
    assert out.endswith("clip.npy")
    np.testing.assert_array_equal(np.load(out), (frames * 255).astype(np.uint8))


def test_save_video_without_a_writer_falls_to_npy(tmp_path, monkeypatch):
    """No imageio, no cv2 (as on a machine with numpy, scipy and torch
    alone): the frames land in <name>.npy and the path says so."""
    monkeypatch.setattr(tvio, "_save_video_imageio", lambda *a: False)
    monkeypatch.setattr(tvio, "_save_video_cv2", lambda *a: False)
    frames = np.random.default_rng(12).integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    out = tvio.save_video(frames, str(tmp_path / "clip_output.mp4"))
    assert out == str(tmp_path / "clip_output.npy")
    np.testing.assert_array_equal(np.load(out), frames)


def test_run_config_matches_jax(tmp_path):
    raw = {"pano_H": 64, "pano_W": 128, "num_inference_steps": 2, "angle_adapt": "none",
           "unet_additional_kwargs": {"ignored": 1},
           "noise_scheduler_kwargs": {"beta_start": 0.001, "unknown": 3}}
    want, got = jconfig.RunConfig.from_dict(raw), tconfig.RunConfig.from_dict(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tconfig.RunConfig()) == dataclasses.asdict(jconfig.RunConfig())
    pytest.importorskip("yaml")
    path = str(tmp_path / "run.yaml")
    got.to_yaml(path)
    assert dataclasses.asdict(jconfig.RunConfig.from_yaml(path)) == dataclasses.asdict(want)
    assert dataclasses.asdict(tconfig.RunConfig.from_yaml(path)) == dataclasses.asdict(want)


def test_stage_timer_and_memory_stats():
    timer = tobs.StageTimer(device="cpu")
    with timer("a"):
        pass
    with timer("a"):
        pass
    with pytest.raises(RuntimeError):
        with timer("b"):
            raise RuntimeError("stage failed")
    report = timer.report()
    assert set(report) == {"a", "b"} and report["a"] >= 0.0
    assert tobs.device_memory_stats() == {} or all(
        "peak_bytes_in_use" in v for v in tobs.device_memory_stats().values())
    assert tobs.get_logger("x") is tobs.get_logger("x")
