"""The port's threaded host library (imagine360_tpu_torch/native: remap.cc
built at first use) against the JAX package's compiled path
(imagine360_tpu.native: the same source, the same flags) and the port's
numpy versions, on the CPU; and SAM's preprocessing on a device (resize
with F.interpolate, normalise, pad) against the numpy path.

Tolerances: the library equals the JAX package's compiled path bit for bit
(the same code); it agrees with the numpy versions within 1e-5 of the
input's largest magnitude (the C++ forms the four weights first, and g++
may contract to FMA); the device preprocessing equals the numpy one within
1e-5 in float32 and, in uint8 (each rounded half up from float32 work done
in another order), is at most one level off in at most 1e-3 of the
elements.
"""
import os
import stat
import threading
import time

import numpy as np
import pytest
import torch

import imagine360_tpu.native as jnative
from imagine360_tpu.utils import video_io as jvio

from imagine360_tpu_torch import cli as tcli, native
from imagine360_tpu_torch.config import RunConfig as TRunConfig
from imagine360_tpu_torch.models.sam import SAMConfig as TSAMConfig, sam_preprocess, \
    sam_preprocess_tensor
from imagine360_tpu_torch.models.vae import VAEConfig as TVAEConfig
from imagine360_tpu_torch.pipeline import anchor as tanchor, elevation as telev
from imagine360_tpu_torch.pipeline.generate import Imagine360Pipeline as TPipeline
from imagine360_tpu_torch.presets import tiny_dual_config as t_tiny
from imagine360_tpu_torch.utils import video_io as tvio
from imagine360_tpu_torch.utils.observability import StageTimer


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's compiled path. It builds its library with `make` on
    first use and gives up for the process if that fails; processes that
    build at once can see a half-written file, so try again while the
    library is being written."""
    for _ in range(20):
        if jnative.available():
            return jnative
        jnative._tried = False
        time.sleep(0.5)
    pytest.fail("the JAX package's native library did not build")


def _seam_grids(rng, H, W, oh, ow):
    """Sample coordinates that cross the 360-degree seam and the top and
    bottom edges."""
    gx = rng.uniform(-3.5, W + 3.5, (oh, ow)).astype(np.float32)
    gy = rng.uniform(-2.5, H + 1.5, (oh, ow)).astype(np.float32)
    gx[0, :4] = [-1.0, W - 1.0, W - 0.5, float(W)]       # exact seam taps
    return gx, gy


def _image(rng, dtype, shape=(20, 37, 3)):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "clamp"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
def test_remap_equals_jax_compiled_path(jax_native, dtype, wrap):
    rng = np.random.default_rng(1)
    img = _image(rng, dtype)
    gx, gy = _seam_grids(rng, 20, 37, 33, 70)     # 33 rows: the threaded split
    got = native.remap_bilinear(img, gx, gy, wrap_x=wrap)
    want = jax_native.remap_bilinear(img, gx, gy, wrap_x=wrap)
    assert got.dtype == np.float32 and got.shape == (33, 70, 3)
    np.testing.assert_array_equal(got, want)


def test_u8_to_model_range_equals_jax_compiled_path(jax_native):
    u8 = np.random.default_rng(2).integers(0, 256, (3, 17, 29, 3), dtype=np.uint8)
    got = native.u8_to_model_range(u8)
    np.testing.assert_array_equal(got, jax_native.u8_to_model_range(u8))
    np.testing.assert_array_equal(got, native.u8_to_model_range(u8, backend="numpy"))
    with pytest.raises(TypeError, match="uint8"):
        native.u8_to_model_range(u8.astype(np.float32))


def _blob_mask(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    return ((yy - cy) / (0.3 * h)) ** 2 + ((xx - cx) / (0.35 * w)) ** 2 < 1


@pytest.mark.parametrize("seed", range(6))
def test_max_inscribed_rect_equals_jax(jax_native, seed):
    rng = np.random.default_rng(seed)
    mask = _blob_mask(rng, 45, 70) if seed % 2 else rng.random((31, 43)) > 0.25
    got = native.max_inscribed_rect(mask)
    assert got == jax_native.max_inscribed_rect(mask)
    assert got == native.max_inscribed_rect(mask, backend="numpy")
    top, left, w, h = got
    assert w * h > 0 and mask[top:top + h, left:left + w].all()


def test_max_inscribed_rect_empty_and_full(jax_native):
    for mask, want in ((np.zeros((5, 7), bool), (0, 0, 0, 0)),
                       (np.ones((5, 7), bool), (0, 0, 7, 5))):
        assert native.max_inscribed_rect(mask) == want
        assert jax_native.max_inscribed_rect(mask) == want


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "clamp"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
def test_library_agrees_with_numpy_version(dtype, wrap):
    rng = np.random.default_rng(3)
    img = _image(rng, dtype)
    gx, gy = _seam_grids(rng, 20, 37, 24, 50)
    got = native.remap_bilinear(img, gx, gy, wrap_x=wrap)
    want = native.remap_bilinear(img, gx, gy, wrap_x=wrap, backend="numpy")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(img.astype(np.float32)).max()


def test_a_2d_image_stays_on_the_library():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((20, 37)).astype(np.float32)
    gx, gy = _seam_grids(rng, 20, 37, 9, 13)
    native.reset_calls()
    got = native.remap_bilinear(img, gx, gy)
    assert got.shape == (9, 13)
    np.testing.assert_array_equal(got, native.remap_bilinear(img[..., None], gx, gy)[..., 0])
    assert native.calls()["library"]["remap_bilinear"] == 2
    assert native.calls()["numpy"]["remap_bilinear"] == 0


def test_numpy_versions_only_by_name():
    """The pipeline's host stages take the library by default; the numpy
    versions only when named, and then give the same (within rounding)."""
    rng = np.random.default_rng(5)
    frames_u8 = rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)
    pitches = np.array([-10.0, 20.0], np.float32)
    runs = {}
    for backend in native.BACKENDS:
        native.reset_calls()
        timer = StageTimer()
        frames = tvio.to_model_range(frames_u8, backend=backend)
        pano, mask = telev.pers_video_to_pano(frames, pitches, (32, 64), backend=backend,
                                              timer=timer)
        anchor = tanchor.get_anchor_target(pano, pitches, anchor_size=16, backend=backend,
                                           timer=timer)
        other = next(b for b in native.BACKENDS if b != backend)
        assert sum(native.calls()[other].values()) == 0, backend
        assert min(native.calls()[backend].values()) > 0, backend
        assert set(timer.splits) == {"warp grids", "warp remap", "anchor grids", "anchor remap",
                                     "anchor rect", "anchor resize"}
        runs[backend] = (pano, mask, anchor)
    lib, ref = runs["library"], runs["numpy"]
    np.testing.assert_array_equal(lib[1], ref[1])
    assert np.abs(lib[0] - ref[0]).max() <= 1e-5
    for k in ("masks", "relative_position"):
        np.testing.assert_array_equal(lib[2][k], ref[2][k])
    for k in ("anchor", "anchor_pers"):
        assert np.abs(lib[2][k] - ref[2][k]).max() <= 1e-5
    with pytest.raises(ValueError, match="backend"):
        native.remap_bilinear(frames[0], np.zeros((2, 2), np.float32),
                              np.zeros((2, 2), np.float32), backend="cv2")
    # shapes are checked before a pointer reaches the library
    with pytest.raises(ValueError, match="grids"):
        native.remap_bilinear(frames[0], np.zeros((2, 2), np.float32),
                              np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="mask"):
        native.max_inscribed_rect(np.ones((2, 3, 1), bool))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build_library()
    # a compiler that runs and fails: its stderr is in the error
    fake = tmp_path / "failing-cxx"
    fake.write_text("#!/bin/sh\ncase \"$*\" in *--help=target*) echo x86-64; exit 0;; esac\n"
                    "echo 'remap.cc: fatal error: out of luck' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="out of luck"):
        native.remap_bilinear(np.zeros((2, 2, 1), np.float32), np.zeros((1, 1), np.float32),
                              np.zeros((1, 1), np.float32))
    assert not list((tmp_path / "build").glob("*.so"))


def test_concurrent_builds_make_one_library(tmp_path, monkeypatch):
    """Builds racing into an empty directory (as pytest -n workers do; more
    of them than cores) end with one library under the source's hash and no
    partial files."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_library())
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range((os.cpu_count() or 1) + 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(set(paths)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [paths[0].name, "libi360_host.lock"])
    assert paths[0].name.startswith("libi360_host_") and os.path.getsize(paths[0]) > 0


# ---- SAM's preprocessing on a device ------------------------------------------


@pytest.mark.parametrize("hw,out", [((20, 40), (64, 128)), ((33, 21), (24, 15)),
                                    ((256, 256), (1024, 1024))])
def test_sam_preprocess_on_a_device_float32(hw, out):
    rng = np.random.default_rng(6)
    frames = rng.uniform(0, 255, (2, *hw, 3)).astype(np.float32)
    size = max(out) + 3
    want = sam_preprocess(np.stack([tvio.resize_bilinear(f, out) for f in frames]), size)
    got = sam_preprocess_tensor(tvio.resize_bilinear_tensor(torch.from_numpy(frames), out), size)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("hw,out", [((20, 40), (64, 128)), ((256, 256), (1024, 1024)),
                                    ((33, 21), (24, 15))])
def test_sam_resize_on_a_device_uint8(hw, out):
    """At most one level apart everywhere. Where both scales are powers of
    two over the output size (SAM's anchors, 256 -> 1024), at most 1e-3 of
    the elements differ. At other scales F.interpolate forms its source
    coordinates in float32 and resize_bilinear in float64, so values that
    land on a rounding tie (x.5) round either way: there every element that
    differs must lie within 1e-3 of a tie."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = tvio.resize_frames(frames, out)
    got = tvio.resize_bilinear_tensor(torch.from_numpy(frames), out)
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    dyadic = all((o / i) == 2.0 ** round(np.log2(o / i)) for i, o in zip(hw, out))
    if dyadic:
        assert (diff > 0).mean() <= 1e-3
    raw = tvio.resize_bilinear_tensor(torch.from_numpy(frames.astype(np.float32)), out).numpy()
    assert (np.abs(raw - np.floor(raw) - 0.5)[diff > 0] < 1e-3).all()
    # and the preprocessing of the same uint8 frames is the numpy one's
    np.testing.assert_allclose(sam_preprocess_tensor(got, max(out)).numpy(),
                               sam_preprocess(got.numpy(), max(out)), rtol=0, atol=1e-6)


def test_encode_sam_takes_the_device_path():
    """The pipeline's SAM encode equals the numpy path (resize_frames,
    sam_preprocess) through the same encoder, and times its three parts."""
    cfg = TRunConfig(pano_H=128, pano_W=256, dtype="float32")
    dual_cfg = t_tiny(num_views=4)
    modules = tcli.build_modules(
        cfg, dual_cfg, device="cpu", seed=0,
        vae_cfg=TVAEConfig(block_out_channels=(32, 32), layers_per_block=1),
        sam_cfg=TSAMConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                           out_chans=8, window_size=2, global_attn_indexes=(1,),
                           global_q_rows=2))
    pipe = TPipeline(modules, cfg, dual_cfg, device="cpu")
    frames = np.random.default_rng(8).uniform(-1, 1, (3, 20, 40, 3)).astype(np.float32)
    timer = StageTimer()
    with torch.no_grad():
        got = pipe.encode_sam(frames, timer)
        u8 = ((frames + 1) * 127.5).astype(np.uint8)
        x = sam_preprocess(tvio.resize_frames(u8, (32, 64)), 64)
        want = modules.sam(torch.from_numpy(x)).reshape(3, -1, 8)
    assert set(timer.splits) == {"sam resize", "sam preprocess", "sam encoder"}
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_resize_frames_numpy_is_still_the_jax_one():
    """The plain resize stays held to cv2 through the JAX package."""
    pytest.importorskip("cv2")
    f = np.random.default_rng(9).integers(0, 256, (2, 20, 40, 3), dtype=np.uint8)
    diff = np.abs(tvio.resize_frames(f, (64, 128)).astype(np.int16)
                  - jvio.resize_frames(f, (64, 128)).astype(np.int16))
    assert diff.max() <= 1
