"""The PyTorch port's command line against the JAX package's, on the CPU:
`python -m imagine360_tpu_torch.cli --config <yaml> --tiny --device cpu` on
examples/synthetic.npy writes the files that `python -m imagine360_tpu.cli
--tiny --platform cpu` writes, with the same pictures in them.

Both run tiny_dual_config and the full-width VAE with zero weights (dev
mode), 2 frames, 1 step, pano 128 x 256. The input and mask videos come
from the host stages and agree to the video codec's rounding; the output is
the constant image a zero-weight VAE decodes to. Tolerance: mean abs
difference of the decoded uint8 frames below 1 level, max at most 8 (both
sides feed the same lossy encoder frames that differ by at most 1 level).

Also the guards: prompts without a tokenizer are refused up front, and an
empty video directory is an error; a clip whose generation fails is logged
and skipped, and the clips after it are still written.
"""
import logging
import os

import numpy as np
import pytest

from imagine360_tpu import cli as jcli

from imagine360_tpu_torch import cli as tcli
from imagine360_tpu_torch.utils.video_io import read_video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_cfg(tmp_path, name, **kw):
    yaml = pytest.importorskip("yaml")
    cfg = dict(output_dir=str(tmp_path / name), pano_H=128, pano_W=256,
               num_inference_steps=1, video_sample_length=2, dtype="float32", **kw)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_tiny_cli_writes_the_same_files_as_the_jax_cli(tmp_path):
    vids = os.path.join(REPO, "examples")
    assert tcli.main(["--config", _write_cfg(tmp_path, "torch_out", video_path=vids),
                      "--tiny", "--device", "cpu"]) == 0
    jcli.main(["--config", _write_cfg(tmp_path, "jax_out", video_path=vids),
               "--tiny", "--platform", "cpu"])
    got, want = (sorted(os.listdir(tmp_path / d)) for d in ("torch_out", "jax_out"))
    assert got == want
    assert {os.path.splitext(f)[0] for f in got} == {
        "config", "synthetic_input", "synthetic_mask", "synthetic_output"}
    for f in got:
        if f.startswith("synthetic_"):
            a = read_video(str(tmp_path / "torch_out" / f)).astype(np.float32)
            b = read_video(str(tmp_path / "jax_out" / f)).astype(np.float32)
            assert a.shape == b.shape == (2, 128, 256, 3), f
            assert np.abs(a - b).mean() < 1.0 and np.abs(a - b).max() <= 8, f
    # the mask video is black where the input clip lands and white elsewhere
    mask = read_video(str(tmp_path / "torch_out" / [f for f in got if "mask" in f][0]))
    assert mask.min() < 16 and mask.max() > 240


def _write_clip(tmp_path, sidecar=None):
    d = tmp_path / "vids"
    d.mkdir(exist_ok=True)
    np.save(d / "clip.npy",
            np.random.default_rng(0).integers(0, 255, (4, 32, 32, 3)).astype(np.uint8))
    if sidecar is not None:
        (d / "clip.txt").write_text(sidecar)
    return str(d)


@pytest.mark.parametrize("how", ["sidecar", "config_prompt"])
def test_cli_refuses_prompt_without_tokenizer(tmp_path, how):
    """Refused before any model is built or any output written."""
    vids = _write_clip(tmp_path, sidecar="a red ball" if how == "sidecar" else None)
    kw = {} if how == "sidecar" else {"prompt": "a red ball"}
    rc = tcli.main(["--config", _write_cfg(tmp_path, "out", video_path=vids, **kw),
                    "--device", "cpu"])
    assert rc == 1
    assert not (tmp_path / "out").exists()


def test_cli_no_videos_is_an_error(tmp_path):
    (tmp_path / "empty").mkdir()
    rc = tcli.main(["--config", _write_cfg(tmp_path, "out", video_path=str(tmp_path / "empty")),
                    "--device", "cpu"])
    assert rc == 1 and not (tmp_path / "out").exists()


def test_cli_logs_and_skips_a_failing_clip(tmp_path, monkeypatch):
    """As imagine360_tpu/cli.py does: the clip whose generation raises (it
    sorts first) is logged with its traceback, the next one's three outputs
    are written, and main returns 0."""
    d = tmp_path / "vids"
    d.mkdir()
    frames = np.random.default_rng(1).integers(0, 255, (4, 32, 32, 3)).astype(np.uint8)
    for name in ("a_bad", "b_good"):
        np.save(d / f"{name}.npy", frames)
    real, calls = tcli.Imagine360Pipeline.__call__, []

    def call(self, *args, **kwargs):
        calls.append(len(calls))
        if len(calls) == 1:
            raise RuntimeError("decoder exploded")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(tcli.Imagine360Pipeline, "__call__", call)
    records = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = records.append
    tcli.log.addHandler(handler)
    try:
        rc = tcli.main(["--config", _write_cfg(tmp_path, "out", video_path=str(d)), "--tiny",
                        "--device", "cpu"])
    finally:
        tcli.log.removeHandler(handler)
    assert rc == 0 and len(calls) == 2
    written = {os.path.splitext(f)[0] for f in os.listdir(tmp_path / "out")}
    assert written == {"config", "b_good_input", "b_good_mask", "b_good_output"}
    assert [r.getMessage() for r in records] == ["generation failed for a_bad"]
    assert records[0].exc_info and "decoder exploded" in str(records[0].exc_info[1])
