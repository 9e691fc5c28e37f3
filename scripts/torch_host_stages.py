"""Time the pipeline's host stages and SAM's preprocessing, numpy path
against the port's (the threaded host library for the remaps, the uint8
conversion and the largest rectangles; F.interpolate and the normalise-pad
on the device for SAM), on the 16 frames of examples/synthetic.npy warped
to a 512 x 1024 panorama, as `chip_smoke.py` phase 5 runs them.

    python scripts/torch_host_stages.py [--device cuda|cpu] [--repeats 2]
        [--out DIR] [--no-encoder]

Each repeat runs the numpy path, then the library path, then the library
path, then the numpy path (the grid caches cleared before each), and prints
per path the seconds of: the uint8 -> [-1, 1] conversion, the pitch fit,
the warp's grids and remaps, the anchors' grids, remaps, rectangles and
crop resizes, and, for both anchor sets, SAM's resize, preprocessing and
(unless --no-encoder) encoder (SAMConfig(), bf16 on the card, seeded
random weights). The two paths' outputs are compared. --out keeps the
numbers as host_stages.json.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from imagine360_tpu_torch import cli, native  # noqa: E402
from imagine360_tpu_torch.geometry import projection  # noqa: E402
from imagine360_tpu_torch.models.sam import (SAMConfig, SAMImageEncoder, sam_preprocess,  # noqa: E402
                                             sam_preprocess_tensor)
from imagine360_tpu_torch.pipeline.anchor import get_anchor_target  # noqa: E402
from imagine360_tpu_torch.pipeline.elevation import PitchEstimator, pers_video_to_pano  # noqa: E402
from imagine360_tpu_torch.utils.observability import StageTimer  # noqa: E402
from imagine360_tpu_torch.utils.video_io import (read_video, resize_bilinear_tensor,  # noqa: E402
                                                 resize_frames, to_model_range)

FRAMES, PANO_HW, SAM_SIZE = 16, (512, 1024), 1024


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_stages(frames_u8, raw_pitches, backend):
    """The host part of Imagine360Pipeline.__call__ on one backend ->
    (splits in seconds, anchor dict, pano frames)."""
    projection._equi_pix_to_pers_grid_cached.cache_clear()
    projection._pers_to_equi_coords_cached.cache_clear()
    timer = StageTimer()
    with timer.split("to model range"):
        frames = to_model_range(frames_u8, backend=backend)
    with timer.split("pitch fit"):
        pitches = PitchEstimator(mode="linear_fit")(frames_u8, raw_pitches)
    pano, _ = pers_video_to_pano(frames, pitches, PANO_HW, backend=backend, timer=timer)
    anchor = get_anchor_target(pano, pitches, backend=backend, timer=timer)
    return dict(timer.splits), anchor, pano


def sam_inputs(anchor_frames, dev, backend):
    """SAM's resize and preprocessing of one anchor set on a path -> (input
    tensor on dev, {"sam resize": s, "sam preprocess": s})."""
    t = {}
    t0 = time.perf_counter()
    u8 = ((anchor_frames + 1) * 127.5).astype(np.uint8)
    h, w = u8.shape[1:3]
    scale = float(SAM_SIZE) / max(h, w)
    hw = (int(h * scale + 0.5), int(w * scale + 0.5))
    if backend == "numpy":
        resized = resize_frames(u8, hw)
        t["sam resize"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = torch.from_numpy(sam_preprocess(resized, SAM_SIZE)).to(dev)
        sync(dev)
    else:
        resized = resize_bilinear_tensor(torch.from_numpy(u8).to(dev), hw)
        sync(dev)
        t["sam resize"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = sam_preprocess_tensor(resized, SAM_SIZE)
        sync(dev)
    t["sam preprocess"] = time.perf_counter() - t0
    return x, t


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-encoder", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    t0 = time.time()
    lib = native.build_library()
    native.load_library()
    print(f"host library {lib.name}: {time.time() - t0:.1f} s, {native.NUM_THREADS} threads, "
          f"{os.cpu_count()} CPUs")
    clip = os.path.join(REPO, "examples", "synthetic.npy")
    frames_u8 = read_video(clip, num_frames=FRAMES)
    raw = np.linspace(-8.0, 12.0, FRAMES) + np.random.default_rng(0).normal(0, 1.5, FRAMES)
    sam = None
    if not args.no_encoder:
        sam = cli.make_module(SAMImageEncoder, SAMConfig(dtype="bfloat16"), device=dev,
                              dtype=torch.bfloat16,
                              gen=torch.Generator(device=dev).manual_seed(0))

    runs, outputs = [], {}
    for _ in range(args.repeats):
        for backend in ("numpy", "library", "library", "numpy"):
            native.reset_calls()
            t0 = time.perf_counter()
            splits, anchor, pano = host_stages(frames_u8, raw, backend)
            host_s = time.perf_counter() - t0
            for key in ("anchor", "anchor_pers"):
                x, t = sam_inputs(anchor[key], dev, backend)
                for k, v in t.items():
                    splits[k] = splits.get(k, 0.0) + v
                if sam is not None:
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        sam(x)
                    sync(dev)
                    splits["sam encoder"] = splits.get("sam encoder", 0.0) + \
                        time.perf_counter() - t0
                outputs.setdefault(backend, {})[key] = x.float().cpu().numpy()
            outputs[backend]["pano"] = pano
            runs.append(dict(backend=backend, host_s=host_s, splits=splits,
                             calls=native.calls()))
            print(f"{backend:8s} host {host_s:.3f} s; " + ", ".join(
                f"{k} {v:.3f}" for k, v in splits.items()))
    diffs = {k: float(np.abs(outputs["library"][k] - outputs["numpy"][k]).max())
             for k in outputs["numpy"]}
    print(f"library against numpy, max abs difference: {json.dumps(diffs)}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "host_stages.json"), "w") as f:
            json.dump(dict(device=str(dev), card=torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else None, threads=native.NUM_THREADS,
                           cpus=os.cpu_count(), runs=runs, max_abs_diff=diffs), f, indent=1)


if __name__ == "__main__":
    main()
