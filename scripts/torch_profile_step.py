"""Where the device time of one denoise step of the PyTorch port goes, on an
NVIDIA GPU, or of one SR call.

    python scripts/torch_profile_step.py [--opt-in | --sr pano|v2v] [--out DIR]

Builds `full_dual_config` in bf16 with seeded random weights and runs
compute_ip and one CFG DDIM step through `chip_smoke.phase_slice` (phase 4
of the smoke run: same model, geometry, conditioning and checks; with
--opt-in phase 7's `dpmpp_2m` step under `configure(attn_v2=True,
pallas_dense=True)`), then one more warm step under `torch.profiler`. Prints
the step's device kernel time split into the hand-written kernels (K1-K4,
and K6a and K7 behind the switches, each with its launches), cuBLAS,
cuDNN, copies, norms and the remaining elementwise
kernels, the profiled window's wall time and the device's idle share in it,
and the 25 kernels with the most device time. With --out the same goes to
DIR/step_profile.json. With --sr the window is one whole SR call instead
(`chip_smoke.phase_sr_engine`, phase 10 or 11 of the smoke run, on a seeded
16-frame 512 x 1024 clip): the enhancer with that engine at full width,
run once counted and once under the profiler.

Needs nvcc and a card; imports no JAX.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

# (category, substrings of a CUDA kernel's name), first match wins; what
# matches none is elementwise. cuDNN before cuBLAS: its convolution kernels
# are implicit GEMMs (sm90_xmma_fprop_implicit_gemm_*)
CATEGORIES = (
    ("K2 wide (D > 160)", ("mh_flash_wide",)),
    ("K1 tiny_attention", ("tiny_attention",)),
    ("K2 mh_flash", ("mh_flash",)),
    ("K3 shared_bias", ("shared_bias",)),
    ("K4 frame_attention", ("frame_attention",)),
    ("K6a flash_t", ("flash_t_",)),
    ("K7 dense_matmul", ("dense_matmul",)),
    ("cuDNN", ("cudnn", "conv", "fprop", "dgrad", "wgrad")),
    ("cuBLAS", ("gemm", "nvjet", "cublas", "cutlass")),
    ("copies", ("copy", "memcpy", "memset", "catarray")),
    ("norms", ("norm", "rowwisemoments", "computefusedparams", "welford")),
)


def category(kernel_name: str) -> str:
    low = kernel_name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise and other"


def summarize(prof, window_s):
    """Device ms and launches by category from the kernels (device events)
    of the profiled window, and the top 25 kernels."""
    from torch.autograd import DeviceType

    avgs = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    own = lambda e: getattr(e, "self_device_time_total", 0) / 1e3
    by_cat = {}
    for e in avgs:
        ms, n = by_cat.get(category(e.key), (0.0, 0))
        by_cat[category(e.key)] = (ms + own(e), n + e.count)
    device_ms = sum(own(e) for e in avgs)
    if device_ms == 0:
        raise SystemExit("the profiler recorded no device kernels")
    return dict(
        window_s=window_s, device_ms=device_ms,
        idle_share=max(0.0, 1.0 - device_ms / (window_s * 1e3)),
        by_category={c: dict(ms=ms, launches=n, share=ms / device_ms)
                     for c, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0])},
        top=[(e.key[:100], e.count, own(e)) for e in sorted(avgs, key=lambda e: -own(e))[:25]])


class TimedProfile:
    """torch.profiler over a block, and the block's wall time."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.window_s = None

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.time() - self.t0
        return self.prof.__exit__(*exc)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--opt-in", action="store_true",
                    help="profile a step of phase 7 (the opt-in kernels) instead of phase 4")
    ap.add_argument("--sr", choices=("pano", "v2v"), default=None,
                    help="profile one SR call with this engine instead")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    kernels.load_library()
    timed = TimedProfile()
    opt_in = dict(solver=chip_smoke.OPT_IN_SOLVER,
                  switches=chip_smoke.OPT_IN_SWITCHES) if args.opt_in else {}
    if args.sr:
        import tempfile

        import numpy as np

        clip = np.random.default_rng(5).uniform(0, 1, (16, 512, 1024, 3)).astype(np.float32)
        with tempfile.TemporaryDirectory(prefix="i360_sr_") as tmp:
            _, _, stats = chip_smoke.phase_sr_engine(
                dev, args.sr, clip, os.path.join(args.out or tmp, "sr"), profiler=timed)
        unprofiled = dict(s_per_sr_clip_unprofiled=stats["total_s"], sr_engine=args.sr)
    else:
        _, _, stats = chip_smoke.phase_slice(dev, steps=1, profiler=timed, **opt_in)
        unprofiled = dict(s_per_step_unprofiled=stats["s_per_step"])
    rec = dict(card=card, opt_in=args.opt_in, **unprofiled,
               **summarize(timed.prof, timed.window_s))
    print(f"profiled {'SR call' if args.sr else 'step'}: window {rec['window_s']:.3f} s, device kernels "
          f"{rec['device_ms']:.1f} ms, idle share {rec['idle_share']:.4f}")
    for cat, v in rec["by_category"].items():
        print(f"  {cat:24s} {v['ms']:10.1f} ms {v['launches']:6d} launches {v['share']:.3f}")
    for key, n, ms in rec["top"]:
        print(f"  {ms:10.1f} ms {n:6d}  {key}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "step_profile.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
