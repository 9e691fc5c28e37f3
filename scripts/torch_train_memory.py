"""Memory and time of one training step of the PyTorch port's DualUNet at
full width on an NVIDIA GPU, to settle what fits on one card.

    python scripts/torch_train_memory.py [--configs LPB:VIEWS:FRAMES:REMAT,...]
                                         [--profile] [--out DIR]

For every configuration (layers per block 1 = cut depth or 2 = full depth,
views per step, frames, remat 0/1) it builds `full_dual_config` with bf16
modules, seeded random weights and float32 master weights + AdamW moments,
takes one warm and TIMED_STEPS (12) timed `make_train_step` steps (the step
time varies by 0.2-0.6 s between steps of a run, so a comparison of two
trees needs that many, and a change smaller than that spread is read in
the device time of --profile) on a `make_dual_batch` batch at production
shapes, through `chip_smoke.phase_train` (one set-up for both scripts),
and prints the memory allocated after set-up,
`torch.cuda.max_memory_allocated` over the steps, s/step and each timed
step's seconds, the kernel launches per step and the einsum-backward
count. A configuration that runs out of memory is reported and the next
one runs. With --profile the last configuration's step after the timed
ones runs under `torch.profiler`, and the device time of the profiler
ranges (forward, optimizer, einsum backward, the rematerialised units:
forward + recompute) and of the hand-written kernels is printed, each
kernel also by body (`kernel_body_device_ms`: K5b's and K5c's WarpAttn
launches are the `mma_sync` ones on a tree before their biased body, the
`wgmma_bias` ones after).

Widths are never cut. Needs nvcc and a card; imports no JAX.
"""
import argparse
import gc
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

GIB = 2 ** 30
TIMED_STEPS = 12
# i360::remat_unit covers every rematerialised unit twice (forward and
# recompute), so half of it is the recompute
RANGES = ("i360::train_forward", "i360::train_backward", "i360::train_optimizer",
          "i360::einsum_backward", "i360::remat_unit")
KERNEL_NAMES = ("tiny_attention", "mh_flash", "shared_bias", "frame_attention", "flash_lse",
                "flash_bwd_dq", "flash_bwd_dkv")
# the bodies of a kernel by the tail of their names: the CUDA cores, the
# `mma.sync` tile, the `wgmma` body, the biased D = 32 `wgmma` body (K5b's and
# K5c's at the WarpAttn sites)
BODY_TAILS = {"cuda_cores": "_kernel", "mma_sync": "_mma_kernel", "wgmma": "_wgmma_kernel",
              "wgmma_bias": "_bias_wgmma_kernel"}


def profile_summary(avgs):
    """Device ms of the profiler ranges, of each hand-written kernel and of
    everything, and the 25 largest entries, from `key_averages()`."""
    total = lambda e: getattr(e, "device_time_total", 0) / 1e3
    own = lambda e: getattr(e, "self_device_time_total", 0) / 1e3
    return dict(
        range_device_ms={e.key: total(e) for e in avgs if e.key in RANGES},
        # a kernel's CUDA-core (`<name>_kernel`), tensor-core
        # (`<name>_mma_kernel`) and `wgmma` (`<name>_wgmma_kernel`,
        # `<name>_bias_wgmma_kernel`) instantiations together, and by body
        kernel_device_ms={k: sum(own(e) for e in avgs
                                 if any(k + tail in e.key for tail in BODY_TAILS.values())
                                 and e.key not in RANGES) for k in KERNEL_NAMES},
        kernel_body_device_ms={k: {body: sum(own(e) for e in avgs
                                             if k + tail in e.key and e.key not in RANGES)
                                   for body, tail in BODY_TAILS.items()}
                               for k in KERNEL_NAMES},
        all_device_ms=sum(own(e) for e in avgs),
        top_self_device_ms=[(e.key[:80], e.count, own(e))
                            for e in sorted(avgs, key=lambda e: -own(e))[:25]])


def run_config(dev, lpb, views, frames, remat, profile):
    """One configuration through chip_smoke.phase_train (the training phase
    of the smoke run: same model, batch, step and checks), 1 warm +
    TIMED_STEPS timed steps."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = dict(layers_per_block=lpb, views=views, frames=frames, remat=bool(remat))
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        launches, _, stats = chip_smoke.phase_train(
            dev, views=views, frames=frames, steps=TIMED_STEPS, layers_per_block=lpb,
            remat=bool(remat), profiler=prof)
        rec.update(params_B=stats["params"] / 1e9, setup_GiB=stats["setup_bytes"] / GIB,
                   warm_step_s=stats["step_s"][0], step_s=stats["s_per_step"],
                   timed_steps_s=stats["step_s"][1:],
                   peak_GiB=stats["peak_bytes"] / GIB, loss=stats["losses"][-1],
                   grad_norm=stats["grad_norms"][-1],
                   launches={k: n / TIMED_STEPS for k, n in launches.items()},
                   einsum_backward_calls=stats["einsum_backward_calls_per_step"])
        if prof is not None:
            rec.update(profile_summary(prof.key_averages()))
    except torch.cuda.OutOfMemoryError as e:
        rec["out_of_memory"] = str(e).splitlines()[0][:200]
        rec["peak_GiB"] = torch.cuda.max_memory_allocated() / GIB
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="1:20:16:1,2:20:16:1",
                    help="comma list of layers_per_block:views:frames:remat")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    kernels.load_library()
    configs = [tuple(int(x) for x in c.split(":")) for c in args.configs.split(",")]
    recs = []
    for i, c in enumerate(configs):
        rec = run_config(dev, *c, profile=args.profile and i == len(configs) - 1)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
        gc.collect()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "train_memory.json"), "w") as f:
            json.dump({"card": card, "configs": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
