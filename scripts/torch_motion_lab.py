"""The motion-attention lab of the PyTorch port: the variants of the
frame-axis attention kernel (L1 striped_v2, L2 fused, L3 diag) against K4,
checked and timed at the motion sites.

    python scripts/torch_motion_lab.py [--device cuda|cpu] [--site NAME,...]
                                       [--dtype bfloat16|float32] [--iters N]
                                       [--out DIR]

For every site it prints one line per variant that fits: its largest
absolute difference from K4's plain version and from the K4 kernel, its
time (mean of --iters calls, CUDA events) and K4's in the same run. Sites:
`lab` is the perspective stage-0 motion site (40, 16, 1024, 320), 8 heads;
`motion_pers_s0`..`motion_pers_s3` and `motion_pano_s0`..`motion_pano_s3`
are every motion stage of both branches of full_dual_config, the sites of
chip_smoke.py's phase 8; `tiny` is a CPU-sized site. The default is `lab`.
A variant beyond chip_smoke.py's limits (bf16: min(2e-2, 2**-5 x
max|plain|), the exp_bf16 variant 5e-2; float32: 1e-4) makes the script
exit 1.

Runs on the card (needs nvcc; imports no JAX); without one it exits 1
unless --device cpu, where the wrappers run their plain versions and no
time is measured.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels, motion_lab  # noqa: E402

SITES = {"lab": chip_smoke.LAB_SITES[0][1], "tiny": (2, 4, 16, 32, 4),
         **dict(chip_smoke.LAB_SITES)}


def tolerance(row, dtype) -> float:
    """The limit of a row's difference from K4's plain version, as phases 2
    and 8 of chip_smoke.py set it."""
    if row["params"].get("exp_bf16"):
        return chip_smoke.EXP_BF16_TOL
    if dtype == torch.float32:
        return chip_smoke.F32_TOL
    return chip_smoke.bf16_tol(row["kernel"], row["peak"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--site", default="lab", help=f"comma list of {', '.join(SITES)}")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="directory for motion_lab.json")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu for the plain versions)", file=sys.stderr)
        return 1
    dtype = getattr(torch, args.dtype)
    card = "cpu"
    if args.device == "cuda":
        card = chip_smoke.smi_line()
        kernels.load_library()
    print(f"card: {card}", flush=True)
    sites = [(name, SITES[name]) for name in args.site.split(",")]
    kernels.reset_counts()
    rows = motion_lab.run_lab(args.device, sites, iters=args.iters, dtype=dtype)
    bad = 0
    for row in rows:
        row["tol"] = tolerance(row, dtype)
        row["ok"] = row["max_abs_err"] <= row["tol"]
        bad += not row["ok"]
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "motion_lab.json"), "w") as f:
            json.dump({"card": card, "dtype": args.dtype, "rows": rows,
                       "counts": kernels.counts()}, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
