"""Time K1 (`tiny_attention`), K2 (`mh_flash_attention`), K3
(`shared_bias_attention`, also with its lse), K5a (`flash_attention_lse`),
K5b (`flash_bwd_dq`), K5c (`flash_bwd_dkv`), K6a (`flash_attention_t`) and K7
(`dense_matmul`) in bf16 at the phase-2 sites of `chip_smoke.py` (K1 and
K2 also at the VAE's head dim of 512, through their wide kernels), on an
NVIDIA GPU, for the checkout this script lies in.

    python scripts/torch_attention_sites.py [--iters N] [--kernels A,B] [--out FILE]

For every such site of `chip_smoke.SITES` (of the wrappers named by
--kernels, all eight by default) it builds the checkout's kernels, makes the
site's seeded random inputs with `chip_smoke.site_call`, and prints one JSON
line: kernel, site, shape, mean ms over N calls after a warm-up (CUDA
events, `chip_smoke.cuda_ms`) and TFLOP/s (4·B·H·Sq·Sk·D operations; K5b
6·, K5c 8·; K7 2·N·K·M). A copy of the script placed in the `scripts/` of
another checkout (say the parent commit, unpacked with `git archive`) times
that checkout's kernels, so two versions are compared on one card in one
call.

Needs nvcc and a card; imports no JAX.
"""
import argparse
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

KERNELS = ("tiny_attention", "mh_flash_attention", "shared_bias_attention",
           "shared_bias_attention_lse", "flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_attention_t", "dense_matmul")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated wrapper names to time")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    kernels.load_library()
    gen = torch.Generator(device=dev).manual_seed(1)
    recs = []
    for name, site, shape in chip_smoke.SITES:
        dense = name == "dense_matmul"      # (N, K, M): no head dim
        if name not in args.kernels.split(","):
            continue
        kern = chip_smoke.site_call(kernels, name, site, shape, gen, dev)[0]
        ms = chip_smoke.cuda_ms(kern, args.iters)
        ops = (2.0 if dense else chip_smoke.OPS_PER_ELEMENT.get(name, 4.0)) * math.prod(shape)
        recs.append(dict(kernel=name, site=site, shape=list(shape), ms=ms,
                         tflops=ops / (ms * 1e-3) / 1e12, card=card))
        print(json.dumps(recs[-1]), flush=True)
        del kern
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
