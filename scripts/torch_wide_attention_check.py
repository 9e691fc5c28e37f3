"""Short check of the wide (head dim 161..512) variants of kernels K1 and K2
of the PyTorch port on an NVIDIA GPU: build the library, print what ptxas
says of the wide kernels (registers, spills), then at the VAE's three
attention sites compare each kernel with its plain version (bf16 on every
batch row, f32 on 4) and time kernel, plain version and
F.scaled_dot_product_attention with CUDA events.

    python scripts/torch_wide_attention_check.py

Needs nvcc and a card; imports no JAX. chip_smoke.py phase 2 measures the
same sites among all others; this is the quick first run after a change to
csrc/attn_wide.cuh (float32) or csrc/attn_mma_wide.cuh (bfloat16).
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from imagine360_tpu_torch.ops import kernels  # noqa: E402

SITES = [("tiny_attention", (80, 1024, 1024, 1, 512)),
         ("mh_flash_attention", (16, 8192, 8192, 1, 512)),
         ("mh_flash_attention", (4, 8704, 8704, 1, 512))]


def cuda_ms(fn, n=3):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    lib = kernels.build_library()
    kernels.load_library()
    print(f"build {time.time() - t0:.1f} s on {torch.cuda.get_device_name(0)}", flush=True)
    lines = lib.with_suffix(".ptxas.txt").read_text().splitlines()
    for i, line in enumerate(lines):
        if "wide" in line and "Compiling" in line:
            print("\n".join(lines[i:i + 4]))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (B, Sq, Sk, H, D) in SITES:
        for dtype, rows in ((torch.bfloat16, B), (torch.float32, 4)):
            q, k, v = (torch.randn(rows, S, H * D, generator=gen, device=dev).to(dtype)
                       for S in (Sq, Sk, Sk))
            fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
            kw = dict(scale=D ** -0.5, heads=H)
            got, want = fn(q, k, v, **kw), plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            bhsd = [t.view(rows, -1, H, D).transpose(1, 2) for t in (q, k, v)]
            print(f"{name} {(rows, Sq, Sk, H, D)} {dtype}: max abs err {err:.3e} "
                  f"(max |plain| {want.float().abs().max().item():.3e}), "
                  f"kernel {cuda_ms(lambda: fn(q, k, v, **kw)):.3f} ms, "
                  f"plain {cuda_ms(lambda: plain(q, k, v, **kw)):.3f} ms, "
                  f"sdpa {cuda_ms(lambda: sdpa(*bhsd)):.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
