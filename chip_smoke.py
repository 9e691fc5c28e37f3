"""Drive the PyTorch/H100 port (imagine360_tpu_torch) once on one card.

    python3 chip_smoke.py [--out DIR]

Phases, each fatal on failure:
  0. card, power limit and versions;
  1. build the four attention kernels from imagine360_tpu_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch version at the denoise loop's
     production shapes: in bf16 on every batch row, max abs error <=
     min(2e-2, 2**-5 * max|plain|), with both times; and in f32 (TF32 off)
     on the first F32_ROWS batch rows, max abs error <= 1e-4;
  3. tiny DualUNet forward, f32, TF32 off: CUDA through the kernels against
     the same weights on the CPU through the plain versions;
  4. the slice: full_dual_config in bf16 with seeded random weights,
     compute_ip and 2 CFG DDIM steps at bench shapes (16 frames, 20 views,
     latents 32x32 / 64x128); finite latents, every kernel launched, no
     attention call on a plain path.

The last three lines are the JSON kernel list, the card's name and power
limit, and the contract line {"ok": true, "device": {...}}; none of them
is printed unless every phase passed. Without CUDA the script exits 1 at
once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# one card: the run uses cuda:0 only, and the contract line's count says so
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import torch  # noqa: E402

SCRIPT_DIR = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 2e-2          # abs, bf16 inputs of unit scale ...
BF16_REL = 2 ** -5       # ... and at most 8 bf16 ulps of the site's largest output
F32_TOL = 1e-4           # abs, f32: same arithmetic, another summation order
F32_ROWS = 4             # batch rows of the f32 check at each production shape
TINY_REL_TOL = 1e-3      # f32 CUDA vs CPU, relative to the output's max abs
# tiny latents: the pano's 32x64 = 2048 stage-0 tokens exceed K1's 1024-key
# limit, so the tiny forward reaches all four kernels, K2 included
TINY_PERS_HW, TINY_PANO_HW = (16, 16), (32, 64)
SLICE_STEPS = 2          # of the 50-step schedule, in phase 4

# (kernel, site, shape): the denoise loop's production shapes
# (B, Sq, Sk, H, D) for K1-K3, (B, F, HW, C, heads) for K4
SITES = [
    ("tiny_attention", "pers_spatial_s0", (640, 1024, 1024, 5, 64)),
    ("tiny_attention", "pers_text_cross_s0", (640, 1024, 77, 5, 64)),
    ("tiny_attention", "pano_spatial_s2", (32, 512, 512, 20, 64)),
    ("tiny_attention", "pano_text_cross_s0", (32, 8192, 77, 5, 64)),
    ("tiny_attention", "temporal_proj_frames", (10240, 16, 16, 8, 64)),
    ("mh_flash_attention", "pano_spatial_s0", (32, 8192, 8192, 5, 64)),
    ("mh_flash_attention", "pano_spatial_s1", (32, 2048, 2048, 10, 64)),
    ("shared_bias_attention", "warp_r2_pano_q", (32, 2048, 5120, 10, 32)),
    ("shared_bias_attention", "warp_r2_pers_q", (32, 5120, 2048, 10, 32)),
    ("shared_bias_attention", "warp_r8_pano_q", (32, 128, 320, 40, 32)),
    ("frame_attention", "motion_pers_s0", (40, 16, 1024, 320, 8)),
    ("frame_attention", "motion_pano_s0", (2, 16, 8192, 320, 8)),
    ("frame_attention", "motion_pers_s2", (40, 16, 64, 1280, 8)),
]
REPLACES = {
    "tiny_attention": "imagine360_tpu/ops/pallas_attention.py:345",
    "mh_flash_attention": "imagine360_tpu/ops/pallas_attention.py:482",
    "shared_bias_attention": "imagine360_tpu/ops/pallas_attention.py:699",
    "frame_attention": "imagine360_tpu/ops/pallas_attention.py:406",
}
SOURCES = {
    "tiny_attention": "imagine360_tpu_torch/csrc/tiny_attention.cu",
    "mh_flash_attention": "imagine360_tpu_torch/csrc/mh_flash.cu",
    "shared_bias_attention": "imagine360_tpu_torch/csrc/shared_bias.cu",
    "frame_attention": "imagine360_tpu_torch/csrc/frame_attention.cu",
}


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean ms per call over `iters` calls after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def site_call(kernels, name, shape, gen, dev, dtype=torch.bfloat16):
    """(kernel thunk, plain thunk) on random inputs of this shape and dtype."""
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    if name == "frame_attention":
        B, F, HW, C, heads = shape
        q, k, v = (rnd(B, F, HW, C) for _ in range(3))
        kw = dict(scale=(C // heads) ** -0.5, heads=heads)
        return (lambda: kernels.frame_attention(q, k, v, **kw),
                lambda: kernels.frame_attention_plain(q, k, v, **kw))
    B, Sq, Sk, H, D = shape
    if name == "shared_bias_attention":
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        bias = torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1
        return (lambda: kernels.shared_bias_attention(q, k, v, bias, scale=D ** -0.5),
                lambda: kernels.shared_bias_attention_plain(q, k, v, bias, scale=D ** -0.5))
    q, k, v = rnd(B, Sq, H * D), rnd(B, Sk, H * D), rnd(B, Sk, H * D)
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    kw = dict(scale=D ** -0.5, heads=H)
    return lambda: fn(q, k, v, **kw), lambda: plain(q, k, v, **kw)


def compare(kern, plain):
    """(max abs error, max |plain|, all finite) of one kernel call against
    its plain version."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    return err, want.float().abs().max().item(), bool(torch.isfinite(got).all())


def phase_kernels(kernels, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, per_kernel = [], {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for name, site, shape in SITES:
        kern, plain = site_call(kernels, name, shape, gen, dev)
        err, peak, finite = compare(kern, plain)
        tol = min(BF16_TOL, BF16_REL * peak)
        iters = 3 if shape[0] * shape[1] * shape[2] > 2 ** 27 else 10
        ms = cuda_ms(kern, iters)
        plain_ms = cuda_ms(plain, iters)
        del kern, plain
        torch.backends.cuda.matmul.allow_tf32 = False
        f32_shape = (min(shape[0], F32_ROWS),) + shape[1:]
        err32, _, finite32 = compare(*site_call(kernels, name, f32_shape, gen, dev,
                                                torch.float32))
        torch.backends.cuda.matmul.allow_tf32 = tf32
        rows.append(dict(kernel=name, site=site, shape=list(shape), max_abs_err=err,
                         tol=tol, f32_rows=f32_shape[0], f32_max_abs_err=err32, ms=ms,
                         plain_ms=plain_ms))
        log(f"  {name:22s} {site:22s} {str(shape):30s} bf16 err={err:.3e} "
            f"(tol {tol:.3e}) f32 err={err32:.3e} kernel={ms:.3f} ms plain={plain_ms:.3f} ms")
        if not (finite and finite32 and err <= tol and err32 <= F32_TOL):
            raise SystemExit(f"FAIL: {name} at {site} bf16 err={err} (tol {tol}), "
                             f"f32 err={err32} (tol {F32_TOL})")
        # the JSON line gives each kernel's times at its first (largest) site
        # and its largest bf16 error over all sites
        rec = per_kernel.setdefault(name, dict(site=site, ms=ms, plain_ms=plain_ms,
                                               max_abs_err=err))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        torch.cuda.empty_cache()
    return rows, per_kernel


# ---------------------------------------------------------------------------
# phase 3: tiny parity, CUDA kernels vs CPU plain
# ---------------------------------------------------------------------------


def seeded_init_(model, gen):
    """Every parameter drawn from `gen` (on the parameters' device): weights
    of rank >= 2 ~ N(0, 1/fan_in), norm weights 1 + N(0, 0.1), the rest
    N(0, 0.1). All nonzero, so no zero-initialised projection hides a
    path."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            x = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
            if p.dim() >= 2 and not name.endswith("latents"):
                x /= (p[0].numel()) ** 0.5
            elif name.endswith("weight") and p.dim() == 1:
                x = 1.0 + 0.1 * x
            else:
                x *= 0.1
            p.copy_(x.to(p.dtype))


def tiny_inputs(cfg, M, F, gen):
    f = lambda *s: torch.randn(*s, generator=gen)
    ctx, hid = cfg.pers.cross_attention_dim, cfg.pers.image_hidden_size
    (ph, pw), (eh, ew) = TINY_PERS_HW, TINY_PANO_HW
    return dict(pers=f(2, M, F, ph, pw, 9), pano=f(2, F, eh, ew, 9),
                t=torch.full((2,), 321.0), pers_text=f(2 * M, 7, ctx), pano_text=f(2, 7, ctx),
                fps=torch.full((2,), 8.0), ref_pers=f(2 * M, 16, 16, hid),
                ref_pano=f(2, 16, 16, hid), rel=torch.randint(0, 50, (2, F, 6), generator=gen)
                .float(), pitch=torch.randint(0, 90, (2, F), generator=gen).float())


def run_dual(model, x, geoms, use_opp, dev):
    x = {k: v.to(dev) for k, v in x.items()}
    with torch.no_grad():
        ip_pers, ip_pano = model.compute_ip_tokens(x["ref_pers"], x["ref_pano"], x["rel"],
                                                   x["pitch"])
        return model(x["pers"], x["pano"], x["t"], x["pers_text"], x["pano_text"], x["fps"],
                     geoms, use_opp, ip_pers, ip_pano)


def phase_tiny(dev):
    from imagine360_tpu_torch.geometry.cameras import CameraRig
    from imagine360_tpu_torch.models.dual import DualUNet
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.pipeline.sampler import build_dual_warp_geoms
    from imagine360_tpu_torch.presets import tiny_dual_config

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M, F = 4, 4
    cfg = tiny_dual_config(num_views=M)
    gen = torch.Generator().manual_seed(2)
    cpu_model = DualUNet(cfg).eval()
    seeded_init_(cpu_model, gen)
    x = tiny_inputs(cfg, M, F, gen)
    rig = CameraRig.icosahedron(16).take(M)
    use_opp = [True, False, True, False, False, True, False]
    want = run_dual(cpu_model, x, build_dual_warp_geoms(cfg, rig, TINY_PERS_HW, TINY_PANO_HW),
                    use_opp, "cpu")
    cuda_model = DualUNet(cfg).eval().to(dev)
    cuda_model.load_state_dict(cpu_model.state_dict())
    attn.reset_counts()
    got = run_dual(cuda_model, x,
                   build_dual_warp_geoms(cfg, rig, TINY_PERS_HW, TINY_PANO_HW, device=dev),
                   use_opp, dev)
    torch.cuda.synchronize()
    launches = {k: v["launches"] for k, v in attn.kernels.counts().items()}
    for g, w, label in zip(got, want, ("pers", "pano")):
        err = (g.cpu() - w).abs().max().item()
        scale = w.abs().max().item()
        log(f"  tiny DualUNet {label}: max abs err {err:.3e}, max |out| {scale:.3e}, "
            f"tol {TINY_REL_TOL} x max |out|")
        if not err <= TINY_REL_TOL * scale:
            raise SystemExit(f"FAIL: tiny parity {label} err={err}")
    if attn.plain_path_calls() != 0 or min(launches.values()) == 0:
        raise SystemExit(f"FAIL: tiny CUDA run launches={launches} "
                         f"plain={attn.plain_path_calls()}")
    log(f"  tiny CUDA launches {launches}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# phase 4: the full-width slice
# ---------------------------------------------------------------------------


def phase_slice(dev, steps=SLICE_STEPS):
    from imagine360_tpu_torch.geometry.cameras import CameraRig
    from imagine360_tpu_torch.models.dual import DualUNet
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.pipeline.conditioning import init_shared_noise
    from imagine360_tpu_torch.pipeline.sampler import (DualDiffusionSampler, SamplerConfig,
                                                       build_dual_warp_geoms)
    from imagine360_tpu_torch.presets import full_dual_config

    frames, M = 16, 20
    bf = torch.bfloat16
    cfg = full_dual_config("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()
    with torch.device(dev):
        model = DualUNet(cfg)
    model = model.to(bf).eval()
    seeded_init_(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    rig = CameraRig.icosahedron(image_size=256)
    geoms = build_dual_warp_geoms(cfg, rig, (32, 32), (64, 128), device=dev)
    torch.cuda.synchronize()
    log(f"  model {n_params / 1e9:.3f} B params, geometry, set-up {time.time() - t0:.1f} s")

    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=torch.float32).to(bf)
    pano_lat, pers_lat = init_shared_noise(gen, 1, frames, (64, 128), (32, 32), rig)
    pano_mask = (torch.rand(1, frames, 64, 128, 1, generator=gen, device=dev) > 0.5).float()
    pers_mask = (torch.rand(1, M, frames, 32, 32, 1, generator=gen, device=dev) > 0.5).float()
    pano_masked, pers_masked = rnd(1, frames, 64, 128, 4).float(), \
        rnd(1, M, frames, 32, 32, 4).float()
    pano_text, pers_text = rnd(2, 77, 1024), rnd(2 * M, 77, 1024)
    fps = torch.full((2,), 8.0, device=dev)
    ref_pano, ref_pers = rnd(2, 16, 4096, 256), rnd(2 * M, 16, 4096, 256)
    rel = torch.randint(0, 50, (2, frames, 6), generator=gen, device=dev).float()
    pitch = torch.randint(0, 90, (2, frames), generator=gen, device=dev).float()
    sampler = DualDiffusionSampler(model, SamplerConfig(num_steps=50, add_ip_noise=True))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_counts()
    t0 = time.time()
    ip_pers, ip_pano = sampler.compute_ip(ref_pers, ref_pano, rel, pitch)
    torch.cuda.synchronize()
    ip_s = time.time() - t0
    del ref_pano, ref_pers
    t0 = time.time()
    pano_out, pers_out = sampler.denoise(
        pano_lat, pers_lat, pano_mask, pano_masked, pers_mask, pers_masked, pano_text,
        pers_text, geoms, fps, ip_pers, ip_pano, generator=gen, num_steps=steps)
    torch.cuda.synchronize()
    loop_s = time.time() - t0
    counts = attn.kernels.counts()
    plain = attn.plain_path_calls()
    peak = torch.cuda.max_memory_allocated()
    log(f"  compute_ip {ip_s:.3f} s; {steps} CFG DDIM steps {loop_s:.3f} s = "
        f"{loop_s / steps:.3f} s/step; peak device memory {peak / 2**30:.2f} GiB")
    log(f"  main-path launches {json.dumps(counts)}; plain-path attention calls {plain}")
    ok_shape = (tuple(pano_out.shape) == (1, frames, 64, 128, 4)
                and tuple(pers_out.shape) == (1, M, frames, 32, 32, 4))
    finite = bool(torch.isfinite(pano_out).all() and torch.isfinite(pers_out).all())
    log(f"  latents: shapes ok {ok_shape}, finite {finite}, "
        f"pano std {pano_out.float().std().item():.4f}, "
        f"pers std {pers_out.float().std().item():.4f}")
    if not (ok_shape and finite):
        raise SystemExit("FAIL: slice latents wrong shape or not finite")
    if plain != 0 or min(c["launches"] for c in counts.values()) == 0:
        raise SystemExit(f"FAIL: slice launches={counts} plain={plain}")
    return {k: c["launches"] for k, c in counts.items()}, dict(
        s_per_step=loop_s / steps, compute_ip_s=ip_s, peak_bytes=peak, steps=steps)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the build report and "
                    "a JSON copy of the results")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SCRIPT_DIR)
    from imagine360_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    lib = kernels.build_library()
    kernels.load_library()
    log(f"phase 1: built {lib.name} in {time.time() - t0:.1f} s")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
            f.write(lib.with_suffix(".ptxas.txt").read_text())

    log("phase 2: kernels vs plain, bf16, production shapes")
    rows, per_kernel = phase_kernels(kernels, dev)
    log("phase 3: tiny DualUNet, f32, CUDA kernels vs CPU plain")
    phase_tiny(dev)
    log(f"phase 4: full_dual_config bf16, compute_ip + {SLICE_STEPS} CFG DDIM steps")
    launches, slice_stats = phase_slice(dev)

    report = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
         "launches": launches[n], "max_abs_err": per_kernel[n]["max_abs_err"],
         "ms": per_kernel[n]["ms"], "plain_ms": per_kernel[n]["plain_ms"],
         "site": per_kernel[n]["site"]} for n in SOURCES]}
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": smi, "sites": rows, "slice": slice_stats, **report}, f,
                      indent=1)
    print(json.dumps(report))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
