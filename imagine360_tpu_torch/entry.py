"""One full-width dual-branch denoise forward as a callable and its arguments
(counterpart of the repo's `__graft_entry__.py:entry`): `full_dual_config`
in bfloat16, the CFG pair (batch 2), 20 perspective views and the pano, 8
frames, 16 SAM frames, on the latent sizes of a 512 x 1024 panorama (views
of 256 x 256).

The weights are seeded random values drawn from an explicit
torch.Generator (`utils/init.py:seeded_init_`), not zeros: zero weights
make every softmax flat and hide any path. The inputs are drawn from the
same generator, the timestep is 500, the fps 8, and no antipodal mask is
taken. The callable computes the IP tokens from the SAM features, then runs
the forward without IP-token noise, as the JAX entry's
`add_ip_noise=False` does.

    fn, args = entry()           # on the card
    pers_out, pano_out = fn(*args)

`dryrun_multidevice(n_ranks)` is the counterpart of the repo's
`__graft_entry__.py:dryrun_multichip`: the multi-device design
(parallel/mesh.py) on `n_ranks` gloo processes on the CPU at
micro_dual_config, each case beside the same case in one process.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from .geometry.cameras import CameraRig
from .models.dual import DualUNet, DualUNetConfig, warp_sites
from .pipeline.sampler import build_dual_warp_geoms
from .presets import full_dual_config
from .utils.device import require_device
from .utils.init import seeded_init_

FRAMES = 8
SAM_FRAMES = 16
PERS_LATENT_HW = (32, 32)       # 256 x 256 views
PANO_LATENT_HW = (64, 128)      # a 512 x 1024 panorama
TEXT_LEN = 77
SAM_TOKENS = 4096               # SAM ViT-B's 64 x 64 feature map
TIMESTEP, FPS = 500.0, 8.0


def flagship_shapes(cfg: DualUNetConfig, frames: int = FRAMES, sam_frames: int = SAM_FRAMES,
                    pers_latent_hw=PERS_LATENT_HW, pano_latent_hw=PANO_LATENT_HW,
                    text_len: int = TEXT_LEN, sam_tokens: int = SAM_TOKENS) -> dict:
    """The shapes of the forward's tensor arguments, by name, in order."""
    B, M = 2, cfg.num_views
    ctx, sam = cfg.pers.cross_attention_dim, cfg.pers.image_hidden_size
    return {
        "pers_latents": (B, M, frames, *pers_latent_hw, 9),     # latents + mask + masked
        "pano_latent": (B, frames, *pano_latent_hw, 9),
        "timestep": (B,),
        "pers_text": (B * M, text_len, ctx),
        "pano_text": (B, text_len, ctx),
        "fps": (B,),
        "ref_feats_pers": (B * M, sam_frames, sam_tokens, sam),
        "ref_feats_pano": (B, sam_frames, sam_tokens, sam),
        "rel_pos": (B, frames, 6),
        "pitch": (B, frames),
    }


def entry(device=None, cfg: Optional[DualUNetConfig] = None, seed: int = 0, **shape_kw):
    """-> (fn, args): `fn(*args)` is one denoise forward of `cfg` (default
    full_dual_config("bfloat16")) on `device` (default the card; "cpu" runs
    it on the CPU through the plain attention versions) and returns
    (pers_out [2, M, F, h, w, 4] or None under pano_only, pano_out
    [2, F, eh, ew, 4]). args are the tensors of `flagship_shapes(cfg,
    **shape_kw)`, then the WarpAttn geometry and the 7 antipodal choices."""
    dev = require_device("cuda" if device is None else device)
    cfg = cfg or full_dual_config("bfloat16")
    dtype = cfg.pano.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        model = DualUNet(cfg)
    model = model.to(dtype).eval()
    with torch.no_grad():
        seeded_init_(model, gen)

    shapes = flagship_shapes(cfg, **shape_kw)
    pers_hw, pano_hw = shapes["pers_latents"][3:5], shapes["pano_latent"][2:4]
    rig = CameraRig.icosahedron(image_size=8 * pers_hw[0]).take(cfg.num_views)
    geoms = build_dual_warp_geoms(cfg, rig, pers_hw, pano_hw, device=dev)

    def draw(name):
        s = shapes[name]
        if name == "timestep":
            return torch.full(s, TIMESTEP, device=dev)
        if name == "fps":
            return torch.full(s, FPS, device=dev)
        if name == "rel_pos":
            return torch.randint(0, 50, s, generator=gen, device=dev).float()
        if name == "pitch":
            return torch.randint(0, 90, s, generator=gen, device=dev).float()
        return torch.randn(s, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    use_opp = [False] * len(warp_sites(len(cfg.pers.block_out_channels)))
    args = tuple(draw(name) for name in shapes) + (geoms, use_opp)

    @torch.no_grad()
    def fn(pers_latents, pano_latent, timestep, pers_text, pano_text, fps, ref_feats_pers,
           ref_feats_pano, rel_pos, pitch, warp_geoms, opp):
        ip_pers, ip_pano = model.compute_ip_tokens(ref_feats_pers, ref_feats_pano, rel_pos,
                                                   pitch)
        return model(pers_latents, pano_latent, timestep, pers_text, pano_text, fps,
                     warp_geoms, opp, ip_pers, ip_pano)

    return fn, args


# ---------------------------------------------------------------------------
# multi-device dry run
# ---------------------------------------------------------------------------

DRYRUN_VIEWS, DRYRUN_FRAMES = 8, 2
DRYRUN_PERS_HW, DRYRUN_PANO_HW = (8, 8), (8, 16)
# a pano latent whose stage heights (6 / 3) do not divide 2 ranks: replicated
DRYRUN_REPLICATED_PANO_ROWS = 6
DRYRUN_TEXT_LEN, DRYRUN_SAM_TOKENS, DRYRUN_SAM_FRAMES = 7, 16, 4
DRYRUN_STEPS = 2
DRYRUN_FRAME_BATCH = 16          # SAM's and the VAE's frames, split over the ranks
DRYRUN_RANK_TIMEOUT_S = 300


def _dryrun_configs():
    from .models.sam import SAMConfig
    from .models.vae import VAEConfig
    from .presets import micro_dual_config

    sam = SAMConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=4,
                    out_chans=16, window_size=2, global_attn_indexes=(1,), global_q_rows=2)
    vae = VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
    return micro_dual_config(num_views=DRYRUN_VIEWS), sam, vae


def dryrun_inputs(seed: int = 0) -> dict:
    """The dry run's weights and inputs, on the CPU, drawn from a generator
    seeded with `seed`: "state_dict" of the DualUNet, "denoise" (the
    sampler's latents, masks and conditioning, CFG pairs), "train_batch"
    (make_dual_batch) and "train_draws" (t, noise_pers, noise_pano, use_opp,
    ip_noise: the draws of one train step). A parity test replaces them
    with another package's."""
    from .training.train import make_dual_batch

    cfg, _, _ = _dryrun_configs()
    gen = torch.Generator().manual_seed(seed)
    model = DualUNet(cfg)
    seeded_init_(model, gen)
    M, F = DRYRUN_VIEWS, DRYRUN_FRAMES
    (ph, pw), (eh, ew) = DRYRUN_PERS_HW, DRYRUN_PANO_HW
    ctx, hid = cfg.pers.cross_attention_dim, cfg.pers.image_hidden_size
    n_tok, c_tok = cfg.pers.num_ip_tokens, cfg.pers.image_cross_attention_dim

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    def mask(*shape):
        return (torch.rand(*shape, generator=gen) > 0.5).float()

    denoise = dict(pano=rnd(1, F, eh, ew, 4), pers=rnd(1, M, F, ph, pw, 4),
                   pano_mask=mask(1, F, eh, ew, 1), pano_masked=rnd(1, F, eh, ew, 4),
                   pers_mask=mask(1, M, F, ph, pw, 1), pers_masked=rnd(1, M, F, ph, pw, 4),
                   pano_text=rnd(2, DRYRUN_TEXT_LEN, ctx),
                   pers_text=rnd(2 * M, DRYRUN_TEXT_LEN, ctx),
                   ref_pano=rnd(2, DRYRUN_SAM_FRAMES, DRYRUN_SAM_TOKENS, hid),
                   ref_pers=rnd(2 * M, DRYRUN_SAM_FRAMES, DRYRUN_SAM_TOKENS, hid),
                   rel=torch.randint(0, 50, (2, F, 6), generator=gen).float(),
                   pitch=torch.randint(0, 90, (2, F), generator=gen).float(),
                   fps=torch.full((2,), FPS))
    batch = make_dual_batch(gen, cfg, F, DRYRUN_PERS_HW, DRYRUN_PANO_HW, text_len=DRYRUN_TEXT_LEN,
                            sam_tokens=DRYRUN_SAM_TOKENS, sam_frames=DRYRUN_SAM_FRAMES,
                            device="cpu")
    for k in ("pers_mask", "pano_mask"):        # every input channel counts
        batch[k] = mask(*batch[k].shape)
    for k in ("pers_masked", "pano_masked"):
        batch[k] = rnd(*batch[k].shape)
    n_sites = len(warp_sites(len(cfg.pers.block_out_channels)))
    draws = dict(t=torch.randint(0, 1000, (1,), generator=gen),
                 noise_pers=rnd(*batch["pers_latents"].shape),
                 noise_pano=rnd(*batch["pano_latents"].shape),
                 use_opp=(torch.rand(n_sites, generator=gen) < 0.5).tolist(),
                 ip_noise=(rnd(M, n_tok, c_tok), rnd(1, n_tok, c_tok)))
    return dict(state_dict=model.state_dict(), denoise=denoise, train_batch=batch,
                train_draws=draws)


def _dryrun_cases(inputs: dict, meshes: dict, n_ranks: int) -> dict:
    """Every case of the dry run, each under its mesh of `meshes` (None for
    all: one process); returns the results by case, whole tensors on every
    rank. `n_ranks` sets the per-rank weights of the gather_views case."""
    from .models.sam import SAMImageEncoder
    from .models.vae import AutoencoderKL
    from .parallel.mesh import (activate_mesh, gather_views, map_sharded, pano_layout,
                                shard_views)
    from .pipeline.conditioning import prepare_masked_latents
    from .pipeline.sampler import DualDiffusionSampler, SamplerConfig
    from .training.train import Optimizer, TrainConfig, TrainState, make_train_step

    cfg, sam_cfg, vae_cfg = _dryrun_configs()
    rig = CameraRig.icosahedron(image_size=8 * DRYRUN_PERS_HW[0]).take(DRYRUN_VIEWS)
    out = {}

    def dual(train: bool, remat: bool = False):
        unet = dataclasses.replace(cfg.pers, remat=remat)
        model = DualUNet(dataclasses.replace(cfg, pers=unet, pano=unet))
        model.load_state_dict(inputs["state_dict"])
        return model.train() if train else model.eval()

    def geoms(pano_hw=DRYRUN_PANO_HW):      # under the active mesh: this rank's rows
        return build_dual_warp_geoms(cfg, rig, DRYRUN_PERS_HW, pano_hw, device="cpu")

    x = inputs["denoise"]
    levels = len(cfg.pano.block_out_channels)
    out["pano_layout"] = {}
    for case, draws in (("denoise", False), ("denoise_r2", False), ("denoise_draws", True),
                        ("denoise_replicated", False)):
        rows = DRYRUN_REPLICATED_PANO_ROWS if case == "denoise_replicated" else None
        pano = {k: x[k][:, :, :rows] for k in ("pano", "pano_mask", "pano_masked")}
        with activate_mesh(meshes[case]):
            out["pano_layout"][case] = pano_layout(pano["pano"].shape[2], levels)
            sampler = DualDiffusionSampler(dual(False), SamplerConfig(
                num_steps=DRYRUN_STEPS, add_ip_noise=draws,
                antipodal_prob=0.4 if draws else 0.0))
            ip_pers, ip_pano = sampler.compute_ip(x["ref_pers"], x["ref_pano"], x["rel"],
                                                  x["pitch"])
            out[case] = sampler.denoise(
                pano["pano"], x["pers"], pano["pano_mask"], pano["pano_masked"],
                x["pers_mask"], x["pers_masked"], x["pano_text"], x["pers_text"],
                geoms(tuple(pano["pano"].shape[2:4])), x["fps"], ip_pers, ip_pano,
                generator=torch.Generator().manual_seed(7))
    with activate_mesh(meshes["shapes"]):
        out["shapes"] = _forward_shapes(dual(False), x, geoms())

    class Recording(Optimizer):     # keeps the gradients the update was given
        def update(self, grads, state, params):
            self.grads = {n: g.detach().clone() for n, g in grads.items()}
            return super().update(grads, state, params)

    batch, d = inputs["train_batch"], inputs["train_draws"]
    for case, remat in (("train", False), ("train_remat", True)):
        with activate_mesh(meshes[case]):
            model = dual(True, remat)
            opt = Recording(TrainConfig(lr=1e-4, weight_decay=1e-2, antipodal_prob=0.5))
            step, _ = make_train_step(model, geoms(), optimizer=opt, train_cfg=opt.cfg,
                                      device="cpu")
            state, metrics = step(TrainState.create(model, opt), batch, t=d["t"],
                                  noise_pers=d["noise_pers"], noise_pano=d["noise_pano"],
                                  use_opp=d["use_opp"], ip_noise=d["ip_noise"])
            out[case] = dict(metrics, grads=opt.grads,
                             params={n: p.clone() for n, p in state.params.items()})

    with activate_mesh(meshes["ema_accum"]):
        model = dual(True)
        tc = TrainConfig(lr=1e-3, ema_decay=0.9, accum_steps=2, antipodal_prob=0.0)
        step, opt = make_train_step(model, geoms(), train_cfg=tc, device="cpu")
        state = TrainState.create(model, opt, ema=True)
        rec = {"params_0": {n: p.clone() for n, p in state.params.items()}}
        for i, seed in enumerate((3, 4), start=1):
            state, metrics = step(state, batch, torch.Generator().manual_seed(seed))
            rec[f"loss_{i}"] = metrics["loss"]
            rec[f"params_{i}"] = {n: p.clone() for n, p in state.params.items()}
        rec["ema"] = {n: p.clone() for n, p in state.ema_params.items()}
        out["ema_accum"] = rec

    gen = torch.Generator().manual_seed(11)
    sam, vae = SAMImageEncoder(sam_cfg).eval(), AutoencoderKL(vae_cfg).eval()
    for m in (sam, vae):
        seeded_init_(m, gen)
    frames = torch.rand(DRYRUN_FRAME_BATCH, 64, 64, 3, generator=gen) * 2 - 1
    with activate_mesh(meshes["conditioning"]), torch.no_grad():
        z = prepare_masked_latents(vae, frames[:, :32, :32], deterministic=True)
        out["conditioning"] = dict(
            sam=map_sharded(sam, frames),
            vae_mean=z,
            vae_sample=prepare_masked_latents(vae, frames[:, :32, :32],
                                              torch.Generator().manual_seed(5), chunk=4),
            vae_decode=map_sharded(vae.decode, z))

    # the gradient of sum_r <gather(x), w_r>: every rank's weights reach every view
    full = torch.arange(2 * DRYRUN_VIEWS * 3, dtype=torch.float32).reshape(2, DRYRUN_VIEWS, 3)
    weights = torch.randn(n_ranks, *full.shape, generator=torch.Generator().manual_seed(13))
    with activate_mesh(meshes["gather_grad"]) as mesh:
        xs = shard_views(full, 1).clone().requires_grad_(True)
        if mesh is None:
            loss = sum((xs * w).sum() for w in weights)
        else:
            loss = (gather_views(xs, 1) * weights[mesh.rank]).sum()
        loss.backward()
        out["gather_grad"] = gather_views(xs.grad, 1)
    with activate_mesh(meshes["row_units"]) as mesh:
        out["row_units"] = _row_units(mesh, n_ranks)
    return out


def _forward_shapes(model, x, geoms) -> dict:
    """One CFG forward of the dual model at t=500 without grad, under the
    active mesh, recording what reached the attention entry points ((B, Sq,
    Sk, H, D) in call order, the frame attention's as (B*HW, F, F, heads,
    D)) and the latent rows of every pano activation a GroupNorm of the
    pano branch saw."""
    from .models.layers import GroupNorm
    from .ops import attention

    seen, rows = [], []
    real = attention.log_route
    attention.log_route = lambda route, *shape: seen.append(shape[:5])
    hooks = [m.register_forward_pre_hook(lambda _, a: rows.append(a[0].shape[2]))
             for m in model.pano_unet.modules() if isinstance(m, GroupNorm)]
    try:
        with torch.no_grad():
            ip_pers, ip_pano = model.compute_ip_tokens(x["ref_pers"], x["ref_pano"], x["rel"],
                                                       x["pitch"])
            del seen[:]
            pano = torch.cat([x["pano"], x["pano_mask"], x["pano_masked"]], -1).repeat(
                2, 1, 1, 1, 1)
            pers = torch.cat([x["pers"], x["pers_mask"], x["pers_masked"]], -1).repeat(
                2, 1, 1, 1, 1, 1)
            model(pers, pano, torch.full((2,), TIMESTEP), x["pers_text"], x["pano_text"],
                  x["fps"], geoms, [False] * len(warp_sites(len(
                      model.cfg.pers.block_out_channels))), ip_pers, ip_pano)
    finally:
        attention.log_route = real
        for h in hooks:
            h.remove()
    return dict(attention=seen, pano_rows=rows)


def _row_units(mesh, n_ranks: int) -> dict:
    """The pano-row pieces alone on a seeded [1, 2, 8, 6, 8] tensor (mean
    50, so the merged GroupNorm statistics meet a large mean): a 3x3 conv,
    the stride-2 downsample and the upsample (each through the halo), the
    GroupNorm and the row gather itself, each under `mesh`'s rows (whole
    with no mesh). Per unit: the output and the gradient of the input
    gathered whole, and the parameters' gradients summed over the ranks,
    for the loss sum_r <out, w_r> with weights that differ by rank."""
    from .models.layers import GroupNorm, InflatedConv
    from .models.resnet import Downsample3D, Upsample3D
    from .parallel.mesh import gather_pano, reduce_sum, shard_pano

    gen = torch.Generator().manual_seed(17)
    x = torch.randn(1, 2, 8, 6, 8, generator=gen) + 50.0
    units = dict(conv=InflatedConv(8, 8, 3, 1, 1), down=Downsample3D(8), up=Upsample3D(8),
                 norm=GroupNorm(4, 8, 1e-6), gather=None)
    res = {}
    for name, unit in units.items():
        if unit is not None:
            seeded_init_(unit, gen)
        xs = shard_pano(x, mesh).clone().requires_grad_(True)
        y = xs if unit is None else unit(xs, mesh)
        y = gather_pano(y, mesh)
        weights = torch.randn(n_ranks, *y.shape, generator=gen)
        loss = (sum((y * w).sum() for w in weights) if mesh is None
                else (y * weights[mesh.rank]).sum())
        loss.backward()
        params = {} if unit is None else {n: reduce_sum(p.grad)
                                          for n, p in unit.named_parameters()}
        res[name] = dict(out=y.detach(), grad=gather_pano(xs.grad, mesh), params=params)
    return res


DRYRUN_CASES = ("denoise", "denoise_r2", "denoise_draws", "denoise_replicated", "shapes",
                "train", "train_remat", "ema_accum", "conditioning", "gather_grad",
                "row_units")


def _dryrun_rank(rank: int, n_ranks: int, store_path: str, inputs_path: str,
                 out_dir: str) -> None:
    """One rank of dryrun_multidevice (the spawn target): a gloo group over a
    FileStore, two torch threads, every case under its mesh, the results
    written to out_dir/rank<r>.pt. A failure is written to
    out_dir/rank<r>.err and re-raised."""
    from .parallel.mesh import TIMEOUT, destroy, make_mesh

    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, n_ranks), rank=rank,
                                world_size=n_ranks, timeout=TIMEOUT)
        r1 = make_mesh(1, "cpu", views=DRYRUN_VIEWS)
        r2 = make_mesh(2, "cpu", views=DRYRUN_VIEWS) if n_ranks % 2 == 0 else r1
        meshes = dict.fromkeys(DRYRUN_CASES, r1)
        meshes["denoise_r2"] = meshes["ema_accum"] = r2
        results = _dryrun_cases(torch.load(inputs_path, weights_only=False), meshes, n_ranks)
        results["mesh"] = dict(r1=(r1.world, r1.rank, r1.replicas, r1.view_size),
                               r2=(r2.world, r2.rank, r2.replicas, r2.view_size),
                               backend=dist.get_backend())
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        destroy()


def dryrun_multidevice(n_ranks: int = 2, inputs: Optional[dict] = None,
                       out_dir: Optional[str] = None) -> dict:
    """Validates the multi-device design (parallel/mesh.py) on `n_ranks`
    gloo processes on the CPU, at micro_dual_config with 8 views (which
    must divide over `n_ranks`: 1, 2, 4 or 8). Every case runs in the
    spawned ranks under a mesh, and in this process without one:

    - "denoise": compute_ip and 2 CFG DDIM steps, mesh_replicas 1, the
      pano's rows sharded where its stage heights (8 / 4) divide `n_ranks`;
      "denoise_r2" the same with mesh_replicas 2 (an even `n_ranks`);
      "denoise_draws" with the IP-token noise and the antipodal choice
      drawn from a generator; "denoise_replicated" on a pano of 6 latent
      rows, replicated over 2 ranks; "pano_layout" the rule's choice for
      each; "shapes" what one forward passed to the attention entry points
      and the latent rows each pano GroupNorm saw;
    - "train": one AdamW step of make_train_step on the given draws: loss,
      grad norm, the gradients the optimizer took (all-reduced) and the
      weights after; "train_remat" the same with remat on (WarpAttn's
      gather recomputed in the backward);
    - "ema_accum": two calls with EMA and accum_steps=2, mesh_replicas 2;
    - "conditioning": a small SAM encoder and VAE encode (mean and sample)
      and decode through map_sharded;
    - "gather_grad": the gradient through gather_views of a loss whose
      weights differ by rank;
    - "row_units": the halo conv (also at stride 2 and after the upsample),
      the merged GroupNorm and the row gather alone (_row_units).

    `inputs` (dryrun_inputs' keys) replaces the seeded weights and inputs.
    Returns {"ranks": [each rank's results], "single": the one-process
    results}. The ranks write to `out_dir` (a temporary directory when
    None); they import torch and this package only."""
    import multiprocessing

    inputs = dryrun_inputs() if inputs is None else inputs
    with tempfile.TemporaryDirectory(prefix="i360_dryrun_") as tmp:
        out_dir = out_dir or tmp
        inputs_path = os.path.join(out_dir, "inputs.pt")
        torch.save(inputs, inputs_path)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_dryrun_rank, args=(
            r, n_ranks, os.path.join(tmp, "store"), inputs_path, out_dir))
            for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            single = _dryrun_cases(inputs, dict.fromkeys(DRYRUN_CASES), n_ranks)
        finally:
            for p in procs:
                p.join(DRYRUN_RANK_TIMEOUT_S)
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            detail = ""
            for r in failed:
                err = os.path.join(out_dir, f"rank{r}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        detail += f.read()
            raise RuntimeError(f"dryrun_multidevice: ranks {failed} failed\n{detail}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(n_ranks)]
    return {"ranks": ranks, "single": single}
