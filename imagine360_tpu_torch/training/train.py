"""Dual-branch latent-diffusion training step, v-prediction (counterpart of
imagine360_tpu/training/train.py): MSE on both branches against the
velocity target, one AdamW step.

Differences from the JAX package, which is functional:

- the weights live in the `DualUNet` module. `TrainState.params` are the
  float32 master weights by parameter name: the module's own tensors when it
  is float32, float32 copies when it computes in bfloat16 (the module's
  weights are then refreshed from the masters after every update);
- the optimizer updates masters and moments in place, parameter by
  parameter, so no second copy of the weights or the gradients is held;
- every random draw of a step (timestep, the two noises, the antipodal
  choice per WarpAttn site, the IP-token noise) comes from an explicit
  `torch.Generator`, or is passed in as a tensor, which is how a parity run
  gives both packages the same draws;
- forward, backward and optimizer run inside `torch.profiler` ranges
  (`i360::train_forward`, `_backward`, `_optimizer`), which cost nothing
  measurable when no profiler is on;
- under a mesh (parallel/mesh.py) each rank runs its views of the
  perspective branch and the pano (its latent rows where they shard, the
  model gathering the prediction whole), on the whole batch and full-size
  draws. Its loss is Lpano / W + sum over its views of (pred - v)^2 / the
  element count of all views, so the ranks' losses sum to the one-process
  loss (the gather's backward sums the W shares of the pano term's
  gradient); every gradient is all-reduced (summed) before the norm, the clip, the
  accumulation and AdamW, which then run alike on every rank. The reported
  loss is the sum over the ranks.

`Optimizer` reproduces the optax chain the JAX package builds
(`make_optimizer` there): `adamw` with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8 added to sqrt(v_hat), decoupled decay on every parameter, the
learning rate read at the count before it is incremented),
`warmup_cosine_decay_schedule` to 10% of lr or `linear_schedule` warm-up,
`clip_by_global_norm` (scale by max/norm only when norm >= max), and
`MultiSteps` (running mean of the k gradients; between boundaries neither
the weights nor the schedule move).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.profiler import record_function

from ..diffusion.ddim import NUM_TRAIN_TIMESTEPS, add_noise, get_velocity, make_ddim_schedule
from ..models.dual import DualUNet, DualUNetConfig, warp_sites
from ..parallel.mesh import all_reduce_grads, current_mesh, reduce_sum, shard_views
from ..utils.device import require_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8     # optax.adamw defaults
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-2
    warmup_steps: int = 0
    total_steps: int = 0          # >0 enables cosine decay to 10% of lr
    grad_clip: float = 0.0        # >0 enables global-norm clipping
    ema_decay: float = 0.0        # >0 enables EMA shadow params
    accum_steps: int = 1          # >1 enables gradient accumulation
    antipodal_prob: float = 0.4


@dataclasses.dataclass
class TrainState:
    params: Params                # float32 master weights by parameter name
    opt_state: dict
    step: int = 0
    ema_params: Optional[Params] = None    # shadow weights when ema_decay > 0

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: "Optimizer",
               ema: bool = False) -> "TrainState":
        """State bound to `model`: its float32 parameters themselves, or
        float32 master copies of its lower-precision ones."""
        params = {n: p.detach() if p.dtype == torch.float32 else p.detach().float()
                  for n, p in model.named_parameters()}
        ema_params = {n: p.clone() for n, p in params.items()} if ema else None
        return cls(params, optimizer.init(params), 0, ema_params)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, float32 (optax.global_norm)."""
    return torch.sqrt(torch.stack([t.float().pow(2).sum() for t in tensors]).sum())


class Optimizer:
    """The optax chain of `TrainConfig` (see the module docstring), updating
    in place. State: `count` (AdamW and schedule steps taken), `mu`, `nu`,
    and with accumulation `mini_step` and `acc_grads`."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    def learning_rate(self, count: int) -> float:
        """The schedule at `count` AdamW steps taken so far."""
        c = self.cfg
        if c.total_steps:
            warm, end = max(c.warmup_steps, 1), c.lr * 0.1
            if count < warm:
                return c.lr * count / warm
            decay_steps = c.total_steps - warm
            alpha = 0.0 if c.lr == 0.0 else end / c.lr
            n = min(count - warm, decay_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * n / decay_steps))
            return c.lr * ((1.0 - alpha) * cosine + alpha)
        if c.warmup_steps:
            return c.lr * min(count, c.warmup_steps) / c.warmup_steps
        return c.lr

    def init(self, params: Params) -> dict:
        state = {"count": 0,
                 "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                 "nu": {n: torch.zeros_like(p) for n, p in params.items()}}
        if self.cfg.accum_steps > 1:
            state["mini_step"] = 0
            state["acc_grads"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params) -> bool:
        """One call of the chain on `grads`, in place on `params` and
        `state`. Returns whether an AdamW step was taken (False between the
        boundaries of an accumulation)."""
        c = self.cfg
        if c.accum_steps > 1:
            n_acc = state["mini_step"]
            acc = state["acc_grads"]
            for n, g in grads.items():          # running mean of the k gradients
                acc[n].add_((g.float() - acc[n]) / (n_acc + 1))
            state["mini_step"] = (n_acc + 1) % c.accum_steps
            if n_acc != c.accum_steps - 1:
                return False
            grads = acc
        clip = None
        if c.grad_clip:
            norm = global_norm(list(grads.values()))
            if not bool(norm < c.grad_clip):
                clip = norm
        lr = self.learning_rate(state["count"])
        state["count"] += 1
        bc1 = 1.0 - ADAM_B1 ** state["count"]
        bc2 = 1.0 - ADAM_B2 ** state["count"]
        for n, p in params.items():
            g = grads[n].float()
            if clip is not None:
                g = (g / clip) * c.grad_clip
            mu, nu = state["mu"][n], state["nu"][n]
            mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            u.add_(p, alpha=c.weight_decay)
            p.add_(u, alpha=-lr)
        if c.accum_steps > 1:
            for a in state["acc_grads"].values():
                a.zero_()
        return True


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def make_dual_batch(generator: torch.Generator, cfg: DualUNetConfig, num_frames: int,
                    pers_hw, equi_hw, text_len: int = 77, sam_tokens: int = 4096,
                    sam_frames: int = 16, device="cuda") -> Dict[str, torch.Tensor]:
    """Synthetic latent-space training batch with the production shapes, all
    float32 on `device` (the card unless the caller asks for "cpu"), drawn
    from `generator` (which must live on that device)."""
    device = require_device(device)
    m = cfg.num_views
    (ph, pw), (eh, ew) = pers_hw, equi_hw
    sam_c, txt_c = cfg.pano.image_hidden_size, cfg.pano.cross_attention_dim

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device, dtype=torch.float32)

    def zeros(*shape):
        return torch.zeros(*shape, device=device, dtype=torch.float32)

    return {
        "pers_latents": normal(1, m, num_frames, ph, pw, 4),
        "pano_latents": normal(1, num_frames, eh, ew, 4),
        "pers_mask": zeros(1, m, num_frames, ph, pw, 1),
        "pers_masked": zeros(1, m, num_frames, ph, pw, 4),
        "pano_mask": zeros(1, num_frames, eh, ew, 1),
        "pano_masked": zeros(1, num_frames, eh, ew, 4),
        "pers_text": normal(m, text_len, txt_c),
        "pano_text": normal(1, text_len, txt_c),
        "ref_feats_pers": normal(m, sam_frames, sam_tokens, sam_c),
        "ref_feats_pano": normal(1, sam_frames, sam_tokens, sam_c),
        "rel_pos": normal(1, num_frames, 6).abs() * 10,
        "pitch": normal(1, num_frames) * 5,
        "fps": torch.full((1,), 8.0, device=device, dtype=torch.float32),
    }


def make_train_step(model: DualUNet, warp_geoms, optimizer: Optional[Optimizer] = None,
                    antipodal_prob: float = 0.4, train_cfg: Optional[TrainConfig] = None,
                    device="cuda") -> Callable:
    """Returns (train_step, optimizer).

    train_step(state, batch, generator=None, *, t=None, noise_pers=None,
    noise_pano=None, use_opp=None, ip_noise=None) -> (state, metrics), with
    metrics = {"loss", "grad_norm"} (0-dim float32 tensors; the norm is the
    unclipped global norm of this call's gradients). `state` must come from
    `TrainState.create(model, optimizer)`. The model and the batch live on
    `device`: the card unless the caller asks for "cpu"; a missing card
    raises.

    Each draw is taken from the argument when given, else from `generator`:
    `t` [1] integer timestep; `noise_pers` / `noise_pano` shaped like the
    latents; `use_opp` one bool per WarpAttn site (probability
    cfg.antipodal_prob); `ip_noise` a pair (pers, pano) of unit-variance
    tensors shaped like the IP tokens, or None entries for no noise."""
    cfg = train_cfg or TrainConfig(antipodal_prob=antipodal_prob)
    device = require_device(device)
    if optimizer is None:
        optimizer = make_optimizer(cfg)
    acp = torch.from_numpy(make_ddim_schedule(50).alphas_cumprod).to(device)
    n_sites = len(warp_sites(len(model.cfg.pers.block_out_channels)))
    named = dict(model.named_parameters())
    for n, p in named.items():
        if p.device.type != device.type:
            raise ValueError(f"make_train_step: parameter {n} is on {p.device}, not {device}")

    def draw(generator, given, what, fn):
        if given is not None:
            return given
        if generator is None:
            raise ValueError(f"train_step draws {what}: pass a torch.Generator or the tensor")
        return fn(generator)

    def loss_fn(batch, generator, t, noise_pers, noise_pano, use_opp, ip_noise):
        dt = model.unet.conv_in.weight.dtype
        mesh = current_mesh()
        world = 1 if mesh is None else mesh.world
        # this rank's views of the perspective tensors (all of them with no mesh)
        pers = {k: shard_views(batch[k], 1) for k in ("pers_latents", "pers_mask",
                                                       "pers_masked")}
        noise_p = shard_views(noise_pers, 1)
        x_p = add_noise(pers["pers_latents"], noise_p, acp, t)
        x_a = add_noise(batch["pano_latents"], noise_pano, acp, t)
        v_p = get_velocity(pers["pers_latents"], noise_p, acp, t)
        v_a = get_velocity(batch["pano_latents"], noise_pano, acp, t)
        pers_in = torch.cat([x_p, pers["pers_mask"], pers["pers_masked"]], dim=-1)
        pano_in = torch.cat([x_a, batch["pano_mask"], batch["pano_masked"]], dim=-1)
        # with grad: the resampler, the TemporalProjection and the
        # relative-position adapter are trained
        ip_pers, ip_pano = model.compute_ip_tokens(
            shard_views(batch["ref_feats_pers"], 0).to(dt), batch["ref_feats_pano"].to(dt),
            batch["rel_pos"], batch["pitch"])
        if ip_noise is None:
            def draw_ip(tok, rows):     # at the size of all views' tokens
                return None if tok is None else draw(
                    generator, None, "the IP-token noise", lambda g: torch.randn(
                        (rows,) + tuple(tok.shape[1:]), generator=g, device=tok.device,
                        dtype=torch.float32))

            ip_noise = (draw_ip(ip_pers, batch["ref_feats_pers"].shape[0]),
                        draw_ip(ip_pano, batch["ref_feats_pano"].shape[0]))
        pred_p, pred_a = model(pers_in, pano_in, t.float(),
                               shard_views(batch["pers_text"], 0).to(dt),
                               batch["pano_text"].to(dt), batch["fps"], warp_geoms, use_opp,
                               ip_pers, ip_pano,
                               None if ip_noise[0] is None else shard_views(ip_noise[0], 0),
                               ip_noise[1])
        return (((pred_p.float() - v_p) ** 2).sum() / noise_pers.numel()
                + torch.mean((pred_a.float() - v_a) ** 2) / world)

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator] = None, *,
                   t=None, noise_pers=None, noise_pano=None, use_opp=None, ip_noise=None):
        if state.params.keys() != named.keys():
            raise ValueError("train_step: the state was not created from this model")
        dev = batch["pers_latents"].device
        t = draw(generator, t, "the timestep", lambda g: torch.randint(
            0, NUM_TRAIN_TIMESTEPS, (1,), generator=g, device=dev))
        noise_pers = draw(generator, noise_pers, "the perspective noise", lambda g: torch.randn(
            batch["pers_latents"].shape, generator=g, device=dev))
        noise_pano = draw(generator, noise_pano, "the panorama noise", lambda g: torch.randn(
            batch["pano_latents"].shape, generator=g, device=dev))
        if use_opp is None and cfg.antipodal_prob <= 0:
            use_opp = [False] * n_sites
        use_opp = [bool(x) for x in draw(
            generator, use_opp, "the antipodal choice",
            lambda g: (torch.rand(n_sites, generator=g, device=dev)
                       < cfg.antipodal_prob).tolist())]

        model.zero_grad(set_to_none=True)
        with record_function("i360::train_forward"):
            loss = loss_fn(batch, generator, t.to(dev), noise_pers, noise_pano, use_opp,
                           ip_noise)
        with record_function("i360::train_backward"):
            loss.backward()
        grads = {n: p.grad for n, p in named.items()}
        missing = [n for n, g in grads.items() if g is None]
        if missing:
            raise RuntimeError(f"train_step: no gradient reached {missing[:5]} "
                               f"({len(missing)} parameters)")
        all_reduce_grads(grads.values())
        metrics = {"loss": reduce_sum(loss.detach().float()),
                   "grad_norm": global_norm(list(grads.values()))}
        with record_function("i360::train_optimizer"):
            moved = optimizer.update(grads, state.opt_state, state.params)
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            if moved:
                for n, p in named.items():   # lower-precision modules follow their masters
                    if p.data_ptr() != state.params[n].data_ptr():
                        p.copy_(state.params[n])
            if state.ema_params is not None:
                d = cfg.ema_decay
                for n, e in state.ema_params.items():
                    e.mul_(d).add_(state.params[n], alpha=1.0 - d)
        return (TrainState(state.params, state.opt_state, state.step + 1, state.ema_params),
                metrics)

    return train_step, optimizer
