"""DDIM sampling over a precomputed schedule (counterpart of
imagine360_tpu/diffusion/ddim.py) with the reference scheduler config the
product runs: linear betas 0.00085 -> 0.012, 1000 train steps,
v-prediction, zero-terminal-SNR rescale, steps_offset=1, final alpha 1,
clip_sample=False, eta=0. The schedule is host numpy; `ddim_step` works on
torch tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000
BETA_START, BETA_END = 0.00085, 0.012
STEPS_OFFSET = 1


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero-terminal-SNR rescale, https://arxiv.org/abs/2305.08891 alg. 1
    (reference scheduling_ddim.py:77-110)."""
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    abar_sqrt = np.sqrt(alphas_cumprod)

    abar_sqrt_0 = abar_sqrt[0].copy()
    abar_sqrt_T = abar_sqrt[-1].copy()

    abar_sqrt = abar_sqrt - abar_sqrt_T
    abar_sqrt = abar_sqrt * abar_sqrt_0 / (abar_sqrt_0 - abar_sqrt_T)

    abar = abar_sqrt ** 2
    alphas = np.concatenate([abar[:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Precomputed inference schedule (host numpy; small)."""
    timesteps: np.ndarray          # [S] int32, descending
    alphas_cumprod: np.ndarray     # [T] float32
    num_inference_steps: int

    def step_coeffs(self) -> dict:
        """Per-inference-step coefficient arrays [S]."""
        t = self.timesteps
        prev_t = t - NUM_TRAIN_TIMESTEPS // self.num_inference_steps
        a_t = self.alphas_cumprod[t]
        # the final step's "previous" alpha is 1 (set_alpha_to_one)
        a_prev = np.where(prev_t >= 0, self.alphas_cumprod[np.clip(prev_t, 0, None)],
                          1.0).astype(np.float32)
        return {
            "timestep": t.astype(np.int32),
            "alpha_prod_t": a_t.astype(np.float32),
            "alpha_prod_t_prev": a_prev,
        }


def make_ddim_schedule(num_inference_steps: int) -> DDIMSchedule:
    betas = np.linspace(BETA_START, BETA_END, NUM_TRAIN_TIMESTEPS, dtype=np.float64)
    betas = _rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas)
    step_ratio = NUM_TRAIN_TIMESTEPS // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()
    timesteps = timesteps[::-1].astype(np.int64) + STEPS_OFFSET
    return DDIMSchedule(timesteps=timesteps.astype(np.int32),
                        alphas_cumprod=alphas_cumprod.astype(np.float32),
                        num_inference_steps=num_inference_steps)


def ddim_step(model_output: torch.Tensor, sample: torch.Tensor,
              alpha_prod_t: float, alpha_prod_t_prev: float) -> torch.Tensor:
    """One deterministic (eta=0) DDIM update x_t -> x_{t-1} from a
    v-prediction, in float32, returned in sample.dtype (diffusers
    DDIMScheduler.step formulas (12) and (16))."""
    a_t = torch.tensor(alpha_prod_t, dtype=torch.float32, device=sample.device)
    a_prev = torch.tensor(alpha_prod_t_prev, dtype=torch.float32, device=sample.device)
    b_t = 1.0 - a_t
    x = sample.float()
    v = model_output.float()
    pred_x0 = torch.sqrt(a_t) * x - torch.sqrt(b_t) * v
    pred_eps = torch.sqrt(a_t) * v + torch.sqrt(b_t) * x
    prev = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * pred_eps
    return prev.to(sample.dtype)


def _alpha_at(alphas_cumprod: torch.Tensor, timesteps: torch.Tensor,
              ndim: int) -> torch.Tensor:
    a = alphas_cumprod.to(timesteps.device)[timesteps.long()].float()
    return a.reshape(a.shape + (1,) * (ndim - a.dim()))


def add_noise(sample: torch.Tensor, noise: torch.Tensor, alphas_cumprod: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """Forward-process noising x_t = sqrt(a) x_0 + sqrt(1 - a) eps in float32,
    returned in sample.dtype; `timesteps` is an integer tensor that
    broadcasts against the leading axes of `sample`."""
    a = _alpha_at(alphas_cumprod, timesteps, sample.dim())
    return (torch.sqrt(a) * sample.float() + torch.sqrt(1.0 - a) * noise.float()).to(sample.dtype)


def get_velocity(sample: torch.Tensor, noise: torch.Tensor, alphas_cumprod: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
    """The v-prediction target v = sqrt(a) eps - sqrt(1 - a) x_0."""
    a = _alpha_at(alphas_cumprod, timesteps, sample.dim())
    return (torch.sqrt(a) * noise.float() - torch.sqrt(1.0 - a) * sample.float()).to(sample.dtype)
