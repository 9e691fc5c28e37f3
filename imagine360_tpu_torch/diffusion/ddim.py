"""DDIM sampling over a precomputed schedule (counterpart of
imagine360_tpu/diffusion/ddim.py). `make_ddim_schedule` takes the options of
diffusers' DDIMScheduler; its defaults are the reference config the product
runs: linear betas 0.00085 -> 0.012, 1000 train steps, v-prediction,
zero-terminal-SNR rescale, steps_offset=1, final alpha 1, clip_sample=False,
eta=0. The schedule is host numpy; `ddim_step` and `ddim_inverse_step` work
on torch tensors.
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
    final_alpha_cumprod: float = 1.0
    num_train_timesteps: int = NUM_TRAIN_TIMESTEPS
    prediction_type: str = "v_prediction"
    clip_sample: bool = False

    def step_coeffs(self) -> dict:
        """Per-inference-step coefficient arrays [S]; the final step's
        "previous" alpha is `final_alpha_cumprod`."""
        t = self.timesteps
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        a_t = self.alphas_cumprod[t]
        a_prev = np.where(prev_t >= 0, self.alphas_cumprod[np.clip(prev_t, 0, None)],
                          self.final_alpha_cumprod).astype(np.float32)
        return {
            "timestep": t.astype(np.int32),
            "alpha_prod_t": a_t.astype(np.float32),
            "alpha_prod_t_prev": a_prev,
        }


def make_ddim_schedule(num_inference_steps: int,
                       num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
                       beta_start: float = BETA_START,
                       beta_end: float = BETA_END,
                       beta_schedule: str = "linear",
                       steps_offset: int = STEPS_OFFSET,
                       prediction_type: str = "v_prediction",
                       rescale_betas_zero_snr: bool = True,
                       set_alpha_to_one: bool = True,
                       clip_sample: bool = False) -> DDIMSchedule:
    """The schedule of diffusers' DDIMScheduler with these options; the
    defaults are the product's."""
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    else:
        raise ValueError(f"unsupported beta_schedule {beta_schedule!r}")
    if rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas)
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()
    timesteps = timesteps[::-1].astype(np.int64) + steps_offset
    return DDIMSchedule(timesteps=timesteps.astype(np.int32),
                        alphas_cumprod=alphas_cumprod.astype(np.float32),
                        num_inference_steps=num_inference_steps,
                        final_alpha_cumprod=1.0 if set_alpha_to_one
                        else float(alphas_cumprod[0]),
                        num_train_timesteps=num_train_timesteps,
                        prediction_type=prediction_type, clip_sample=clip_sample)


PREDICTION_TYPES = ("v_prediction", "epsilon", "sample")


def ddim_step(model_output: torch.Tensor, sample: torch.Tensor,
              alpha_prod_t: float, alpha_prod_t_prev: float,
              prediction_type: str = "v_prediction",
              clip_sample: bool = False) -> torch.Tensor:
    """One deterministic (eta=0) DDIM update x_t -> x_{t-1} in float32,
    returned in sample.dtype (diffusers DDIMScheduler.step formulas (12) and
    (16)); `prediction_type` says what the model predicts, `clip_sample`
    clips the predicted x_0 to [-1, 1]."""
    a_t = torch.tensor(alpha_prod_t, dtype=torch.float32, device=sample.device)
    a_prev = torch.tensor(alpha_prod_t_prev, dtype=torch.float32, device=sample.device)
    b_t = 1.0 - a_t
    x = sample.float()
    out = model_output.float()
    if prediction_type == "epsilon":
        pred_x0 = (x - torch.sqrt(b_t) * out) / torch.sqrt(a_t)
        pred_eps = out
    elif prediction_type == "v_prediction":
        pred_x0 = torch.sqrt(a_t) * x - torch.sqrt(b_t) * out
        pred_eps = torch.sqrt(a_t) * out + torch.sqrt(b_t) * x
    elif prediction_type == "sample":
        pred_x0 = out
        pred_eps = (x - torch.sqrt(a_t) * pred_x0) / torch.sqrt(b_t)
    else:
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    if clip_sample:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)
    prev = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * pred_eps
    return prev.to(sample.dtype)


def ddim_inverse_step(model_output: torch.Tensor, sample: torch.Tensor,
                      alpha_prod_t: float, alpha_prod_t_next: float,
                      prediction_type: str = "v_prediction") -> torch.Tensor:
    """Deterministic DDIM inversion x_t -> x_{t+1}: the DDIM update toward
    the next (noisier) alpha."""
    return ddim_step(model_output, sample, alpha_prod_t, alpha_prod_t_next,
                     prediction_type=prediction_type)


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
