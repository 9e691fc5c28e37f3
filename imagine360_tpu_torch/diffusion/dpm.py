"""DPM-Solver++ (2M, deterministic and SDE) over the DDIM module's schedule
family (counterpart of imagine360_tpu/diffusion/dpm.py): the multistep
update in data-prediction form. The schedule and the per-step scalars are
host numpy, float64 up to `step_coeffs`, float32 from there on, as in the
JAX package; `dpmpp_2m_step` works on torch tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ddim import make_ddim_schedule


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    timesteps: np.ndarray       # [S]
    alpha: np.ndarray           # [S+1] sqrt(alpha_bar), the final target appended
    sigma: np.ndarray           # [S+1] sqrt(1 - alpha_bar)
    prediction_type: str

    def step_coeffs(self) -> dict:
        lam = np.log(np.clip(self.alpha, 1e-20, None)) - np.log(np.clip(self.sigma, 1e-20, None))
        return {
            "timestep": self.timesteps.astype(np.int32),
            "alpha": self.alpha.astype(np.float32),
            "sigma": self.sigma.astype(np.float32),
            "lam": lam.astype(np.float32),
        }


def make_dpm_schedule(num_inference_steps: int,
                      prediction_type: str = "v_prediction") -> DPMSchedule:
    base = make_ddim_schedule(num_inference_steps)
    acp = base.alphas_cumprod[base.timesteps]
    # the final step targets alpha_bar = 1 (a clean sample); float64 from
    # here, so the last sigma is about 1e-6 and not 0
    acp = np.concatenate([acp, [1.0 - 1e-12]])
    return DPMSchedule(timesteps=base.timesteps, alpha=np.sqrt(acp), sigma=np.sqrt(1.0 - acp),
                       prediction_type=prediction_type)


def _to_x0(x, model_out, alpha, sigma, prediction_type):
    if prediction_type == "epsilon":
        return (x - sigma * model_out) / alpha
    if prediction_type == "v_prediction":
        return alpha * x - sigma * model_out
    if prediction_type == "sample":
        return model_out
    raise ValueError(prediction_type)


def dpmpp_2m_step(x: torch.Tensor, model_out: torch.Tensor, i: int, coeffs: dict,
                  x0_prev: torch.Tensor, prediction_type: str,
                  sde_noise: torch.Tensor | None = None):
    """One DPM++ 2M update at step `i` of `coeffs` (arrays of length S, + 1
    for the target values). Returns (x_next in x.dtype, x0 in float32).
    Step 0 is first order (`x0_prev` is not read); later steps correct with
    the previous step's x0. With `sde_noise` (unit variance, shaped like x)
    the SDE variant (eta = 1) runs. The scalars are float32, the update
    float32."""
    f32 = np.float32
    a_t, s_t = coeffs["alpha"][i], coeffs["sigma"][i]
    a_s, s_s = coeffs["alpha"][i + 1], coeffs["sigma"][i + 1]
    lam_t, lam_s = coeffs["lam"][i], coeffs["lam"][i + 1]
    h = f32(lam_s - lam_t)

    xf = x.float()
    x0 = _to_x0(xf, model_out.float(), float(a_t), float(s_t), prediction_type)
    if i > 0:
        r = f32(lam_t - coeffs["lam"][i - 1]) / (f32(1.0) if h == 0 else h)
        w = f32(1) / (f32(2) * r)
        d = float(f32(1) + w) * x0 - float(w) * x0_prev.float()
    else:
        d = x0
    decay = f32(s_s / s_t)
    gain = f32(a_s * (f32(1) - np.exp(-h)))
    if sde_noise is None:
        x_next = float(decay) * xf + float(gain) * d
    else:
        # SDE variant: extra noise with matched marginals
        e2h = np.exp(f32(-2.0) * h)
        x_next = (float(f32(decay * np.sqrt(e2h))) * xf + float(gain) * d
                  + float(f32(s_s * np.sqrt(f32(1) - e2h))) * sde_noise.float())
    return x_next.to(x.dtype), x0
