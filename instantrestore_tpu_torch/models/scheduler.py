"""DDPM math for the SD-Turbo restoration pass (counterpart of
``instantrestore_tpu/models/scheduler.py``): the sd-turbo schedule (1000
steps, scaled_linear betas in [0.00085, 0.012], epsilon prediction),
forward diffusion, the closed-form x0 estimate and the DDIM step of the
multi-step restore."""

from __future__ import annotations

import numpy as np
import torch

from instantrestore_tpu_torch import device_constant


def make_alphas_cumprod(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    device=None,
) -> torch.Tensor:
    """Cumulative alpha-bar table [T] in fp32 (computed in float64), made
    once per device (``device_constant``)."""
    def make():
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
        return np.cumprod(1.0 - betas).astype(np.float32)

    return device_constant(("alphas_cumprod", num_train_timesteps, beta_start, beta_end),
                           device or "cpu", make)


def _per_sample(abar_t: torch.Tensor, ndim: int) -> torch.Tensor:
    return abar_t.reshape(abar_t.shape[0], *([1] * (ndim - 1)))


def add_noise(alphas_cumprod, sample, noise, timesteps) -> torch.Tensor:
    """x_t = sqrt(abar_t) * x0 + sqrt(1 - abar_t) * noise; ``timesteps`` [B]."""
    abar = _per_sample(alphas_cumprod[timesteps].to(sample.dtype), sample.ndim)
    return torch.sqrt(abar) * sample + torch.sqrt(1.0 - abar) * noise


def pred_original_sample(alphas_cumprod, model_output, sample, timesteps) -> torch.Tensor:
    """x0 = (x_t - sqrt(1 - abar_t) * eps) / sqrt(abar_t), in fp32, cast back
    to the sample dtype."""
    abar = _per_sample(alphas_cumprod[timesteps].float(), sample.ndim)
    x0 = (sample.float() - torch.sqrt(1.0 - abar) * model_output.float()) / torch.sqrt(abar)
    return x0.to(sample.dtype)


def ddim_step(alphas_cumprod, model_output, sample, timestep, prev_timestep) -> torch.Tensor:
    """Deterministic DDIM update x_t -> x_t' (eta = 0) for epsilon
    prediction; ``timestep``/``prev_timestep`` [B], prev < 0 means to x0.
    fp32 inside, cast back to the sample dtype."""
    x0 = pred_original_sample(alphas_cumprod, model_output, sample, timestep)
    prev = torch.as_tensor(prev_timestep, device=alphas_cumprod.device)
    abar_prev = torch.where(prev >= 0, alphas_cumprod[prev.clamp(min=0)],
                            torch.ones((), device=alphas_cumprod.device)).float()
    abar_prev = _per_sample(abar_prev, sample.ndim)
    out = torch.sqrt(abar_prev) * x0.float() + torch.sqrt(1.0 - abar_prev) * model_output.float()
    return out.to(sample.dtype)
