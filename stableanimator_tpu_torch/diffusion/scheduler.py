"""EDM / Euler-discrete diffusion schedule (port of the JAX package's
`diffusion/scheduler.py`).

SVD's EulerDiscreteScheduler semantics: Karras rho-7 sigmas over
[0.002, 700], continuous timestep t = 0.25 * ln(sigma), init noise sigma
sqrt(sigma_max^2 + 1), model-input scaling x / sqrt(sigma^2 + 1), and the
v-prediction Euler step. The tables are computed on the host exactly as
the JAX package computes them; every step is fp32 tensor math. Training
adds the lognormal sigma draw and the EDM loss weight.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stableanimator_tpu_torch.core.config import SchedulerConfig


class EulerEDMSchedule(NamedTuple):
    """sigmas has num_steps + 1 entries, the last 0.0."""

    sigmas: torch.Tensor      # [num_steps + 1] float32
    timesteps: torch.Tensor   # [num_steps]     float32, 0.25*ln(sigma)
    init_noise_sigma: float


def karras_sigmas(num_steps: int, cfg: SchedulerConfig) -> np.ndarray:
    """Karras et al. (2022) rho-spaced sigma grid, sigma_max -> sigma_min."""
    ramp = np.linspace(0.0, 1.0, num_steps, dtype=np.float64)
    min_inv_rho = cfg.sigma_min ** (1.0 / cfg.rho)
    max_inv_rho = cfg.sigma_max ** (1.0 / cfg.rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** cfg.rho
    return sigmas.astype(np.float32)


def make_schedule(num_steps: int, cfg: SchedulerConfig | None = None,
                  device: torch.device | str = "cpu") -> EulerEDMSchedule:
    cfg = cfg or SchedulerConfig()
    sigmas = karras_sigmas(num_steps, cfg)
    timesteps = 0.25 * np.log(sigmas)
    sigmas = np.concatenate([sigmas, np.zeros((1,), dtype=np.float32)])
    return EulerEDMSchedule(
        sigmas=torch.tensor(sigmas, dtype=torch.float32, device=device),
        timesteps=torch.tensor(timesteps, dtype=torch.float32, device=device),
        init_noise_sigma=float(np.sqrt(cfg.sigma_max**2 + 1.0)),
    )


def scale_model_input(sample: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """EDM c_in scaling: x / sqrt(sigma^2 + 1) (sigma_data = 1)."""
    return sample / torch.sqrt(sigma.float() ** 2 + 1.0).to(sample.dtype)


def pred_original_sample(model_output, sample, sigma):
    """x0_hat from a v-prediction model output (fp32 math)."""
    sigma = sigma.float()
    return (model_output.float() * (-sigma / torch.sqrt(sigma**2 + 1.0))
            + sample.float() / (sigma**2 + 1.0))


def step_euler(model_output, sample, sigma, sigma_next):
    """One Euler step x_t -> x_{t-1}; returns the dtype of `sample`."""
    x0 = pred_original_sample(model_output, sample, sigma)
    return step_euler_from_x0(x0, sample, sigma, sigma_next)


def step_euler_from_x0(x0, sample, sigma, sigma_next):
    """The Euler step expressed via the predicted clean sample (the HJB
    face-optimisation path edits x0_hat before integrating); fp32 math,
    returned in the dtype of `sample`."""
    s = sample.float()
    derivative = (s - x0.float()) / sigma
    return (s + derivative * (sigma_next - sigma)).to(sample.dtype)


def timestep_of_sigma(sigma: torch.Tensor) -> torch.Tensor:
    """Continuous timestep fed to the UNet: c_noise = 0.25 * ln(sigma)."""
    return 0.25 * torch.log(sigma)


# ---------------------------------------------------------------------------
# Training-side EDM math (the SVD/EDM formulation the reference's training
# flags imply)
# ---------------------------------------------------------------------------

def sample_sigmas_lognormal(shape, cfg: SchedulerConfig | None = None, *,
                            z: torch.Tensor | None = None,
                            generator: torch.Generator | None = None,
                            device: torch.device | str = "cpu") -> torch.Tensor:
    """sigma ~ exp(N(p_mean, p_std)) as in EDM/SVD finetuning. `z` is the
    standard-normal draw of `shape`; without it one is drawn from
    `generator` on `device`."""
    cfg = cfg or SchedulerConfig()
    if z is None:
        z = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return torch.exp(cfg.p_mean + cfg.p_std * z.float())


def edm_loss_weight(sigma: torch.Tensor) -> torch.Tensor:
    """lambda(sigma) = (1 + sigma^2) / sigma^2 (EDM, sigma_data = 1) for a
    loss expressed on x0_hat."""
    sigma = sigma.float()
    return (1.0 + sigma**2) / sigma**2
