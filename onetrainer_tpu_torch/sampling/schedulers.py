"""Inference noise schedulers (DDIM, Euler, Euler-Ancestral, DPM++ 2M,
UniPC-lite) over a betas table, on torch tensors.

Counterpart of onetrainer_tpu/sampling/schedulers.py. Karras sigma spacing
where the enum has *_KARRAS variants. Steppers take and return fp32
latents; the stochastic ones draw from a caller-held `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from onetrainer_tpu_torch.util.enums import NoiseScheduler


@dataclass
class SchedulerState:
    kind: NoiseScheduler
    timesteps: np.ndarray          # int32 [steps], descending
    alphas_cumprod: torch.Tensor   # [T] fp32
    sigmas: np.ndarray | None = None  # [steps+1] for sigma-space schedulers
    prediction_type: str = "epsilon"

    @property
    def init_noise_sigma(self) -> float:
        if self.sigmas is not None:
            return float(self.sigmas[0])
        return 1.0


def _karras_sigmas(sigma_min: float, sigma_max: float, steps: int, rho: float = 7.0):
    ramp = np.linspace(0, 1, steps)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    return (max_inv + ramp * (min_inv - max_inv)) ** rho


def create_scheduler(
        kind: NoiseScheduler,
        betas: torch.Tensor,
        num_inference_steps: int,
        prediction_type: str = "epsilon",
        force_last_timestep: bool = False,
) -> SchedulerState:
    alphas_cumprod = torch.cumprod(1.0 - betas.float(), dim=0)
    T = betas.shape[0]

    if force_last_timestep:
        # trailing spacing so sampling starts at t=T-1 (ZTSNR models)
        timesteps = np.round(
            np.arange(T, 0, -T / num_inference_steps)).astype(np.int64) - 1
    else:
        step_ratio = T // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
    timesteps = timesteps.astype(np.int32)

    sigmas = None
    if kind not in (NoiseScheduler.DDIM,):
        ac = alphas_cumprod.cpu().numpy()
        all_sigmas = np.sqrt((1 - ac) / ac)
        sig = all_sigmas[timesteps]
        if kind.is_karras():
            sig = _karras_sigmas(all_sigmas.min(), all_sigmas.max(),
                                 num_inference_steps)
            # map karras sigmas back to nearest timesteps
            timesteps = np.abs(
                all_sigmas[None, :] - sig[:, None]).argmin(axis=1).astype(np.int32)
        sigmas = np.concatenate([sig, [0.0]]).astype(np.float32)

    return SchedulerState(
        kind=kind, timesteps=timesteps, alphas_cumprod=alphas_cumprod,
        sigmas=sigmas, prediction_type=prediction_type)


def scale_model_input(state: SchedulerState, sample: torch.Tensor,
                      step_index: int) -> torch.Tensor:
    if state.sigmas is None:
        return sample
    sigma = float(state.sigmas[step_index])
    return sample / float(np.sqrt(sigma ** 2 + 1))


def _predicted_x0(state: SchedulerState, model_output, sample, t: int,
                  sigma: float | None = None):
    if state.sigmas is not None:
        # sigma-space (x = x0 + sigma * eps scaled form)
        if state.prediction_type == "v_prediction":
            return model_output * float(-sigma / np.sqrt(sigma ** 2 + 1)) \
                + sample / float(sigma ** 2 + 1)
        return sample - sigma * model_output
    ac = state.alphas_cumprod[t].to(sample.device)
    sac, somac = torch.sqrt(ac), torch.sqrt(1 - ac)
    if state.prediction_type == "v_prediction":
        return sac * sample - somac * model_output
    return (sample - somac * model_output) / sac


def _randn_like(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def step(state: SchedulerState, model_output: torch.Tensor,
         step_index: int, sample: torch.Tensor,
         generator: torch.Generator | None = None,
         history: dict | None = None) -> torch.Tensor:
    """One denoising step. `sample` is the current latent; for sigma-space
    schedulers it carries sigma-scaled noise (x = x0 + sigma*eps).
    `history` (a caller-held dict) enables the second-order multistep for
    DPM++/UniPC; without it they fall back to first order."""
    kind = state.kind

    if kind == NoiseScheduler.DDIM:
        t = int(state.timesteps[step_index])
        prev_t = int(state.timesteps[step_index + 1]) \
            if step_index + 1 < len(state.timesteps) else -1
        x0 = _predicted_x0(state, model_output, sample, t)
        ac = state.alphas_cumprod[t].to(sample.device)
        eps = (sample - torch.sqrt(ac) * x0) / torch.sqrt(1 - ac)
        ac_prev = state.alphas_cumprod[prev_t].to(sample.device) if prev_t >= 0 \
            else torch.tensor(1.0, device=sample.device)
        return torch.sqrt(ac_prev) * x0 + torch.sqrt(1 - ac_prev) * eps

    sigma = float(state.sigmas[step_index])
    sigma_next = float(state.sigmas[step_index + 1])
    x0 = _predicted_x0(state, model_output, sample,
                       int(state.timesteps[step_index]), sigma)

    if kind in (NoiseScheduler.EULER, NoiseScheduler.EULER_KARRAS):
        d = (sample - x0) / sigma
        return sample + d * (sigma_next - sigma)

    if kind == NoiseScheduler.EULER_A:
        sigma_up = min(sigma_next,
                       (sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2)
                        / sigma ** 2) ** 0.5) if sigma_next > 0 else 0.0
        sigma_down = (sigma_next ** 2 - sigma_up ** 2) ** 0.5 if sigma_next > 0 else 0.0
        d = (sample - x0) / sigma
        out = sample + d * (sigma_down - sigma)
        if sigma_up > 0 and generator is not None:
            out = out + sigma_up * _randn_like(out, generator)
        return out

    if kind in (NoiseScheduler.DPMPP, NoiseScheduler.DPMPP_KARRAS,
                NoiseScheduler.UNIPC, NoiseScheduler.UNIPC_KARRAS,
                NoiseScheduler.DPMPP_SDE, NoiseScheduler.DPMPP_SDE_KARRAS):
        # DPM-Solver++(2M) multistep: 2nd order when the previous denoised
        # estimate is available via `history`; SDE variants add noise.
        t_fn = lambda s: -np.log(max(s, 1e-10))
        if sigma_next == 0:
            if history is not None:
                history["x0"] = x0
                history["sigma"] = sigma
            return x0
        h = float(t_fn(sigma_next) - t_fn(sigma))
        d = x0
        if history is not None and "x0" in history:
            h_last = float(t_fn(sigma) - t_fn(history["sigma"]))
            if h_last > 0:
                r = h_last / h
                d = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * history["x0"]
        if kind in (NoiseScheduler.DPMPP_SDE, NoiseScheduler.DPMPP_SDE_KARRAS):
            # sde-dpmsolver++ update: the sample term decays by exp(-h) and
            # the denoised term carries (1 - exp(-2h))
            out = (sigma_next / sigma) * float(np.exp(-h)) * sample \
                + float(1.0 - np.exp(-2.0 * h)) * d
            if generator is not None:
                noise_scale = sigma_next * float(np.sqrt(1.0 - np.exp(-2.0 * h)))
                out = out + noise_scale * _randn_like(out, generator)
        else:
            out = (sigma_next / sigma) * sample - float(np.exp(-h) - 1.0) * d
        if history is not None:
            history["x0"] = x0
            history["sigma"] = sigma
        return out

    raise ValueError(f"unsupported scheduler {kind}")
