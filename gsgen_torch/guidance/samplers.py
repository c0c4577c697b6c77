"""Sampling schedulers: DDIM, PNDM (PLMS) and DDPM-ancestral loops.

Port of the JAX package's ``guidance/samplers.py``: the ``guidance.scheduler``
block (``SamplerConfig``, ``resolve_scheduler``) and the sampling loops
behind the guidance's ``sample`` (the trainer's guidance-eval image), as
plain Python loops over ``num_steps`` around an ``eps_fn(x [B, h, w, c]
NHWC, t int) -> eps`` callback:

* timesteps are diffusers' "leading" spacing with SD's ``steps_offset``
  (:func:`leading_timesteps`); a previous timestep below 0 reads
  ``alphas_cumprod[0]`` (SD's ``set_alpha_to_one=False``);
* DDIM (eta 0 deterministic, eta > 0 adds ``sigma z``), PLMS with the
  midpoint warm-up, then Adams-Bashforth of order 2, 3 and 4 as the eps
  history fills, and DDPM ancestral steps whose last step returns the
  clipped ``x0``;
* :func:`cfg_sample` combines the [2B] cond / uncond stack as
  ``e_u + s (e_c - e_u)`` (not the SDS loss's ``e_c + s (e_c - e_u)``).

Random draws come from the caller's ``torch.Generator``; tests hand in the
initial ``x`` and a ``[num_steps, *x.shape]`` stack of per-step ``noise``
instead (step ``i`` reads ``noise[i]``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .diffusion import NoiseSchedule, scaled_linear_schedule


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """guidance.scheduler block (conf/guidance/sd_pndm.yaml shape)."""

    type: str = "ddim"            # ddim | pndm | ancestral
    num_steps: int = 25
    eta: float = 0.0              # DDIM stochasticity (0 = deterministic)
    steps_offset: int = 1         # diffusers SD schedulers' offset


def leading_timesteps(T: int, num_steps: int, steps_offset: int = 1
                      ) -> torch.Tensor:
    """diffusers' "leading" spacing: arange(n) * (T // n) descending, plus
    the SD ``steps_offset``, clipped to [0, T - 1] (int64, CPU)."""
    ratio = T // num_steps
    ts = (torch.arange(num_steps, dtype=torch.int64) * ratio).flip(0)
    return torch.clamp(ts + steps_offset, 0, T - 1)


def _draw(noise, i, generator, like):
    """The step's normal draw: ``noise[i]`` when given, else from
    ``generator``."""
    if noise is not None:
        return noise[i].to(like.device, like.dtype)
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def _steps(schedule: NoiseSchedule, x, num_steps: int, steps_offset: int):
    """(alphas_cumprod on x's device, [(i, t, prev_t)] of the loop)."""
    T = schedule.num_train_timesteps
    ratio = T // num_steps
    ts = leading_timesteps(T, num_steps, steps_offset).tolist()
    return (schedule.alphas_cumprod.to(x.device),
            [(i, t, t - ratio) for i, t in enumerate(ts)])


@torch.no_grad()
def ddim_sample(eps_fn: Callable, schedule: NoiseSchedule, x: torch.Tensor,
                num_steps: int, generator: Optional[torch.Generator] = None,
                eta: float = 0.0, steps_offset: int = 1,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM (Song et al. 2020 eq. 12; diffusers DDIMScheduler.step):
    x_prev = sqrt(ac_prev) x0 + sqrt(1 - ac_prev - s^2) eps + s z, with
    x0 = (x - sqrt(1 - ac_t) eps) / sqrt(ac_t) and
    s = eta sqrt((1 - ac_prev) / (1 - ac_t)) sqrt(1 - ac_t / ac_prev)."""
    ac_all, steps = _steps(schedule, x, num_steps, steps_offset)
    for i, t, prev_t in steps:
        eps = eps_fn(x, t)
        ac_t = ac_all[t]
        ac_prev = ac_all[max(prev_t, 0)]
        x0 = (x - torch.sqrt(1.0 - ac_t) * eps) / torch.sqrt(ac_t)
        var = ((1.0 - ac_prev) / (1.0 - ac_t)) * (1.0 - ac_t / ac_prev)
        sigma = eta * torch.sqrt(var)
        dir_xt = torch.sqrt(torch.clamp(1.0 - ac_prev - sigma ** 2,
                                        min=0.0)) * eps
        x_prev = torch.sqrt(ac_prev) * x0 + dir_xt
        if eta > 0.0:
            x_prev = x_prev + sigma * _draw(noise, i, generator, x)
        x = x_prev
    return x


def _pndm_prev_sample(x, eps, ac_t, ac_prev):
    """PNDM transfer formula (Liu et al. 2022 eq. 11; diffusers
    PNDMScheduler._get_prev_sample)."""
    num = (ac_prev - ac_t) * eps
    den = torch.sqrt(ac_t) * (torch.sqrt((1.0 - ac_prev) * ac_t)
                              + torch.sqrt((1.0 - ac_t) * ac_prev))
    return torch.sqrt(ac_prev / ac_t) * x - num / den


@torch.no_grad()
def pndm_sample(eps_fn: Callable, schedule: NoiseSchedule, x: torch.Tensor,
                num_steps: int, steps_offset: int = 1) -> torch.Tensor:
    """PLMS (PNDM with skip_prk_steps=True, the SD pipeline default).

    The first step runs the midpoint warm-up: a transfer step with eps(x,
    t), eps evaluated again there at max(prev_t, 0), and the mean of the
    two applied from the original x (``num_steps + 1`` calls of eps_fn in
    all).  Later steps combine the eps history by Adams-Bashforth, of
    order 2, then 3, then 4 (55 e - 59 e1 + 37 e2 - 9 e3) / 24."""
    ac_all, steps = _steps(schedule, x, num_steps, steps_offset)
    hist = []                                  # newest first, at most 3
    for _, t, prev_t in steps:
        ac_t, ac_prev = ac_all[t], ac_all[max(prev_t, 0)]
        eps = eps_fn(x, t)
        if not hist:
            x_half = _pndm_prev_sample(x, eps, ac_t, ac_prev)
            e_prime = (eps + eps_fn(x_half, max(prev_t, 0))) / 2.0
        elif len(hist) >= 3:
            e0, e1, e2 = hist
            e_prime = (55.0 * eps - 59.0 * e0 + 37.0 * e1 - 9.0 * e2) / 24.0
        elif len(hist) == 2:
            e0, e1 = hist
            e_prime = (23.0 * eps - 16.0 * e0 + 5.0 * e1) / 12.0
        else:
            e_prime = (3.0 * eps - hist[0]) / 2.0
        x = _pndm_prev_sample(x, e_prime, ac_t, ac_prev)
        hist = [eps] + hist[:2]
    return x


@torch.no_grad()
def ancestral_sample(eps_fn: Callable, schedule: NoiseSchedule,
                     x: torch.Tensor, num_steps: int,
                     generator: Optional[torch.Generator] = None,
                     steps_offset: int = 1,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDPM ancestral sampling (Ho et al. 2020 alg. 2) on the leading-spaced
    timesteps: the posterior mean from the clipped x0 and x, plus the
    posterior variance beta_t (1 - ac_prev) / (1 - ac_t) times a draw; a
    step with prev_t < 0 returns the clipped x0 itself."""
    ac_all, steps = _steps(schedule, x, num_steps, steps_offset)
    for i, t, prev_t in steps:
        eps = eps_fn(x, t)
        ac_t = ac_all[t]
        ac_prev = ac_all[max(prev_t, 0)]
        alpha_t = ac_t / ac_prev
        x0 = (x - torch.sqrt(1.0 - ac_t) * eps) / torch.sqrt(ac_t)
        x0 = torch.clamp(x0, -10.0, 10.0)
        if prev_t < 0:
            x = x0
            continue
        coef0 = torch.sqrt(ac_prev) * (1.0 - alpha_t) / (1.0 - ac_t)
        coefx = torch.sqrt(alpha_t) * (1.0 - ac_prev) / (1.0 - ac_t)
        mean = coef0 * x0 + coefx * x
        var = (1.0 - alpha_t) * (1.0 - ac_prev) / (1.0 - ac_t)
        x = mean + torch.sqrt(torch.clamp(var, min=1e-20)) * _draw(
            noise, i, generator, x)
    return x


def resolve_scheduler(sched_d: Optional[dict],
                      default_schedule: Optional[NoiseSchedule] = None):
    """guidance.scheduler config block -> (NoiseSchedule, SamplerConfig).

    The block carries the training schedule's beta parameters
    (beta_start/end/schedule, num_train_timesteps) and the sampling loop's
    type; missing keys fall back to SD's scaled_linear defaults.
    """
    d = dict(sched_d or {})
    if any(k in d for k in ("beta_start", "beta_end", "num_train_timesteps",
                            "beta_schedule")) or default_schedule is None:
        kind = d.get("beta_schedule", "scaled_linear")
        if kind != "scaled_linear":
            raise ValueError(f"beta_schedule {kind!r}: only the SD "
                             "scaled_linear schedule is wired")
        schedule = scaled_linear_schedule(
            int(d.get("num_train_timesteps", 1000)),
            float(d.get("beta_start", 0.00085)),
            float(d.get("beta_end", 0.012)))
    else:
        schedule = default_schedule
    scfg = SamplerConfig(type=d.get("type", "ddim"),
                         num_steps=int(d.get("num_steps", 25)),
                         eta=float(d.get("eta", 0.0)),
                         steps_offset=int(d.get("steps_offset", 1)))
    return schedule, scfg


@torch.no_grad()
def cfg_sample(cfg: SamplerConfig, schedule: NoiseSchedule, shape,
               guidance_scale: float, cond_uncond_eps: Callable,
               generator: Optional[torch.Generator] = None, device="cuda",
               x: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CFG sampling from pure noise ``x`` (drawn with ``shape`` on
    ``device`` unless given): ``cond_uncond_eps(lat2, t2)`` returns the
    [2B] cond / uncond eps stack (cond first), combined each step as
    ``e_u + s (e_c - e_u)``; a net that gives 2C channels (eps, variance)
    has its variance half split off first."""
    if x is None:
        x = torch.randn(shape, generator=generator, device=device)
    B, C = x.shape[0], x.shape[-1]

    def eps_fn_cfg(x, t):
        t2 = torch.full((2 * B,), t, dtype=torch.int64, device=x.device)
        eps2 = cond_uncond_eps(torch.cat([x, x]), t2)
        if eps2.shape[-1] == 2 * C:
            eps2 = eps2[..., :C]
        e_c, e_u = eps2[:B], eps2[B:]
        return e_u + guidance_scale * (e_c - e_u)

    return sample(cfg, eps_fn_cfg, schedule, x, generator=generator,
                  noise=noise)


def backbone_sample(bb, sched_d: Optional[dict], schedule: NoiseSchedule,
                    B: int, guidance_scale: float, cond_uncond_eps: Callable,
                    num_steps: int, generator: Optional[torch.Generator],
                    device, x: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1]: :func:`cfg_sample` of B latents of the
    backbone ``bb`` through the scheduler block ``sched_d`` (over the
    guidance's ``schedule``) cut to ``num_steps``, then the backbone's
    decode (the VAE, or the clip of pixel space)."""
    schedule, scfg = resolve_scheduler(sched_d, schedule)
    scfg = dataclasses.replace(scfg, num_steps=num_steps)
    shape = (B, bb.latent_size, bb.latent_size, bb.latent_channels)
    x = cfg_sample(scfg, schedule, shape, guidance_scale, cond_uncond_eps,
                   generator=generator, device=device, x=x, noise=noise)
    return bb.decode_latents(x)


def sample(cfg: SamplerConfig, eps_fn: Callable, schedule: NoiseSchedule,
           x: torch.Tensor, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on cfg.type (the guidance.scheduler config block)."""
    if cfg.type == "ddim":
        return ddim_sample(eps_fn, schedule, x, cfg.num_steps, generator,
                           eta=cfg.eta, steps_offset=cfg.steps_offset,
                           noise=noise)
    if cfg.type in ("pndm", "plms"):
        return pndm_sample(eps_fn, schedule, x, cfg.num_steps,
                           steps_offset=cfg.steps_offset)
    if cfg.type in ("ancestral", "ddpm"):
        if generator is None and noise is None:
            raise ValueError("ancestral sampling needs a generator or noise")
        return ancestral_sample(eps_fn, schedule, x, cfg.num_steps,
                                generator, steps_offset=cfg.steps_offset,
                                noise=noise)
    raise NotImplementedError(f"scheduler type {cfg.type}")
