"""gsgen's text-to-3D training step, followed from the seed.

:class:`ReferenceRun` starts from the seed as the trainer does: the
``base`` init (means, colours) and every later draw (cameras from numpy,
backgrounds, timesteps and noise from one torch generator on the device)
come in the trainer's order, so that the same seed gives the same draws.
Each step renders the batch densely (:mod:`.render`), encodes it with the
VAE, forms the SDS or VSD gradient on the latents with the UNet, takes
the gradient of the loss with respect to every optimised leaf (the
Gaussian fields and, under VSD, the LoRA and camera-embedding leaves) and
applies Adam with gsgen's per-field learning rates.  Weights and the
prompt's embedding bank are handed in; nothing is read from the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .cameras import Cameras
from .nets import UNet, VAE, set_precision
from .quant import EXACT, Precision
from .render import render_view

INV = {"exp": torch.log,
       "sigmoid": lambda x: torch.log(torch.clamp(x, 1e-7, 1 - 1e-7))
       - torch.log1p(-torch.clamp(x, 1e-7, 1 - 1e-7))}
RENDER_DEFAULTS = dict(frustum_culling_radius=6.0, T_thresh=1e-4,
                       tile_size=16, tile_culling_radius=6.0,
                       svec_act="exp", alpha_act="sigmoid",
                       color_act="sigmoid", near=1e-3)
INIT_DEFAULTS = dict(num_points=4096, mean_std=0.6, svec_val=0.02,
                     alpha_val=0.8, random_color=True)
VSD_DEFAULTS = dict(guidance_scale=7.5, guidance_scale_lora=1.0,
                    lora_cfg_training=True, lora_cfg_drop_prob=0.1,
                    lora_n_timestamp_samples=1, lr_lora=1e-4,
                    weighting_strategy="sds", use_view_dependent_prompt=True,
                    min_step_percent=0.02, max_step_percent=0.98)
SDS_DEFAULTS = dict(guidance_scale=100.0, weighting_strategy="sds",
                    use_view_dependent_prompt=True, min_step_percent=0.02,
                    max_step_percent=(0.98, 0.5, 2001))
LOSS_DEFAULTS = dict(sds=0.1, vsd=1.0, lora=1.0)


def C(v, step: int, max_steps: int) -> float:
    """gsgen's schedule spec: a constant or [start, v0, v1, end]."""
    if isinstance(v, (int, float)):
        return float(v)
    v = list(v)
    if len(v) == 3:
        v = [0] + v
    start, v0, v1, end = v[:4]
    if isinstance(end, float) and not float(end).is_integer():
        end = int(end * max_steps)
    t = max(min(1.0, (step - start) / (int(end) - start)), 0.0)
    return v0 + (v1 - v0) * t


def lr_at(spec, step: int, max_steps: int) -> float:
    """A field's learning rate: ``[lr0, lr1, steps, "exp"]`` decays
    exponentially, anything else is a schedule spec."""
    if isinstance(spec, (list, tuple)) and len(spec) == 4 \
            and isinstance(spec[3], str):
        lr0, lr1, steps, kind = spec
        if kind != "exp":
            raise ValueError(f"lr schedule {kind!r}")
        t = min(max(step / steps, 0.0), 1.0)
        return math.exp(math.log(lr0) * (1 - t) + math.log(lr1) * t)
    return C(spec, step, max_steps)


def direction_idx(elev, azim, front=45.0, back=45.0, overhead=60.0):
    a = (azim + 180.0) % 360.0 - 180.0
    idx = torch.zeros(elev.shape, dtype=torch.long, device=elev.device)
    idx = torch.where((a > -front) & (a < front), 1, idx)
    idx = torch.where((a > 180.0 - back) | (a < -180.0 + back), 2, idx)
    return torch.where(elev > overhead, 3, idx)


def alphas_cumprod(device):
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0).to(device)


class ReferenceRun:
    """The reference's trainer.  ``cfg`` is the merged YAML config;
    ``unet_cfg`` / ``vae_cfg`` the diffusers configs; ``weights`` holds
    ``unet`` and ``vae`` state dicts (LoRA and camera-embedding leaves in
    ``unet`` under VSD); ``bank`` the prompt's embeddings (``text``,
    ``uncond`` [L, D], ``text_vd``, ``uncond_vd`` [4, L, D]);
    ``precision`` a :class:`.quant.Precision` for ``unet`` and ``vae``."""

    def __init__(self, cfg: Dict, unet_cfg: Dict, vae_cfg: Dict,
                 weights: Dict, bank: Dict, device,
                 precision: Dict[str, Precision] = None):
        precision = precision or {}
        dev = torch.device(device)
        self.dev = dev
        g = cfg.get("guidance", {})
        self.kind = g.get("type", "sds")
        if self.kind not in ("sds", "vsd"):
            raise ValueError(f"guidance {self.kind!r}")
        self.g = dict(VSD_DEFAULTS if self.kind == "vsd" else SDS_DEFAULTS)
        self.g.update({k: v for k, v in g.items() if k in self.g})
        self.p = cfg.get("prompt", {})
        self.r = dict(RENDER_DEFAULTS)
        self.r.update({k: v for k, v in cfg.get("renderer", {}).items()
                       if k in RENDER_DEFAULTS})
        self.bg_range = cfg.get("renderer", {}).get(
            "background", {}).get("range", (0.0, 1.0))
        if cfg.get("renderer", {}).get("background", {}).get(
                "type", "random") != "random":
            raise ValueError("the reference draws random backgrounds")
        tr = cfg.get("trainer", {})
        self.seed = int(tr.get("seed", 0))
        self.B = int(tr.get("batch_size", 4))
        self.max_steps = int(tr.get("max_steps", 15000))
        self.lr = dict(tr.get("lr", {}))
        self.w = dict(LOSS_DEFAULTS)
        self.w.update(tr.get("loss", {}))
        data = dict(cfg.get("data", {}))
        data.setdefault("batch_size", self.B)
        data.setdefault("max_steps", self.max_steps)
        self.cams = Cameras(data, self.seed)
        self.near_plane = float(self.cams.c["near_plane"])
        self.far_plane = float(self.cams.c["far_plane"])

        vsd = self.kind == "vsd"
        with torch.device("meta"):
            self.unet = UNet(unet_cfg, lora_rank=4 if vsd else 0,
                             class_embed_proj_dim=16 if vsd else None)
            self.vae = VAE(vae_cfg)
        for net, sd in ((self.unet, weights["unet"]),
                        (self.vae, weights["vae"])):
            net.load_state_dict({k: v.to(dev, torch.float32)
                                 for k, v in sd.items()},
                                strict=True, assign=True)
            net.requires_grad_(False)
        set_precision(self.unet, precision.get("unet", EXACT))
        set_precision(self.vae, precision.get("vae", EXACT))
        self.image_size = (int(unet_cfg.get("sample_size", 64))
                           * 2 ** (len(vae_cfg["block_out_channels"]) - 1))
        self.bank = {k: v.to(dev, torch.float32) for k, v in bank.items()}
        self.ac = alphas_cumprod(dev)

        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed)
        ini = dict(INIT_DEFAULTS)
        ini.update({k: v for k, v in cfg.get("init", {}).items()
                    if k in INIT_DEFAULTS})
        if cfg.get("init", {}).get("type", "base") != "base":
            raise ValueError("the reference starts from the base init")
        n = int(ini["num_points"])
        m = int(cfg.get("init", {}).get("capacity") or n)
        f32 = dict(dtype=torch.float32, device=dev)
        mean = torch.randn(n, 3, generator=self.gen, **f32) * ini["mean_std"]
        color = (torch.rand(n, 3, generator=self.gen, **f32)
                 if ini["random_color"] else torch.full((n, 3), 0.5, **f32))

        def pad(x, fill):
            return torch.cat([x, torch.full((m - n,) + x.shape[1:], fill,
                                            **f32)])
        qvec = torch.zeros(m, 4, **f32)
        qvec[:, 0] = 1.0
        self.params = dict(
            mean=pad(mean, 0.0), qvec=qvec,
            svec=pad(INV[self.r["svec_act"]](torch.full(
                (n, 3), float(ini["svec_val"]), **f32)),
                float(INV[self.r["svec_act"]](torch.tensor(1e-4)))),
            color=pad(INV[self.r["color_act"]](color), 0.0),
            alpha=pad(INV[self.r["alpha_act"]](torch.full(
                (n,), float(ini["alpha_val"]), **f32)), -10.0))
        if vsd:
            self.params.update({
                f"gp/{k}": v.detach().clone()
                for k, v in self.unet.named_parameters()
                if any("lora" in p or p == "class_embedding"
                       for p in k.split("."))})
        self.active = torch.arange(m, device=dev) < n
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.step_no = 0

    # ---- one step ----

    def _embedding(self, elev, azim, view_dependent: bool):
        b, B = self.bank, elev.shape[0]
        if view_dependent:
            idx = direction_idx(
                elev, azim, float(self.p.get("front_threshold", 45.0)),
                float(self.p.get("back_threshold", 45.0)),
                float(self.p.get("overhead_threshold", 60.0)))
            return torch.cat([b["text_vd"][idx], b["uncond_vd"][idx]])
        return torch.cat([b["text"].expand(B, *b["text"].shape),
                          b["uncond"].expand(B, *b["uncond"].shape)])

    def _unet(self, train, lat, t, ctx, cam=None, lora_scale=0.0):
        if train:
            return torch.func.functional_call(
                self.unet, train, (lat, t, ctx),
                dict(class_labels=cam, lora_scale=lora_scale))
        return self.unet(lat, t, ctx, class_labels=cam,
                         lora_scale=lora_scale)

    def _loss(self, leaves, batch, bgs, step: int):
        dev, B, g = self.dev, self.B, self.g
        rgb = torch.stack([
            render_view(leaves, self.active,
                        {k: v[b] for k, v in batch.items()}, bgs[b], self.r,
                        self.cams.focal_static, self.cams.reso,
                        self.near_plane, self.far_plane)
            for b in range(B)])
        if rgb.shape[1] != self.image_size:
            rgb = F.interpolate(rgb.permute(0, 3, 1, 2),
                                size=(self.image_size,) * 2,
                                mode="bilinear", align_corners=False,
                                antialias=True).permute(0, 2, 3, 1)
        latents = self.vae.encode(rgb * 2.0 - 1.0)
        min_t = int(C(g["min_step_percent"], step, self.max_steps) * 1000)
        max_t = int(C(g["max_step_percent"], step, self.max_steps) * 1000)
        t = torch.randint(min_t, max_t + 1, (B,), generator=self.gen,
                          device=dev)
        noise = torch.randn(latents.shape, generator=self.gen, device=dev,
                            dtype=latents.dtype)
        ac = self.ac[t].reshape(-1, 1, 1, 1)
        w = 1.0 - ac
        el, az = batch["elevation"], batch["azimuth"]
        train = {k[3:]: v for k, v in leaves.items() if k.startswith("gp/")}
        with torch.no_grad():
            ln = ac.sqrt() * latents.detach() + (1.0 - ac).sqrt() * noise
            lat2, t2 = torch.cat([ln, ln]), torch.cat([t, t])
            emb_vd = self._embedding(el, az, g["use_view_dependent_prompt"])
            eps = self._unet(None, lat2, t2, emb_vd)
            e_text, e_unc = eps[:B], eps[B:]
            if self.kind == "sds":
                pred = e_text + g["guidance_scale"] * (e_text - e_unc)
                grad = torch.nan_to_num(w * (pred - noise))
            else:
                c2w = batch["c2w"]
                cam = torch.cat([c2w.reshape(B, -1), torch.tensor(
                    [0.0, 0.0, 0.0, 1.0], device=dev).expand(B, 4)], -1)
                emb_vi = self._embedding(el, az, False)[:B]
                pre = e_unc + g["guidance_scale"] * (e_text - e_unc)
                eps = self._unet(train, lat2, t2, torch.cat([emb_vi] * 2),
                                 torch.cat([cam, torch.zeros_like(cam)]),
                                 1.0)
                lo = eps[B:] + g["guidance_scale_lora"] * (eps[:B] - eps[B:])
                grad = torch.nan_to_num(w * (pre - lo))
        target = (latents - grad).detach()
        loss_g = 0.5 * torch.sum((latents - target) ** 2) / B
        if self.kind == "sds":
            return C(self.w["sds"], step, self.max_steps) * loss_g
        S = int(g["lora_n_timestamp_samples"])
        lat_sg = latents.detach().repeat(S, 1, 1, 1)
        t_l = torch.randint(0, 1000, (B * S,), generator=self.gen, device=dev)
        noise_l = torch.randn(lat_sg.shape, generator=self.gen, device=dev,
                              dtype=lat_sg.dtype)
        acl = self.ac[t_l].reshape(-1, 1, 1, 1)
        noisy = acl.sqrt() * lat_sg + (1.0 - acl).sqrt() * noise_l
        cam_l = cam.repeat(S, 1)
        if g["lora_cfg_training"]:
            drop = torch.rand((), generator=self.gen, device=dev) \
                < g["lora_cfg_drop_prob"]
            cam_l = torch.where(drop, torch.zeros_like(cam_l), cam_l)
        eps_hat = self._unet(train, noisy, t_l, emb_vi.repeat(S, 1, 1), cam_l,
                             1.0)
        loss_lora = torch.mean((eps_hat - noise_l) ** 2)
        return (C(self.w["vsd"], step, self.max_steps) * loss_g
                + C(self.w["lora"], step, self.max_steps) * loss_lora)

    def step(self) -> Dict:
        """One training step: ``{"loss": float, "grads": {leaf: tensor}}``
        (the gradients as Adam receives them); the leaves move."""
        s, dev = self.step_no, self.dev
        batch = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in self.cams.batch(s).items()}
        lo, hi = self.bg_range
        bgs = [torch.rand(3, generator=self.gen, dtype=torch.float32,
                          device=dev) * (hi - lo) + lo
               for _ in range(self.B)]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        loss = self._loss(leaves, batch, bgs, s)
        names = list(leaves)
        gr = torch.autograd.grad(loss, [leaves[k] for k in names],
                                 allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if v is None else v
                 for k, v in zip(names, gr)}
        self._adam(grads, s)
        self.step_no += 1
        return {"loss": float(loss.detach()), "grads": grads}

    @torch.no_grad()
    def _adam(self, grads, step: int, b1=0.9, b2=0.999, eps=1e-15):
        self.count += 1
        t = torch.tensor(float(self.count), dtype=torch.float32,
                         device=self.dev)
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=self.dev) ** t
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=self.dev) ** t
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = b1 * self.mu[k] + (1.0 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1.0 - b2) * g * g
            lr = (C(self.g["lr_lora"], step, self.max_steps)
                  if k.startswith("gp/")
                  else lr_at(self.lr[k], step, self.max_steps))
            self.params[k] = p - lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + eps)

    def run(self, n_steps: int, first_step=None) -> Dict:
        """``n_steps`` steps from the start: each step's loss, the first
        step's gradients and every leaf's change over the steps.  The
        first step runs inside the context ``first_step()``, if given."""
        start = {k: v.clone() for k, v in self.params.items()}
        losses: List[float] = []
        first = None
        for i in range(n_steps):
            with (first_step() if first_step and i == 0
                  else contextlib.nullcontext()):
                out = self.step()
            losses.append(out["loss"])
            first = first or out["grads"]
        return {"losses": losses, "grads": first,
                "change": {k: self.params[k] - start[k] for k in start}}
