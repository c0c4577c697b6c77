"""Quality metrics: PSNR / SSIM / LPIPS (reference utils/metrics.py:10-41).

Port of the JAX package's ``utils/metrics.py``.  LPIPS is the AlexNet
variant (torchmetrics LearnedPerceptualImagePatchSimilarity default):
frozen AlexNet features at the five ReLU taps (:data:`_ALEX`),
channel-unit-normalized, squared difference, learned non-negative 1x1
"lin" weights, spatial mean, summed over taps.  The parameter tree is
``{"conv": [{"w": [O, I, kh, kw], "b": [O]}] * 5, "lin": [[C]] * 5}`` of
tensors: random (:func:`init_lpips_params`), from a torchvision AlexNet
state dict and the lpips ``alex.pth`` lin weights
(:func:`load_lpips_params`, local files only), or from the JAX package's
tree of HWIO kernels (:func:`lpips_params_from_jax`).  Images are
[H, W, 3] or [B, H, W, 3] in [0, 1], as in the JAX package; the network
runs on the images' device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..training.losses import ssim as _ssim


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _ssim(pred, target)


# ---- LPIPS (AlexNet) ----

# lpips.ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature config: (out_ch, kernel, stride, pad, maxpool_before)
_ALEX = [(64, 11, 4, 2, False), (192, 5, 1, 2, True),
         (384, 3, 1, 1, True), (256, 3, 1, 1, False),
         (256, 3, 1, 1, False)]
# the conv layers' indices in torchvision's AlexNet ``features``
_ALEX_FEATURES = (0, 3, 6, 8, 10)


def init_lpips_params(generator: Optional[torch.Generator] = None) -> Dict:
    """Random-weight LPIPS tree (testing / shape template), drawn on the
    generator's device (a CPU generator seeded 0 by default)."""
    gen = generator or torch.Generator().manual_seed(0)
    dev = gen.device
    params = {"conv": [], "lin": []}
    in_ch = 3
    for out_ch, k, _, _, _ in _ALEX:
        w = torch.randn((out_ch, in_ch, k, k), generator=gen, device=dev)
        params["conv"].append({"w": w * 0.05,
                               "b": torch.zeros(out_ch, device=dev)})
        params["lin"].append(
            torch.randn(out_ch, generator=gen, device=dev).abs() * 0.1)
        in_ch = out_ch
    return params


def lpips_params_from_jax(params_np: Dict) -> Dict:
    """The JAX package's LPIPS tree (HWIO kernels, as numpy or JAX arrays)
    -> the port's (OIHW), on the CPU."""
    def t(x, perm=None):
        a = np.asarray(x, np.float32)
        return torch.from_numpy(np.array(
            a if perm is None else np.transpose(a, perm)))
    return {"conv": [{"w": t(c["w"], (3, 2, 0, 1)), "b": t(c["b"])}
                     for c in params_np["conv"]],
            "lin": [t(lw).reshape(-1) for lw in params_np["lin"]]}


def load_lpips_params(alexnet_path: str, lin_path: str) -> Dict:
    """Build the LPIPS tree from a torchvision AlexNet state dict
    (``features.{0,3,6,8,10}.weight/bias``) and the lpips package's
    ``alex.pth`` lin weights (``lin{i}.model.1.weight`` [C,1,1,1]),
    both read with ``torch.load(weights_only=True)``; CPU tensors."""
    for p in (alexnet_path, lin_path):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"LPIPS weights not found at {p!r}; provision a "
                "torchvision AlexNet state dict + lpips alex.pth "
                "locally (no network egress).")
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lin = torch.load(lin_path, map_location="cpu", weights_only=True)
    params = {"conv": [], "lin": []}
    for i, fidx in enumerate(_ALEX_FEATURES):
        params["conv"].append({
            "w": alex[f"features.{fidx}.weight"].float(),
            "b": alex[f"features.{fidx}.bias"].float()})
        params["lin"].append(
            lin[f"lin{i}.model.1.weight"].float().reshape(-1))
    return params


def _alex_features(params: Dict, x: torch.Tensor):
    """x [B,3,H,W] in [-1,1] -> list of 5 tap activations (NCHW)."""
    dev = x.device
    shift = torch.tensor(_SHIFT, device=dev).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=dev).reshape(1, 3, 1, 1)
    h = (x - shift) / scale
    taps = []
    for (_, _, s, p, mp), conv in zip(_ALEX, params["conv"]):
        if mp:
            h = F.max_pool2d(h, 3, 2)
        h = F.relu(F.conv2d(h, conv["w"].to(dev), conv["b"].to(dev),
                            stride=s, padding=p))
        taps.append(h)
    return taps


def lpips(pred: torch.Tensor, target: torch.Tensor,
          params: Optional[Dict] = None,
          weights_path: Optional[str] = None) -> torch.Tensor:
    """LPIPS distance; inputs [H,W,3] or [B,H,W,3] in [0,1].

    Pass ``params`` (from :func:`load_lpips_params` /
    :func:`init_lpips_params`) or ``weights_path`` as
    ``"<alexnet.pth>:<alex_lins.pth>"``.
    """
    if params is None:
        if not weights_path:
            raise FileNotFoundError(
                "LPIPS needs weights: pass params or weights_path="
                "'<alexnet.pth>:<lpips_alex.pth>' (local assets).")
        params = load_lpips_params(*weights_path.split(":"))
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    nchw = lambda x: x.permute(0, 3, 1, 2) * 2.0 - 1.0  # noqa: E731
    a = _alex_features(params, nchw(pred))
    b = _alex_features(params, nchw(target))
    total = 0.0
    for fa, fb, lw in zip(a, b, params["lin"]):
        na = fa / torch.clamp(torch.linalg.norm(fa, dim=1, keepdim=True),
                              min=1e-10)
        nb = fb / torch.clamp(torch.linalg.norm(fb, dim=1, keepdim=True),
                              min=1e-10)
        d = (na - nb) ** 2
        w = lw.to(fa.device).reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return torch.squeeze(total)


class Metrics:
    """Bundle mirroring reference utils/metrics.py Metrics; LPIPS is
    included when weights (or params) are supplied."""

    def __init__(self, lpips_params: Optional[Dict] = None,
                 lpips_weights_path: Optional[str] = None):
        self.lpips_params = lpips_params
        if lpips_params is None and lpips_weights_path:
            self.lpips_params = load_lpips_params(
                *lpips_weights_path.split(":"))

    def __call__(self, pred: torch.Tensor, target: torch.Tensor):
        out = {"psnr": psnr(pred, target), "ssim": ssim(pred, target)}
        if self.lpips_params is not None:
            out["lpips"] = lpips(pred, target, self.lpips_params)
        return out
