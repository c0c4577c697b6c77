"""Scene penalties and image losses.

Port of the JAX package's ``training/losses.py``: the seven penalties over
the masked fixed-capacity scene (``alpha``, ``mean``, ``scale``, ``NN``,
``compat``, ``move``, ``specular``; ``trainer.penalty.<name>``), the
SSIM + L1/L2 image loss of the upsample fine-tune and of image-to-3D's
original view (``ssim``, ``image_loss``), and the Pearson depth loss of
image-to-3D and the depth estimator (``pearson_depth_loss``).  :func:`penalty` passes each penalty its keywords.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.scene import RenderConfig, activate
from ..utils.ops import distance_to_gaussian_surface, knn_self


def _masked_mean(x, mask):
    return (torch.sum(torch.where(mask, x, torch.zeros_like(x)))
            / torch.clamp(torch.sum(mask), min=1.0))


def alpha_penalty(params, active, cfg: RenderConfig,
                  kind: str = "center_weighted") -> torch.Tensor:
    """Mean opacity over active Gaussians, optionally weighted by the
    (detached) distance from the origin."""
    alpha = activate(params, cfg)[4]
    if kind == "uniform_l1":
        return _masked_mean(alpha, active)
    if kind == "uniform_l2":
        return _masked_mean(alpha * alpha, active)
    if kind == "center_weighted":
        r = torch.linalg.norm(params["mean"].detach(), dim=-1)
        return _masked_mean(r * alpha, active)
    raise ValueError(f"alpha penalty {kind}")


def mean_penalty(params, active, kind: str = "uniform_l1") -> torch.Tensor:
    """Mean distance of the Gaussians from the origin (plain, squared, or
    weighted by its detached self)."""
    r = torch.linalg.norm(params["mean"], dim=-1)
    if kind == "uniform_l1":
        return _masked_mean(r, active)
    if kind == "uniform_l2":
        return _masked_mean(r * r, active)
    if kind == "weighted_l1":
        return _masked_mean(r.detach() * r, active)
    if kind == "weighted_l2":
        rd = r.detach()
        return _masked_mean(rd * rd * r * r, active)
    raise ValueError(f"mean penalty {kind}")


def scale_penalty(params, active, cfg: RenderConfig) -> torch.Tensor:
    """Total ellipsoid volume: a sum over the live Gaussians, not a mean
    (as the reference and the JAX package compute it)."""
    vol = torch.prod(activate(params, cfg)[2], dim=-1)
    return torch.sum(torch.where(active, vol, torch.zeros_like(vol)))


def nn_penalty(params, active) -> torch.Tensor:
    """Mean distance to the nearest live neighbour."""
    d2, _ = knn_self(params["mean"], 1, mask=active)
    return _masked_mean(torch.sqrt(torch.clamp(d2[:, 0], min=0.0)), active)


def compat_penalty(params, active, cfg: RenderConfig, kind: str = "l1"
                   ) -> torch.Tensor:
    """Mean gap between each Gaussian's surface and its nearest live
    neighbour's, over the pairs that leave a gap (the compactness
    regularizer)."""
    svec = activate(params, cfg)[2]
    mean, qvec = params["mean"], params["qvec"]
    _, idx = knn_self(mean, 1, mask=active)
    idx = idx[:, 0].long()
    nn_pos = mean[idx]
    d_nn_surf = distance_to_gaussian_surface(nn_pos, svec[idx], qvec[idx],
                                             mean)
    d_self_surf = distance_to_gaussian_surface(mean, svec, qvec, nn_pos)
    dist = torch.linalg.norm(nn_pos - mean, dim=-1)
    gap = dist - d_self_surf - d_nn_surf
    m = active & (gap > 0)
    if kind == "l1":
        return _masked_mean(gap, m)
    if kind == "l2":
        return _masked_mean(gap * gap, m)
    raise ValueError(f"compat penalty {kind}")


def move_penalty(params, active, prev_mean: torch.Tensor) -> torch.Tensor:
    """Mean displacement from ``prev_mean`` (the trainer passes the means
    before the previous update)."""
    d2 = torch.sum((params["mean"] - prev_mean.detach()) ** 2, dim=-1)
    return _masked_mean(torch.sqrt(d2 + 1e-12), active)


def specular_penalty(params, active) -> torch.Tensor:
    """Mean specular albedo."""
    if "specular" not in params:
        raise ValueError("specular penalty needs RenderConfig.pbr=True")
    spec = torch.sigmoid(params["specular"])
    return _masked_mean(torch.mean(spec, dim=-1), active)


PENALTIES = dict(alpha=alpha_penalty, mean=mean_penalty, scale=scale_penalty,
                 NN=nn_penalty, compat=compat_penalty, move=move_penalty,
                 specular=specular_penalty)


def penalty(name: str, spec: dict, params, active, cfg: RenderConfig,
            prev_mean: torch.Tensor) -> torch.Tensor:
    """Penalty ``name`` with its config block ``spec`` (its ``type``) and
    the keywords it takes: the render config, the previous means."""
    if name == "alpha":
        kw = dict(cfg=cfg, kind=spec.get("type", "center_weighted"))
    elif name == "compat":
        kw = dict(cfg=cfg, kind=spec.get("type", "l1"))
    elif name == "mean":
        kw = dict(kind=spec.get("type", "uniform_l1"))
    elif name == "scale":
        kw = dict(cfg=cfg)
    elif name == "move":
        kw = dict(prev_mean=prev_mean)
    else:
        kw = {}
    return PENALTIES[name](params, active, **kw)


# -- image losses --

def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2
         ) -> torch.Tensor:
    """Mean SSIM of two [H, W, C] images: a separable Gaussian window,
    zero padding (as the JAX package's ``conv_general_dilated`` pads)."""
    win = _gaussian_window(window_size, sigma, a.device)
    pad = window_size // 2
    kh = win.reshape(1, 1, -1, 1)
    kw = win.reshape(1, 1, 1, -1)

    def blur(x):
        x = x.permute(2, 0, 1)[:, None]                # [C, 1, H, W]
        x = F.conv2d(F.conv2d(x, kh, padding=(pad, 0)), kw,
                     padding=(0, pad))
        return x[:, 0].permute(1, 2, 0)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


def image_loss(pred: torch.Tensor, target: torch.Tensor,
               ssim_weight: float = 0.2, kind: str = "l1") -> torch.Tensor:
    """``ssim_weight * (1 - SSIM) + (1 - ssim_weight) * L1 (or L2)``."""
    if kind == "l1":
        photo = torch.mean(torch.abs(pred - target))
    else:
        photo = torch.mean((pred - target) ** 2)
    return (ssim_weight * (1.0 - ssim(pred, target))
            + (1.0 - ssim_weight) * photo)


def pearson_depth_loss(pred: torch.Tensor, target: torch.Tensor
                       ) -> torch.Tensor:
    """``1 - corr(pred, target)`` of two depth maps (utils/loss.py:61-67),
    with 1e-8 added to the product of the centred norms."""
    p = pred.reshape(-1)
    t = target.reshape(-1)
    p = p - p.mean()
    t = t - t.mean()
    denom = torch.linalg.norm(p) * torch.linalg.norm(t) + 1e-8
    return 1.0 - torch.dot(p, t) / denom
