"""Gaussian-splatting scene model: raw parameter dict + functional renderer.

Port of the JAX package's ``models/scene.py``.  Parameters are a dict of raw
(pre-activation) tensors with a static capacity ``M`` (``mean`` [M,3],
``qvec`` [M,4] wxyz, ``svec`` [M,3], ``color`` [M,3], ``alpha`` [M]); the
live set is the ``active`` mask.  ``render_view`` is a pure function of
its inputs; ``render_batch`` loops over views.  All channels (rgb, depth,
z^2) composite in one pass; ``opacity = 1 - T`` and ``z_var = E[z^2] -
E[z]^2`` fall out of it.

Both binning layouts are ported (``binning_layout``: padded | compact,
chosen as the JAX package chooses them).  Not ported yet (each raises
``NotImplementedError``): PBR, normal channels, spherical harmonics and
tile-sharded rendering.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.binning import bin_gaussians
from ..ops.camera import CameraIntrinsics, get_frustum, sphere_in_frustum
from ..ops.cuda_raster import rasterize_tiles_cuda
from ..ops.projection import (conic_from_cov2d, project_gaussians,
                              screen_radii)
from ..utils.activations import act, inv_act

FIELDS = ("mean", "qvec", "svec", "color", "alpha")
# The JAX package's compact layout needs its resident-cotangent backward,
# whose cotangents (n_tiles * ch_out * P * 4 bytes) must fit this TPU VMEM
# budget.  The port keeps the same rule so that a config picks the same
# layout in both packages; it changes which kernels run (K8/K9 or K1/K2),
# not any pixel.
RESIDENT_BUDGET = 9 * 1024 * 1024
STATS = ("max_radii2d", "grad_accum", "grad_cnt")


@dataclasses.dataclass
class SceneState:
    """Raw params plus the live mask and the densify statistics."""

    params: Dict[str, torch.Tensor]
    active: torch.Tensor        # [M] bool
    max_radii2d: torch.Tensor   # [M] screen-radius running max
    grad_accum: torch.Tensor    # [M] accumulated ||d loss / d mean2d||
    grad_cnt: torch.Tensor      # [M] views the Gaussian was visible in


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Renderer configuration; accepts every key of the JAX package's.

    The device of the tensors picks the path: the CUDA kernels for CUDA
    tensors, their plain versions for CPU tensors, whatever ``backend``
    (auto | pallas | xla) says.  ``pallas_interpret``, ``mxu_scans`` and
    ``fast_fwd_cumprod`` are TPU-only and ignored: the kernels run exact
    scans.
    """

    tile_size: int = 16
    frustum_culling_radius: float = 6.0
    tile_culling_radius: float = 6.0
    T_thresh: float = 1e-4
    svec_act: str = "exp"
    alpha_act: str = "sigmoid"
    color_act: str = "sigmoid"
    depth_detach: bool = True
    dup_cap: int = 1 << 18
    chunk: int = 256
    near: float = 1e-3
    backend: str = "auto"
    pallas_interpret: bool = False
    pad_frac: float = 0.75
    mxu_scans: bool = True
    binning_layout: str = "padded"
    fast_fwd_cumprod: bool = False
    sh_degree: int = 0
    pbr: bool = False
    normal_type: str = "estimated"
    normal_neighborhood: int = 16
    normal_as_rgb: bool = False
    render_normal: bool = False


def check_supported(cfg: RenderConfig) -> None:
    """Raise for renderer features this port does not have yet."""
    for name in ("pbr", "render_normal", "normal_as_rgb"):
        if getattr(cfg, name):
            raise NotImplementedError(name)
    if cfg.sh_degree > 0:
        raise NotImplementedError("sh_degree > 0")
    if cfg.binning_layout not in ("padded", "compact"):
        raise ValueError(f"binning_layout {cfg.binning_layout}")
    if cfg.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"backend {cfg.backend}")


def activate(params: Dict[str, torch.Tensor], cfg: RenderConfig):
    """Raw params -> physical (mean, qvec, svec, color, alpha)."""
    return (params["mean"], params["qvec"],
            act(cfg.svec_act)(params["svec"]),
            act(cfg.color_act)(params["color"]),
            act(cfg.alpha_act)(params["alpha"]))


def make_scene(mean, qvec, svec, color, alpha, cfg: RenderConfig,
               capacity: Optional[int] = None, raw: bool = False
               ) -> SceneState:
    """SceneState from physical (or raw) initial tensors, padded to
    ``capacity`` (padding: identity rotation, scale 1e-4, alpha logit
    -10, inactive)."""
    n = mean.shape[0]
    m = capacity or n
    if m < n:
        raise ValueError(f"capacity {m} < {n} points")
    check_supported(cfg)
    if not raw:
        svec = inv_act(cfg.svec_act)(svec)
        color = inv_act(cfg.color_act)(color)
        alpha = inv_act(cfg.alpha_act)(alpha)
    dev = mean.device

    def pad(x, fill=0.0):
        filler = torch.full((m - n,) + tuple(x.shape[1:]), float(fill),
                            dtype=torch.float32, device=dev)
        return torch.cat([x.to(torch.float32), filler], dim=0)

    qvec = pad(qvec)
    qvec[n:, 0] = 1.0
    svec_fill = inv_act(cfg.svec_act)(torch.tensor(1e-4))
    params = dict(mean=pad(mean), qvec=qvec, svec=pad(svec, svec_fill),
                  color=pad(color), alpha=pad(alpha, -10.0))
    active = torch.arange(m, device=dev) < n
    zeros = torch.zeros(m, dtype=torch.float32, device=dev)
    return SceneState(params=params, active=active, max_radii2d=zeros,
                      grad_accum=zeros.clone(), grad_cnt=zeros.clone())


def scene_from_numpy(arrays: Dict[str, np.ndarray], device) -> SceneState:
    """SceneState from the JAX package's raw fields as numpy arrays
    (``mean qvec svec color alpha``, optional ``active`` and the densify
    statistics; missing ones default to all-active and zeros)."""
    def tens(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    params = {f: tens(arrays[f]) for f in FIELDS}
    m = params["mean"].shape[0]
    active = (tens(arrays["active"], torch.bool) if "active" in arrays
              else torch.ones(m, dtype=torch.bool, device=device))
    stats = {s: tens(arrays[s]) if s in arrays
             else torch.zeros(m, dtype=torch.float32, device=device)
             for s in STATS}
    return SceneState(params=params, active=active, **stats)


def binning_layout(cfg: RenderConfig, n_tiles: int, rgb_only: bool) -> str:
    """The JAX package's layout rule: compact when asked for, on the kernel
    path (backend ``auto`` or ``pallas``: the kernels on CUDA tensors,
    their plain versions on CPU tensors), and while the cotangents fit
    :data:`RESIDENT_BUDGET`; padded otherwise."""
    ch_guess = 8 if (3 if rgb_only else 6) + 2 <= 8 else 16
    P = cfg.tile_size * cfg.tile_size
    ok = (cfg.binning_layout == "compact" and cfg.backend != "xla"
          and n_tiles * ch_guess * P * 4 <= RESIDENT_BUDGET)
    return "compact" if ok else "padded"


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def render_view(params: Dict[str, torch.Tensor], active: torch.Tensor,
                c2w, intr: CameraIntrinsics, cfg: RenderConfig, bg,
                fx=None, fy=None, cx=None, cy=None, rgb_only: bool = False,
                mean2d_tap: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Render one view on the device of ``params``.

    Returns ``rgb`` [H,W,3], ``T`` and ``n_dup`` (+ ``depth``,
    ``opacity``, ``z_var``, ``radii2d``, ``visible`` unless
    ``rgb_only``).  Focal/center scalars become float32 tensors, as the
    JAX package's per-view batch scalars are float32 arrays.
    """
    check_supported(cfg)
    dev = params["mean"].device
    c2w = _f32(c2w, dev)
    fx = _f32(intr.fx if fx is None else fx, dev)
    fy = _f32(intr.fy if fy is None else fy, dev)
    cx = _f32(intr.cx if cx is None else cx, dev)
    cy = _f32(intr.cy if cy is None else cy, dev)

    mean, qvec, svec, color, alpha = activate(params, cfg)
    normals, pts = get_frustum(c2w, intr)
    radii = torch.amax(svec, dim=-1) * cfg.frustum_culling_radius
    cull = sphere_in_frustum(mean, radii, normals, pts)
    proj = project_gaussians(mean, qvec, svec, c2w,
                             detach_depth=cfg.depth_detach, near=cfg.near)
    vis = active & cull & proj.in_front

    mean2d = proj.mean2d
    if mean2d_tap is not None:
        mean2d = mean2d + mean2d_tap

    chunk = cfg.chunk
    conic, _ = conic_from_cov2d(proj.cov2d)
    n_tiles_pad = (-(-intr.w // cfg.tile_size)) * (-(-intr.h // cfg.tile_size))
    pad_budget = int(n_tiles_pad * chunk * cfg.pad_frac
                     + chunk - 1) // chunk * chunk
    bins = bin_gaussians(
        mean2d.detach(), proj.cov2d.detach(), proj.depth.detach(), vis,
        fx, fy, cx, cy, intr.w, intr.h, cfg.tile_size, cfg.dup_cap,
        chunk=chunk, tile_culling_radius=cfg.tile_culling_radius,
        alpha=alpha.detach(), pad_budget=pad_budget,
        layout=binning_layout(cfg, n_tiles_pad, rgb_only))

    if rgb_only:
        feats = color
    else:
        feats = torch.cat([color, proj.depth[:, None],
                           (proj.depth * proj.depth)[:, None]], dim=-1)

    topleft = (-cx / fx, -cy / fy)
    psz = (1.0 / fx, 1.0 / fy)
    img, T = rasterize_tiles_cuda(
        mean2d, conic, alpha, feats, bins, topleft, psz, w=intr.w, h=intr.h,
        tile_size=cfg.tile_size, chunk=chunk, T_thresh=cfg.T_thresh)

    bg = _f32(bg, dev)
    if bg.dim() == 1:
        bg = bg[None, None, :]
    rgb = img[..., :3] + T[..., None] * bg
    out = {"rgb": rgb, "T": T, "n_dup": bins.total}
    if not rgb_only:
        depth = img[..., 3]
        z2 = img[..., 4]
        out.update(depth=depth, opacity=1.0 - T, z_var=z2 - depth * depth,
                   radii2d=torch.where(vis, screen_radii(proj.cov2d),
                                       torch.zeros_like(alpha)),
                   visible=vis)
    return out


def render_batch(params, active, c2ws, intr, cfg, bgs, fxs=None, fys=None,
                 cxs=None, cys=None, rgb_only=False, mean2d_taps=None,
                 tile_mesh=None):
    """:func:`render_view` over a batch of cameras, one view at a time
    (the JAX package's ``lax.map``); outputs stack along a leading [B]."""
    if tile_mesh is not None:
        raise NotImplementedError("tile_mesh")
    B = len(c2ws)
    outs = []
    for b in range(B):
        pick = lambda v: None if v is None else v[b]  # noqa: E731
        outs.append(render_view(
            params, active, c2ws[b], intr, cfg, bgs[b], pick(fxs),
            pick(fys), pick(cxs), pick(cys), rgb_only=rgb_only,
            mean2d_tap=pick(mean2d_taps)))
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
