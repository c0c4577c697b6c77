"""Gaussian-splatting scene model: raw parameter dict + functional renderer.

Port of the JAX package's ``models/scene.py``.  Parameters are a dict of raw
(pre-activation) tensors with a static capacity ``M`` (``mean`` [M,3],
``qvec`` [M,4] wxyz, ``svec`` [M,3], ``color`` [M,3] or SH coefficients
[M, 3 sh_degree^2], ``alpha`` [M], and with ``pbr`` the optional
``specular`` [M,3] and ``normal`` [M,3]); the live set is the ``active``
mask.  ``render_view`` is a pure function of its inputs; ``render_batch``
loops over views.  All channels (rgb, depth, z^2 and, with
``render_normal``, the [0,1]-encoded normal) composite in one pass;
``opacity = 1 - T`` and ``z_var = E[z^2] - E[z]^2`` fall out of it.

Colour is sigmoid of the raw field, or with ``sh_degree > 0`` the SH
colour of the raw coefficients toward each Gaussian from the camera
centre; ``normal_as_rgb`` shows the normals instead; ``pbr`` with a light
adds a specular term (:func:`shaded_color`).  Normals are estimated from
the live means (``normal_type: estimated``) or learned; they do not depend
on the view, so ``render_batch`` computes them once for its views.

Both binning layouts are ported (``binning_layout``: padded | compact,
chosen as the JAX package chooses them).  A slab of rows renders as the
full camera with a smaller height: ``cull_intr`` culls with the full
camera and ``pixel_offset_y`` shifts the slab's first row, which is how
:mod:`..parallel` splits a view.  ``render_batch(tile_mesh=...)`` renders
each view tile-sharded over the mesh's ``tile`` axis
(:func:`..parallel.sharded_render.render_view_tile_sharded`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.binning import bin_gaussians
from ..ops.camera import CameraIntrinsics, get_frustum, sphere_in_frustum
from ..ops.cuda_raster import rasterize_tiles_cuda
from ..ops.projection import (conic_from_cov2d, project_gaussians,
                              screen_radii)
from ..ops.sh import eval_sh_color
from ..utils import profiling
from ..utils.activations import act, inv_act
from ..utils.ops import estimate_pointcloud_normals

FIELDS = ("mean", "qvec", "svec", "color", "alpha")
# the PBR fields, present only when RenderConfig.pbr made them
OPTIONAL_FIELDS = ("specular", "normal")
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
    """Raise for a layout or backend name the renderer does not know."""
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


def present_fields(params: Dict[str, torch.Tensor]) -> Tuple[str, ...]:
    """The base fields, then the optional ones ``params`` holds."""
    return FIELDS + tuple(f for f in OPTIONAL_FIELDS if f in params)


def scene_normals(params: Dict[str, torch.Tensor], active: torch.Tensor,
                  cfg: RenderConfig) -> torch.Tensor:
    """Per-Gaussian unit normals [M, 3]: estimated from the live means by
    plane fitting over ``normal_neighborhood`` neighbours, or learned
    (``normalize(tanh(raw normal))``)."""
    if cfg.normal_type == "learned":
        if "normal" not in params:
            raise ValueError("normal_type='learned' needs the PBR normal "
                             "field (RenderConfig.pbr=True)")
        n = torch.tanh(params["normal"])
        return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                               min=1e-6)
    return estimate_pointcloud_normals(params["mean"],
                                       cfg.normal_neighborhood, mask=active)


def shaded_color(light_pos, light_color, normal, specular, mean, cam_pos
                 ) -> torch.Tensor:
    """Specular term ``light_color * |<half vector, normal>| * specular``
    (the half vector between the directions to the light and to the
    camera)."""
    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-8)
    half = unit(unit(light_pos[None] - mean) + unit(cam_pos[None] - mean))
    dot = torch.clamp(torch.abs(torch.sum(half * normal, dim=-1)), 0.0, 1.0)
    return light_color[None] * dot[:, None] * specular


def make_scene(mean, qvec, svec, color, alpha, cfg: RenderConfig,
               capacity: Optional[int] = None, raw: bool = False
               ) -> SceneState:
    """SceneState from physical (or raw) initial tensors, padded to
    ``capacity`` (padding: identity rotation, scale 1e-4, alpha logit
    -10, inactive).  With ``pbr``: raw specular ``inv_sigmoid(0.05)`` on
    every slot and, for a learned normal, the raw normal set to the
    normals estimated from the ``n`` initial means (not passed through an
    inverse of tanh, as in the JAX package), zero in the padding."""
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
    if cfg.pbr:
        spec = inv_act("sigmoid")(torch.tensor(0.05, dtype=torch.float32))
        params["specular"] = torch.full((m, 3), float(spec),
                                        dtype=torch.float32, device=dev)
        if cfg.normal_type == "learned":
            params["normal"] = pad(estimate_pointcloud_normals(
                mean.to(torch.float32), cfg.normal_neighborhood))
    active = torch.arange(m, device=dev) < n
    zeros = torch.zeros(m, dtype=torch.float32, device=dev)
    return SceneState(params=params, active=active, max_radii2d=zeros,
                      grad_accum=zeros.clone(), grad_cnt=zeros.clone())


def scene_from_numpy(arrays: Dict[str, np.ndarray], device,
                     shard: Optional[Tuple[int, int]] = None) -> SceneState:
    """SceneState from the JAX package's raw fields as numpy arrays
    (``mean qvec svec color alpha``, ``specular`` / ``normal`` where given,
    optional ``active`` and the densify statistics; missing ones default
    to all-active and zeros).

    ``shard=(rank, D)`` builds rank's part of a Gaussian-sharded state
    from an unsharded scene: the rows are interleaved
    (:func:`..parallel.gaussian_sharded.interleave_shards`), then the rank
    keeps its contiguous 1/D of them."""
    if shard is not None:
        from ..parallel.gaussian_sharded import interleave_shards
        from ..parallel.mesh import shard_rows
        rank, D = shard
        arrays = interleave_shards({k: np.asarray(v) for k, v in
                                    arrays.items() if v is not None}, D)
        arrays = {k: shard_rows(v, D, rank) for k, v in arrays.items()}

    def tens(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    params = {f: tens(arrays[f]) for f in FIELDS + OPTIONAL_FIELDS
              if arrays.get(f) is not None}
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


def _uses_light(cfg: RenderConfig, params, light_pos) -> bool:
    return cfg.pbr and "specular" in params and light_pos is not None


def _needs_normals(cfg: RenderConfig, params, light_pos, rgb_only) -> bool:
    return (cfg.normal_as_rgb or _uses_light(cfg, params, light_pos)
            or (cfg.render_normal and not rgb_only))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def render_view(params: Dict[str, torch.Tensor], active: torch.Tensor,
                c2w, intr: CameraIntrinsics, cfg: RenderConfig, bg,
                fx=None, fy=None, cx=None, cy=None, rgb_only: bool = False,
                mean2d_tap: Optional[torch.Tensor] = None,
                light_pos=None, light_color=None,
                normals: Optional[torch.Tensor] = None,
                cull_intr: Optional[CameraIntrinsics] = None,
                pixel_offset_y: int = 0
                ) -> Dict[str, torch.Tensor]:
    """Render one view on the device of ``params``.

    Returns ``rgb`` [H,W,3], ``T`` and ``n_dup`` (+ ``depth``,
    ``opacity``, ``z_var``, ``radii2d``, ``visible`` unless ``rgb_only``,
    and ``normal`` [H,W,3] with ``render_normal``).  Focal/center scalars
    become float32 tensors, as the JAX package's per-view batch scalars
    are float32 arrays.  ``light_pos`` / ``light_color`` [3] turn on the
    PBR specular term; ``normals`` [M,3] passes in :func:`scene_normals`
    when the caller has them already.

    A tile-sharded slab passes ``intr`` with the slab's height, the full
    camera as ``cull_intr`` (a slab's own frustum would cull its content)
    and its first row as ``pixel_offset_y``; the binning layout then
    follows the slab's own tile count.
    """
    check_supported(cfg)
    dev = params["mean"].device
    c2w = _f32(c2w, dev)
    fx = _f32(intr.fx if fx is None else fx, dev)
    fy = _f32(intr.fy if fy is None else fy, dev)
    cx = _f32(intr.cx if cx is None else cx, dev)
    cy = _f32(intr.cy if cy is None else cy, dev)

    mean, qvec, svec, color, alpha = activate(params, cfg)
    if cfg.sh_degree > 0:
        # view-dependent colour from the raw coefficients, one direction
        # per Gaussian (from the camera centre)
        K = cfg.sh_degree ** 2
        coeffs = params["color"].reshape(params["color"].shape[0], 3, K)
        dirs = mean - c2w[:3, 3][None, :]
        dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1,
                                                    keepdim=True), min=1e-8)
        color = eval_sh_color(coeffs, dirs)
    use_light = _uses_light(cfg, params, light_pos)
    if normals is None and _needs_normals(cfg, params, light_pos, rgb_only):
        normals = scene_normals(params, active, cfg)
    if cfg.normal_as_rgb:
        color = (normals + 1.0) * 0.5
    elif use_light:
        color = color + shaded_color(
            _f32(light_pos, dev), _f32(light_color, dev), normals,
            torch.sigmoid(params["specular"]), mean, c2w[:3, 3])

    normals_f, pts = get_frustum(c2w, cull_intr or intr)
    radii = torch.amax(svec, dim=-1) * cfg.frustum_culling_radius
    cull = sphere_in_frustum(mean, radii, normals_f, pts)
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
        pixel_offset_y=pixel_offset_y, alpha=alpha.detach(),
        pad_budget=pad_budget,
        layout=binning_layout(cfg, n_tiles_pad, rgb_only))

    if rgb_only:
        feats = color
    else:
        feats = [color, proj.depth[:, None],
                 (proj.depth * proj.depth)[:, None]]
        if cfg.render_normal:
            # [0,1]-encoded normals as 3 more channels of the one pass
            feats.append((normals + 1.0) * 0.5)
        feats = torch.cat(feats, dim=-1)

    topleft = (-cx / fx, (_f32(pixel_offset_y, dev) - cy) / fy)
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
        if cfg.render_normal:
            out["normal"] = img[..., 5:8]
    return out


def render_batch(params, active, c2ws, intr, cfg, bgs, fxs=None, fys=None,
                 cxs=None, cys=None, rgb_only=False, mean2d_taps=None,
                 tile_mesh=None, light_pos=None, light_color=None):
    """:func:`render_view` over a batch of cameras, one view at a time
    (the JAX package's ``lax.map``); outputs stack along a leading [B].
    ``light_pos`` / ``light_color`` [B, 3] give each view's light.  The
    normals, when a view needs them, are computed once for all views.
    ``tile_mesh`` (a device mesh with a ``tile`` axis) renders each view
    tile-sharded over it; every rank gets the whole images."""
    view = render_view
    if tile_mesh is not None:
        from ..parallel.sharded_render import render_view_tile_sharded
        view = functools.partial(render_view_tile_sharded, mesh=tile_mesh)
    normals = None
    if _needs_normals(cfg, params, light_pos, rgb_only):
        with profiling.span("normals"):
            normals = scene_normals(params, active, cfg)
    B = len(c2ws)
    outs = []
    for b in range(B):
        pick = lambda v: None if v is None else v[b]  # noqa: E731
        outs.append(view(
            params, active, c2ws[b], intr, cfg, bgs[b], fx=pick(fxs),
            fy=pick(fys), cx=pick(cxs), cy=pick(cys), rgb_only=rgb_only,
            mean2d_tap=pick(mean2d_taps), light_pos=pick(light_pos),
            light_color=pick(light_color), normals=normals))
    out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    # K1-K4's work: the duplicates of every view
    profiling.count("render.views", B)
    profiling.count("render.dups", out["n_dup"])
    return out
