"""Tile-sharded rendering: the image's tile rows split across ranks.

Port of the JAX package's ``parallel/sharded_render.py``.  The Gaussians
are replicated; rank ``d`` of the ``tile`` axis renders rows ``[y0, y0 +
H/D)``, ``y0 = d·H/D``, as the full camera with height ``H/D``: culling
with the full camera (``cull_intr``) and binning and compositing from
row ``y0`` on (``pixel_offset_y``), so the slab runs the same kernels
(K1-K4, or K8/K9 where the slab's tile count turns the compact layout on)
over a smaller tile grid, with a duplicate capacity of ``dup_cap`` for
its own tiles.  The per-Gaussian gradients are summed over the slabs
(:func:`.collectives.replicated_input`) and every rank gets the whole
image (:func:`.collectives.gather_slabs`), as :mod:`.collectives`
describes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.scene import RenderConfig, render_view
from ..ops.camera import CameraIntrinsics
from . import collectives as col
from .mesh import axis_group, axis_rank, axis_size, shard_rows

# render_view's image outputs, gathered row-wise in this order
IMAGE_KEYS = ("rgb", "T", "depth", "opacity", "z_var", "normal")


def slab_intrinsics(intr: CameraIntrinsics, cfg: RenderConfig, D: int
                    ) -> Tuple[int, CameraIntrinsics]:
    """(slab height, the slab's intrinsics) for ``D`` slabs; ``H`` must
    divide by ``D · tile_size``."""
    if intr.h % (D * cfg.tile_size) != 0:
        raise ValueError(f"H={intr.h} must divide by devices*tile_size="
                         f"{D * cfg.tile_size}")
    return intr.h // D, dataclasses.replace(intr, h=intr.h // D)


def slab_background(bg, y0: int, slab_h: int):
    """A per-pixel background [H, W, 3] cut to the slab's rows; a colour
    stays as it is."""
    if isinstance(bg, torch.Tensor) and bg.dim() == 3:
        return bg[y0:y0 + slab_h]
    return bg


def gather_images(out: Dict[str, torch.Tensor], groups
                  ) -> Dict[str, torch.Tensor]:
    """The slab's image outputs gathered row-wise over each group in turn
    (one collective per group for all of them)."""
    keys = [k for k in IMAGE_KEYS if k in out]
    parts = [out[k] if out[k].dim() == 3 else out[k][..., None]
             for k in keys]
    x = torch.cat(parts, dim=-1)
    for g in groups:
        x = col.gather_slabs(x, g)
    res = dict(out)
    for k, p in zip(keys, torch.split(x, [q.shape[-1] for q in parts], -1)):
        res[k] = p if out[k].dim() == 3 else p[..., 0]
    return res


def render_view_tile_sharded(
        params: Dict[str, torch.Tensor], active: torch.Tensor, c2w,
        intr: CameraIntrinsics, cfg: RenderConfig, bg, mesh,
        axis: str = "tile", fx=None, fy=None, cx=None, cy=None,
        rgb_only: bool = False, mean2d_tap: Optional[torch.Tensor] = None,
        **view_kw) -> Dict[str, torch.Tensor]:
    """Render one view with its tile rows split over ``mesh[axis]``.

    Returns what :func:`..models.scene.render_view` returns for the whole
    view, on every rank: image outputs gathered, ``n_dup`` summed over the
    slabs, ``radii2d`` and ``visible`` their maximum.  ``view_kw`` go to
    ``render_view`` (lights, normals).  H must divide by D · tile_size.
    """
    D, d, group = axis_size(mesh, axis), axis_rank(mesh, axis), \
        axis_group(mesh, axis)
    slab_h, slab_intr = slab_intrinsics(intr, cfg, D)
    y0 = d * slab_h
    rep = col.replicated_input(group, {**params, "mean2d_tap": mean2d_tap})
    tap = rep.pop("mean2d_tap")
    out = render_view(rep, active, c2w, slab_intr, cfg,
                      slab_background(bg, y0, slab_h), fx=fx, fy=fy, cx=cx,
                      cy=cy, rgb_only=rgb_only, mean2d_tap=tap,
                      cull_intr=intr, pixel_offset_y=y0, **view_kw)
    out = gather_images(out, [group])
    out["n_dup"] = col.all_reduce(out["n_dup"], group)
    if not rgb_only:
        out["radii2d"] = col.reduce_max(out["radii2d"], group)
        out["visible"] = col.reduce_max(out["visible"], group)
    return out


def render_batch_data_tile_sharded(
        params: Dict[str, torch.Tensor], active: torch.Tensor, c2ws,
        intr: CameraIntrinsics, cfg: RenderConfig, bgs, mesh,
        data_axis: str = "data", tile_axis: str = "tile") -> torch.Tensor:
    """2-D render: views split over ``data``, each view's tile rows over
    ``tile``; the Gaussians replicated, so their gradients are summed over
    both axes.  Returns rgb [B, H, W, 3] on every rank; B must divide by
    the ``data`` axis."""
    D_d, d = axis_size(mesh, data_axis), axis_rank(mesh, data_axis)
    if len(c2ws) % D_d != 0:
        raise ValueError(f"{len(c2ws)} views over {D_d} data ranks")
    g_data = axis_group(mesh, data_axis)
    rep = col.replicated_input(g_data, params)
    rgb = torch.stack([
        render_view_tile_sharded(rep, active, c2w, intr, cfg, bg, mesh,
                                 axis=tile_axis, rgb_only=True)["rgb"]
        for c2w, bg in zip(shard_rows(c2ws, D_d, d),
                           shard_rows(bgs, D_d, d))])
    return col.gather_slabs(rgb, g_data)
