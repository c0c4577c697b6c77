"""Gaussian-sharded rendering: each rank owns a shard of the scene.

Port of the JAX package's ``parallel/gaussian_sharded.py``, the scale-out
path for scenes of millions of Gaussians:

* parameters, Adam moments and densify statistics live sharded over a
  mesh axis (``gauss``): rank ``d`` holds rows ``[d·N/D, (d+1)·N/D)`` of
  every leading-N tensor, so the per-Gaussian memory (5 fields, 2
  moments, the statistics: about 14 N floats) scales as 1/D;
* to render, each rank all-gathers the raw fields (one collective for
  all of them) and renders ITS OWN slab of tile rows with the standard
  pipeline (as :mod:`.sharded_render` does);
* the gradient of that all-gather is a reduce-scatter
  (:func:`.collectives.gather_rows`): each rank receives exactly its
  shard's per-Gaussian gradients, summed over every slab that saw them;
* densify and prune run shard-locally (:func:`sharded_density_step`):
  the fixed-capacity slot allocator needs only the shard's own
  statistics and free slots, so adaptive control sends nothing but its
  counts.

:func:`interleave_shards` balances a front-packed scene (live rows first)
over the shards before :func:`shard_scene` cuts it.  The ``gauss`` x
``tile`` 2-D mesh shards both: fields over ``gauss`` (replicated over
``tile``), image rows over both axes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.density import densify, prune
from ..models.scene import RenderConfig, render_view
from ..ops.camera import CameraIntrinsics
from ..training.optimizer import adam_update
from . import collectives as col
from .mesh import axis_group, axis_rank, axis_size, shard_rows, tree_map
from .sharded_render import gather_images, slab_background, slab_intrinsics


def _gather_params(params: Dict[str, torch.Tensor], active: torch.Tensor,
                   group, tap: Optional[torch.Tensor] = None):
    """All-gather the raw fields (and the ``mean2d`` tap) along the
    leading axis, packed into one collective; differentiable, the
    gradients reduce-scattered back to each shard's owner."""
    fields = dict(params)
    if tap is not None:
        fields["mean2d_tap"] = tap
    ns = active.shape[0]
    flat = [v.reshape(ns, -1) for v in fields.values()]
    full = col.gather_rows(torch.cat(flat, dim=1), group)
    n = full.shape[0]
    parts = torch.split(full, [f.shape[1] for f in flat], dim=1)
    out = {k: p.contiguous().reshape((n,) + tuple(v.shape[1:]))
           for (k, v), p in zip(fields.items(), parts)}
    tap_full = out.pop("mean2d_tap", None)
    return out, col.gather_flags(active, group), tap_full


def _own_rows(x: torch.Tensor, group, D: int, d: int) -> torch.Tensor:
    """The MAX over ``group`` of a per-Gaussian statistic, this shard's
    rows of it."""
    return shard_rows(col.reduce_max(x, group), D, d)


def render_view_gaussian_sharded(
        params: Dict[str, torch.Tensor], active: torch.Tensor, c2w,
        intr: CameraIntrinsics, cfg: RenderConfig, bg, mesh,
        axis: str = "gauss", rgb_only: bool = False,
        mean2d_tap: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Render one view from a Gaussian-sharded scene (``params``,
    ``active`` and ``mean2d_tap`` hold this rank's rows).

    Rank ``d`` of ``axis`` also renders image rows ``[d·H/D, (d+1)·H/D)``.
    Image outputs come back whole on every rank; ``radii2d`` and
    ``visible`` come back sharded like the inputs."""
    D, d, group = axis_size(mesh, axis), axis_rank(mesh, axis), \
        axis_group(mesh, axis)
    slab_h, slab_intr = slab_intrinsics(intr, cfg, D)
    y0 = d * slab_h
    p_full, act_full, tap_full = _gather_params(params, active, group,
                                                mean2d_tap)
    out = render_view(p_full, act_full, c2w, slab_intr, cfg,
                      slab_background(bg, y0, slab_h), rgb_only=rgb_only,
                      mean2d_tap=tap_full, cull_intr=intr,
                      pixel_offset_y=y0)
    out = gather_images(out, [group])
    out["n_dup"] = col.all_reduce(out["n_dup"], group)
    if not rgb_only:
        out["radii2d"] = _own_rows(out["radii2d"], group, D, d)
        out["visible"] = _own_rows(out["visible"], group, D, d)
    return out


def render_view_gauss_tile_sharded(
        params: Dict[str, torch.Tensor], active: torch.Tensor, c2w,
        intr: CameraIntrinsics, cfg: RenderConfig, bg, mesh,
        gauss_axis: str = "gauss", tile_axis: str = "tile"
        ) -> Dict[str, torch.Tensor]:
    """The 2-D gauss x tile render (rgb, T, n_dup): fields sharded over
    ``gauss`` and replicated over ``tile``; the image splits into G·T row
    slabs and rank (g, t) renders slab ``g·T + t``.  The gradient is
    reduce-scattered over ``gauss`` and summed over ``tile``."""
    G, g = axis_size(mesh, gauss_axis), axis_rank(mesh, gauss_axis)
    T, t = axis_size(mesh, tile_axis), axis_rank(mesh, tile_axis)
    g_gauss, g_tile = axis_group(mesh, gauss_axis), axis_group(mesh,
                                                               tile_axis)
    slab_h, slab_intr = slab_intrinsics(intr, cfg, G * T)
    y0 = (g * T + t) * slab_h
    rep = col.replicated_input(g_tile, params)
    p_full, act_full, _ = _gather_params(rep, active, g_gauss)
    out = render_view(p_full, act_full, c2w, slab_intr, cfg,
                      slab_background(bg, y0, slab_h), rgb_only=True,
                      cull_intr=intr, pixel_offset_y=y0)
    out = gather_images(out, [g_tile, g_gauss])
    out["n_dup"] = col.all_reduce(col.all_reduce(out["n_dup"], g_gauss),
                                  g_tile)
    return out


def interleave_shards(tree, D: int):
    """Strided permutation of every leading-N tensor (or array) whose N
    divides by ``D``, so each of D contiguous shards receives every D-th
    row.

    Scenes are front-packed (live rows first, free capacity last): a
    contiguous split would give the first shards no free slots and the
    last no live rows, starving shard-local densify.  The multiset of
    Gaussians, and so every render, is unchanged.  Apply once, before
    :func:`shard_scene`."""
    def perm(x):
        if x.ndim < 1 or x.shape[0] % D != 0:
            return x
        n = x.shape[0]
        idx = torch.arange(n).reshape(n // D, D).T.reshape(-1)
        if isinstance(x, torch.Tensor):
            return x[idx.to(x.device)]
        return x[idx.numpy()]
    return tree_map(perm, tree)


def shard_scene(state, mesh, axis: str = "gauss"):
    """This rank's contiguous 1/D of every leading-N tensor of ``state``
    (a SceneState, an AdamState, a dict of fields); other leaves stay.
    The leading axis must divide by the axis size."""
    D, d = axis_size(mesh, axis), axis_rank(mesh, axis)
    return tree_map(lambda x: shard_rows(x, D, d) if x.ndim >= 1 else x,
                    state)


def _render_loss(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.mean(out["rgb"] ** 2) + torch.mean(out["T"])


def _adam_step(render: Callable, lr: float):
    """``step(params, active, opt, c2w, bg) -> (params', opt', loss)``:
    ``render`` -> grads -> Adam on this rank's shard."""
    def step(params, active, opt, c2w, bg):
        loss, grads = gaussian_sharded_grad_step(
            lambda p, a: _render_loss(render(p, a, c2w, bg)))(params, active)
        new, opt = adam_update(grads, opt, params, lr)
        return new, opt, loss
    return step


def gaussian_sharded_train_step(mesh, intr: CameraIntrinsics,
                                cfg: RenderConfig, axis: str = "gauss",
                                lr: float = 1e-2):
    """A whole sharded train step: render -> reduce-scattered grads ->
    Adam on the shard (the moments never leave it).  Returns
    ``step(params, active, opt, c2w, bg) -> (params', opt', loss)``, every
    leading-N tensor this rank's shard; loss ``mean(rgb²) + mean(T)``."""
    return _adam_step(lambda p, a, c2w, bg: render_view_gaussian_sharded(
        p, a, c2w, intr, cfg, bg, mesh, axis=axis), lr)


def gauss_tile_train_step(mesh, intr: CameraIntrinsics, cfg: RenderConfig,
                          gauss_axis: str = "gauss", tile_axis: str = "tile",
                          lr: float = 1e-2):
    """:func:`gaussian_sharded_train_step` over the gauss x tile mesh."""
    return _adam_step(lambda p, a, c2w, bg: render_view_gauss_tile_sharded(
        p, a, c2w, intr, cfg, bg, mesh, gauss_axis=gauss_axis,
        tile_axis=tile_axis), lr)


def sharded_density_step(mesh, dcfg, pcfg, rcfg: RenderConfig,
                         axis: str = "gauss"):
    """Shard-local densify and prune as one event.

    Each shard reads only its own statistics and allocates into its own
    free slots; the per-Gaussian decisions are the replicated trainer's,
    only the slots differ.  The event's counts are summed over ``axis``.
    Returns ``fn(state, opt, radii2d_thresh, alpha_thresh, generator=None,
    noise=None) -> (state', opt', info)``; ``noise`` (split offsets, as
    :func:`..models.density.densify` takes them) replaces the draws."""
    group = axis_group(mesh, axis)

    def step(state, opt, radii2d_thresh, alpha_thresh, generator=None,
             noise=None):
        info = {}
        if dcfg.enabled:
            state, opt, dinfo = densify(state, opt, dcfg, rcfg,
                                        generator=generator, noise=noise)
            info.update(dinfo)
        if pcfg.enabled:
            state, opt, pinfo = prune(state, opt, pcfg, rcfg,
                                      radii2d_thresh, alpha_thresh)
            info.update(pinfo)
        if info:
            dev = state.active.device
            counts = col.all_reduce(torch.tensor(
                [int(v) for v in info.values()], dtype=torch.int64,
                device=dev), group)
            info = dict(zip(info, (int(c) for c in counts.tolist())))
        return state, opt, info
    return step


def gaussian_sharded_grad_step(loss_fn: Callable):
    """``step(params, active) -> (loss, grads)`` with the grads sharded
    like the params; ``loss_fn(params, active)`` renders through
    :func:`render_view_gaussian_sharded` (whose gradient reduce-scatters).
    A field the loss does not reach gets a zero gradient."""
    def step(params, active):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p, active)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p[k]) if gr is None
                               else gr for k, gr in zip(p, grads)}
    return step
