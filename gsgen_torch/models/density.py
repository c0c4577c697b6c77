"""Adaptive density control: densify (clone / split / compactness) and prune.

Port of the JAX package's ``models/density.py``.  The scene keeps a fixed
capacity ``M`` with an ``active`` mask, and densification writes new
Gaussians into free (inactive) slots:

1. a ``want`` mask and candidate rows over all ``M`` slots,
2. free slots allocated deterministically (stable argsort of ``active``;
   candidates past capacity are dropped and not counted),
3. a scatter, ``active`` flipped, and the Adam moments of every slot
   that was not live both before and after zeroed
   (:func:`..training.optimizer.mask_state_rows`).

Strategies and their quirks follow the JAX package (and the reference
behind it): legacy and official clone+split, split by scale, compactness
toward the K nearest neighbours (with ``shrink_svec``), "all", and the
transposed rotation applied to split offsets.  Each event returns new
tensors and leaves its inputs as they were.

Randomness: split offsets draw standard normals from an explicit
``torch.Generator``, one ``[M, 3]`` draw per split copy; ``noise=`` (a
list of such arrays) injects them instead, so tests can feed the JAX
package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.transforms import quat_to_rotmat
from ..training.optimizer import AdamState, mask_state_rows
from ..utils.activations import act, inv_act
from ..utils.ops import distance_to_gaussian_surface, knn_self
from .scene import RenderConfig, SceneState

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    enabled: bool = True
    type: str = "official"
    warm_up: int = 2000
    end: int = 9999
    period: int = 1000
    mean2d_thresh: float = 0.02
    split_thresh: float = 0.02
    n_splits: int = 2
    split_shrink: float = 0.8
    use_legacy: bool = True
    K: int = 3
    surface_shrink: float = 1.5
    scale_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    enabled: bool = False
    warm_up: int = 0
    end: int = 0
    period: int = 500
    radii2d_thresh: float = 1000.0
    alpha_thresh: float = 1000.0
    radii3d_thresh: float = 0.0


def should_run(step: int, enabled: bool, warm_up: int, end: int,
               period: int) -> bool:
    """Whether a densify/prune event is due at ``step``."""
    return (enabled and warm_up <= step <= end and period > 0
            and step % period == 0)


def _free_slot_targets(active: torch.Tensor, want: torch.Tensor
                       ) -> Tuple[torch.Tensor, int]:
    """Map the j-th wanted candidate to the j-th free slot (ascending).

    Returns (targets [M] int64, slot index or M = dropped; n_placed)."""
    m = active.shape[0]
    n_free = int((~active).sum())
    free_slots = torch.argsort(active.to(torch.int32), stable=True)
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (rank < n_free)
    targets = torch.where(ok, free_slots[torch.clamp(rank, 0, m - 1)],
                          torch.full_like(rank, m))
    return targets, int(ok.sum())


def _scatter_new(params: Params, active: torch.Tensor, new: Params,
                 targets: torch.Tensor) -> Tuple[Params, torch.Tensor]:
    """Write candidate rows into their target slots (M = dropped)."""
    keep = targets < active.shape[0]
    dst = targets[keep]
    out = {}
    for k, v in params.items():
        v = v.clone()
        v[dst] = new[k][keep]
        out[k] = v
    active = active.clone()
    active[dst] = True
    return out, active


def _split_offsets(qvec: torch.Tensor, svec: torch.Tensor,
                   normals: torch.Tensor) -> torch.Tensor:
    """World-space offsets ``R^T (svec * n)`` of split copies, n ~ N(0, 1)
    (the transpose is the reference's, kept)."""
    return torch.einsum("nji,nj->ni", quat_to_rotmat(qvec), normals * svec)


def _normals(noise: Optional[Sequence], i: int, shape, generator, device
             ) -> torch.Tensor:
    if noise is not None:
        return torch.tensor(noise[i], dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def _finish(state: SceneState, opt: AdamState, params: Params,
            active: torch.Tensor):
    """New state; moments kept only for rows live before and after."""
    opt = mask_state_rows(opt, state.active & active)
    return dataclasses.replace(state, params=params, active=active), opt


def _split_copies(state: SceneState, params: Params, active: torch.Tensor,
                  mask: torch.Tensor, svec: torch.Tensor, n_copies: int,
                  shrink: float, rcfg: RenderConfig, generator, noise
                  ) -> Tuple[Params, torch.Tensor, int]:
    """``n_copies`` shrunk, offset copies of the ``mask`` rows; a source is
    removed only when all its copies found a slot (capacity guard).
    Freed slots become available at the next event."""
    p = state.params
    new_svec_raw = inv_act(rcfg.svec_act)(svec / shrink)
    m = active.shape[0]
    placed = mask
    n = 0
    for i in range(n_copies):
        off = _split_offsets(p["qvec"], svec,
                             _normals(noise, i, svec.shape, generator,
                                      svec.device))
        cand = {**p, "mean": p["mean"] + off, "svec": new_svec_raw}
        targets, n_i = _free_slot_targets(active, mask)
        params, active = _scatter_new(params, active, cand, targets)
        n += n_i
        placed = placed & (targets < m)
    return params, active & ~placed, n


@torch.no_grad()
def densify_clone_split(state: SceneState, opt: AdamState,
                        cfg: DensifyConfig, rcfg: RenderConfig,
                        generator: Optional[torch.Generator] = None,
                        legacy: bool = True, noise: Optional[List] = None):
    """Legacy or official clone + split.

    legacy: grads = accum / (cnt + 1e-5), ``>`` threshold; split if ANY
    scale > thresh; 2 copies with svec / (2 shrink).  official: grads =
    accum / cnt (0 where cnt = 0), ``>=``; split if the MAX scale >
    thresh; ``n_splits`` copies with svec / (n_splits shrink).  Both remove
    the split source."""
    p = state.params
    svec = act(rcfg.svec_act)(p["svec"])
    if legacy:
        grads = state.grad_accum / (state.grad_cnt + 1e-5)
        big = torch.any(svec > cfg.split_thresh, dim=-1)
        n_copies, shrink = 2, cfg.split_shrink * 2.0
        hot = state.active & (grads > cfg.mean2d_thresh)
    else:
        grads = torch.where(state.grad_cnt > 0,
                            state.grad_accum / state.grad_cnt,
                            torch.zeros_like(state.grad_accum))
        big = torch.amax(svec, dim=-1) > cfg.split_thresh
        n_copies, shrink = cfg.n_splits, cfg.n_splits * cfg.split_shrink
        hot = state.active & (grads >= cfg.mean2d_thresh)

    targets, n_clone = _free_slot_targets(state.active, hot & ~big)
    params, active = _scatter_new(p, state.active, p, targets)
    params, active, n_split = _split_copies(
        state, params, active, hot & big, svec, n_copies, shrink, rcfg,
        generator, noise)
    state, opt = _finish(state, opt, params, active)
    return state, opt, {"num_clone": n_clone, "num_split": n_split}


@torch.no_grad()
def densify_compactness(state: SceneState, opt: AdamState,
                        cfg: DensifyConfig, rcfg: RenderConfig,
                        K: Optional[int] = None, shrink_svec: float = 1.0):
    """Fill gaps toward the K nearest live neighbours: for each (Gaussian,
    neighbour) pair whose surfaces leave a gap, a new isotropic Gaussian
    at the gap's midpoint with radius gap / 6.  ``shrink_svec > 1`` first
    shrinks every scale, and the shrink persists (as in the reference)."""
    K = K or cfg.K
    p = state.params
    svec = act(rcfg.svec_act)(p["svec"]) / shrink_svec
    params = {**p, "svec": inv_act(rcfg.svec_act)(svec)}
    active = state.active
    mean, qvec = p["mean"], p["qvec"]

    _, idx = knn_self(mean, K, mask=state.active)
    n_new = 0
    for k in range(K):
        nn = idx[:, k].long()
        nn_pos = mean[nn]
        d_nn = distance_to_gaussian_surface(nn_pos, svec[nn], qvec[nn], mean)
        d_self = distance_to_gaussian_surface(mean, svec, qvec, nn_pos)
        dist = torch.linalg.norm(nn_pos - mean, dim=-1)
        gap_ok = state.active & ((d_self + d_nn) < dist)
        direction = (nn_pos - mean) / torch.clamp(dist[:, None], min=1e-10)
        new_mean = mean + direction * ((dist + d_self - d_nn) / 2.0)[:, None]
        gap = dist - d_self - d_nn
        new_svec = inv_act(rcfg.svec_act)(
            torch.clamp(gap, min=1e-6)[:, None] / 6.0
            * torch.ones(1, 3, device=mean.device))
        cand = {**p, "mean": new_mean, "svec": new_svec}
        targets, n_k = _free_slot_targets(active, gap_ok)
        params, active = _scatter_new(params, active, cand, targets)
        n_new += n_k
    state, opt = _finish(state, opt, params, active)
    return state, opt, {"num_compact": n_new}


@torch.no_grad()
def densify_by_scale(state: SceneState, opt: AdamState, cfg: DensifyConfig,
                     rcfg: RenderConfig,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[List] = None):
    """Split every live Gaussian with a scale above ``scale_max`` into
    ``n_splits`` copies."""
    svec = act(rcfg.svec_act)(state.params["svec"])
    mask = state.active & torch.any(svec > cfg.scale_max, dim=-1)
    params, active, n = _split_copies(
        state, state.params, state.active, mask, svec, cfg.n_splits,
        cfg.n_splits * cfg.split_shrink, rcfg, generator, noise)
    state, opt = _finish(state, opt, params, active)
    return state, opt, {"num_split": n}


def reset_densify_stats(state: SceneState) -> SceneState:
    z = torch.zeros_like(state.grad_accum)
    return dataclasses.replace(state, grad_accum=z, grad_cnt=z.clone())


def densify(state: SceneState, opt: AdamState, cfg: DensifyConfig,
            rcfg: RenderConfig, generator: Optional[torch.Generator] = None,
            noise: Optional[List] = None
            ) -> Tuple[SceneState, AdamState, Dict[str, int]]:
    """One densification event (the JAX package's dispatch); the caller
    runs it only on trigger steps (:func:`should_run`)."""
    split = dict(generator=generator, noise=noise)
    if cfg.use_legacy:
        state, opt, info = densify_clone_split(state, opt, cfg, rcfg,
                                               legacy=True, **split)
        if "shrink_then_compatness" in cfg.type:
            state, opt, i2 = densify_compactness(
                state, opt, cfg, rcfg, shrink_svec=cfg.surface_shrink)
            info.update(i2)
        elif "compatness" in cfg.type:
            state, opt, i2 = densify_compactness(state, opt, cfg, rcfg)
            info.update(i2)
    elif cfg.type == "official":
        state, opt, info = densify_clone_split(state, opt, cfg, rcfg,
                                               legacy=False, **split)
    elif cfg.type == "scale":
        state, opt, info = densify_by_scale(state, opt, cfg, rcfg, **split)
    elif cfg.type == "compatness":
        state, opt, info = densify_compactness(state, opt, cfg, rcfg)
    elif cfg.type == "shrink_then_compatness":
        state, opt, info = densify_compactness(
            state, opt, cfg, rcfg, shrink_svec=cfg.surface_shrink)
    elif cfg.type == "all":
        # split every live Gaussian in two
        allcfg = dataclasses.replace(cfg, scale_max=-1.0, n_splits=2)
        state, opt, info = densify_by_scale(state, opt, allcfg, rcfg,
                                            **split)
    else:
        raise NotImplementedError(f"densify type {cfg.type}")
    return reset_densify_stats(state), opt, info


@torch.no_grad()
def prune(state: SceneState, opt: AdamState, cfg: PruneConfig,
          rcfg: RenderConfig, radii2d_thresh: float, alpha_thresh: float
          ) -> Tuple[SceneState, AdamState, Dict[str, int]]:
    """One prune event; the thresholds are the host's ``C()`` values."""
    alpha = act(rcfg.alpha_act)(state.params["alpha"])
    svec = act(rcfg.svec_act)(state.params["svec"])
    kill = torch.zeros_like(state.active)
    counts = dict(num_pruned_radii2d=0, num_pruned_alpha=0,
                  num_pruned_svec=0)
    for name, on, m in (
            ("num_pruned_radii2d", cfg.radii2d_thresh > 0.0,
             lambda: state.max_radii2d > radii2d_thresh),
            ("num_pruned_alpha", cfg.alpha_thresh > 0.0,
             lambda: alpha < alpha_thresh),
            ("num_pruned_svec", cfg.radii3d_thresh > 0.0,
             lambda: torch.all(svec > cfg.radii3d_thresh, dim=-1))):
        if on:
            hit = state.active & m()
            counts[name] = int(hit.sum())
            kill = kill | hit
    active = state.active & ~kill
    opt = mask_state_rows(opt, active)
    return dataclasses.replace(state, active=active), opt, counts
