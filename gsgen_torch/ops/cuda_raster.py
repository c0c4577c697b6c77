"""Tile compositing through the hand-written CUDA kernels K1, K2, K8, K9.

Counterpart of the JAX package's ``ops/pallas_raster.py``.  One
``torch.autograd.Function``, :class:`RasterCore`, carries the contract of
``rasterize_tiles_pallas`` in either binning layout:

* padded: forward K1 (``raster_fwd``, ``csrc/raster_fwd.cu``, replacing
  ``_fwd_kernel``), backward K2 (``raster_bwd``, ``csrc/raster_bwd.cu``,
  replacing both ``_bwd_kernel_v2`` and ``_bwd_kernel``);
* compact: forward K8 (``raster_fwd_compact``, the same kernel as K1,
  replacing ``_fwd_kernel(compact=True)``), backward K9
  (``raster_bwd_compact``, the same kernel as K2, replacing
  ``_bwd_kernel_v3``).

Each of the four has its own C entry and launch counter, so a run shows
which layout it went through.

Kernel layouts are kept:

  dup  [16, cap]             rows: mx my ca cb cc alpha f0..f9
  out  [n_tiles, ch_out, P]  F features, T, processed chunk/window count
  grad [16, cap]             same rows as dup

Design decisions against the TPU kernels:

* both kernels composite each pixel by the exact sequential scan;
  ``fast_fwd_cumprod`` and ``mxu_scans`` (matrix-unit approximations of
  the cumprod/cumsum) are accepted and ignored;
* one backward kernel serves both TPU call conditions: the resident
  budget that picks between them is a VMEM limit with no Hopper meaning;
* the two layouts share one walk: tile t walks ``counts[t]``
  chunk-aligned windows from ``floor(starts[t] / chunk) * chunk`` and
  only the lanes of its own rows ``[starts[t], ends[t])``.  In the padded
  layout the walk ends at ``ends[t]``: the sentinel rows past it (alpha 0,
  no contribution, zero gradient) are never read;
* K9 runs one block per tile, not the TPU's sequential (tile, window)
  grid: tiles own disjoint rows, so blocks sharing a boundary window
  store disjoint lanes of a zero-filled buffer;
* per-Gaussian gradients aggregate through the duplicate gather's own
  backward, an accumulating index add (``index_select``'s gradient),
  instead of the sort + cumsum aggregation (``_pack_seg_bwd``) that
  works around the TPU's serial scatter.

Hopper design of the kernels (``csrc/raster_common.cuh``): windows arrive
by bulk copy (``cp.async.bulk``, one per row, completing on an
``mbarrier``) into a ring of two shared-memory stages, the next window in
flight while the block composites this one; the forward reads four lanes
of a geometry row with one 16-byte load; the backward sums each lane's
6+F gradient values over a warp's 32 pixels with one transpose-reduce
(16 shuffles).  :func:`smem_bytes` is their shared-memory footprint.

Each wrapper takes its plain version (:mod:`.rasterize`) only for CPU
tensors; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib
from .binning import BinnedTiles
from .oracle import DEFAULT_T_THRESH
from .rasterize import ch_out_for, composite_tiles, make_geom, unpack_tiles

D_ROWS = 16
MAX_F = D_ROWS - 6
# shared memory a block may opt into on Hopper (227 KB), less the ring's
# two mbarriers in static shared memory
SMEM_OPTIN = 232448 - 16


def smem_bytes(chunk: int, F: int, P: int, backward: bool) -> int:
    """Dynamic shared memory of K1/K8 (forward) or K2/K9 (backward): the
    ring of two [6+F, chunk] stages, and for the backward the warps' lane
    sums [P/32, 32, 17]."""
    ring = 2 * (6 + F) * chunk
    return 4 * (ring + (P // 32) * 32 * 17 if backward else ring)


def pack_dup(mean2d, conic, alpha, feats, gid, valid) -> torch.Tensor:
    """Gather per-duplicate rows into the [16, cap] kernel layout.

    One [N + 8, 16] table (the 8 zero rows are the sentinel block: padding
    slots carry id N and gather zeros, alpha 0 = no contribution) and one
    row gather.  Differentiable: the gather's backward is an accumulating
    index add onto the table rows.
    """
    F = feats.shape[-1]
    if F > MAX_F:
        raise ValueError(f"at most {MAX_F} feature channels, got {F}")
    n = mean2d.shape[0]
    dev = mean2d.device
    table = torch.cat([mean2d, conic, alpha[:, None], feats,
                       torch.zeros(n, D_ROWS - 6 - F, device=dev)], dim=1)
    table = torch.cat([table, torch.zeros(8, D_ROWS, device=dev)], dim=0)
    gid = torch.where(valid, torch.clamp(gid, max=n),
                      torch.full_like(gid, n))
    return table.index_select(0, gid.long()).T.contiguous()


def raster_fwd_plain(dup, starts, ends, counts, geom, *, n_tiles_w,
                     tile_size, chunk, F, ch_out, T_thresh):
    """Plain version of K1 and K8 (no autograd): tile t walks ``counts[t]``
    windows and composites only its rows ``[starts[t], ends[t])``."""
    with torch.no_grad():
        return composite_tiles(dup, starts, ends, counts, geom,
                               n_tiles_w=n_tiles_w, tile_size=tile_size,
                               chunk=chunk, F=F, ch_out=ch_out,
                               T_thresh=T_thresh)


def raster_bwd_plain(dup, out, g, starts, ends, counts, geom, *, n_tiles_w,
                     tile_size, chunk, F, ch_out, T_thresh):
    """Plain version of K2 and K9: autograd of the plain forward,
    recomputed.  A row of a compact window two tiles share gets both
    tiles' terms, one of them exactly zero.  (``out`` is unused.)"""
    with torch.enable_grad():
        d = dup.detach().requires_grad_(True)
        o = composite_tiles(d, starts, ends, counts, geom,
                            n_tiles_w=n_tiles_w, tile_size=tile_size,
                            chunk=chunk, F=F, ch_out=ch_out,
                            T_thresh=T_thresh)
        (grad,) = torch.autograd.grad(o, d, g, allow_unused=True)
    return torch.zeros_like(dup) if grad is None else grad


def _check_launch(dup, starts, ends, counts, geom, st, backward):
    cuda_lib.check(dup, "dup", torch.float32, 2)
    for name, x in (("starts", starts), ("ends", ends), ("counts", counts)):
        cuda_lib.check(x, name, torch.int32, 1)
        if x.shape != starts.shape:
            raise ValueError("starts, ends and counts must have one shape")
    cuda_lib.check(geom, "geom", torch.float32, 1)
    chunk, F, P = st["chunk"], st["F"], st["tile_size"] ** 2
    if dup.shape[0] != D_ROWS or dup.shape[1] % chunk != 0:
        raise ValueError(f"dup must be [16, k*{chunk}], got "
                         f"{tuple(dup.shape)}")
    # the stage ring's bulk copies move 16-byte aligned rows
    if chunk % 4 != 0 or dup.data_ptr() % 16 != 0:
        raise ValueError(f"chunk {chunk} must be a multiple of 4 and dup "
                         "16-byte aligned")
    if P % 32 != 0 or P > 1024:
        raise ValueError(f"tile_size {st['tile_size']}: P must be a multiple "
                         "of 32 and at most 1024")
    if F > MAX_F or st["ch_out"] != ch_out_for(F):
        raise ValueError(f"F={F}, ch_out={st['ch_out']} unsupported")
    if smem_bytes(chunk, F, P, backward) > SMEM_OPTIN:
        raise ValueError(f"chunk {chunk}: the stage ring needs more shared "
                         "memory than a block has")


def _launch_fwd(wrapper, entry, dup, starts, ends, counts, geom, st):
    if dup.device.type == "cpu":
        return raster_fwd_plain(dup, starts, ends, counts, geom, **st)
    _check_launch(dup, starts, ends, counts, geom, st, False)
    n_tiles = starts.shape[0]
    P = st["tile_size"] ** 2
    out = torch.empty(n_tiles, st["ch_out"], P, dtype=torch.float32,
                      device=dup.device)
    cuda_lib.launch(entry, dup.data_ptr(), dup.shape[1], starts.data_ptr(),
                    ends.data_ptr(), counts.data_ptr(), geom.data_ptr(),
                    out.data_ptr(), n_tiles, st["n_tiles_w"],
                    st["tile_size"], st["chunk"], st["F"], st["ch_out"],
                    float(st["T_thresh"]))
    wrapper.launches += 1
    return out


def _launch_bwd(wrapper, entry, dup, out, g, starts, ends, counts, geom, st):
    if dup.device.type == "cpu":
        return raster_bwd_plain(dup, out, g, starts, ends, counts, geom, **st)
    _check_launch(dup, starts, ends, counts, geom, st, True)
    cuda_lib.check(out, "out", torch.float32, 3)
    cuda_lib.check(g, "g", torch.float32, 3)
    if g.shape != out.shape:
        raise ValueError("g must have the shape of out")
    # padding lanes, a neighbour's lanes and windows the forward skipped
    # stay exactly zero
    grad = torch.zeros_like(dup)
    cuda_lib.launch(entry, dup.data_ptr(), dup.shape[1], out.data_ptr(),
                    g.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                    counts.data_ptr(), geom.data_ptr(), grad.data_ptr(),
                    starts.shape[0], st["n_tiles_w"], st["tile_size"],
                    st["chunk"], st["F"], st["ch_out"],
                    float(st["T_thresh"]))
    wrapper.launches += 1
    return grad


def raster_fwd(dup, starts, ends, nchunks, geom, **st):
    """K1: padded dup [16, cap] -> out [n_tiles, ch_out, P]; tile t walks
    its ``nchunks[t]`` chunks up to ``ends[t]``.  ``st``: n_tiles_w,
    tile_size, chunk, F, ch_out, T_thresh."""
    return _launch_fwd(raster_fwd, "gsgen_raster_fwd", dup, starts, ends,
                       nchunks, geom, st)


def raster_bwd(dup, out, g, starts, ends, nchunks, geom, **st):
    """K2: (padded dup, forward out, its cotangent g) -> grad [16, cap]."""
    return _launch_bwd(raster_bwd, "gsgen_raster_bwd", dup, out, g, starts,
                       ends, nchunks, geom, st)


def raster_fwd_compact(dup, starts, ends, wcount, geom, **st):
    """K8: compact dup [16, cap] -> out [n_tiles, ch_out, P]; the last row
    holds the number of windows each tile processed."""
    return _launch_fwd(raster_fwd_compact, "gsgen_raster_fwd_compact", dup,
                       starts, ends, wcount, geom, st)


def raster_bwd_compact(dup, out, g, starts, ends, wcount, geom, **st):
    """K9: (compact dup, forward out, its cotangent g) -> grad [16, cap]."""
    return _launch_bwd(raster_bwd_compact, "gsgen_raster_bwd_compact", dup,
                       out, g, starts, ends, wcount, geom, st)


raster_fwd.launches = 0
raster_bwd.launches = 0
raster_fwd_compact.launches = 0
raster_bwd_compact.launches = 0


class RasterCore(torch.autograd.Function):
    """dup -> out through K1 (padded) or K8 (compact); the gradient
    through K2 or K9."""

    @staticmethod
    def forward(ctx, dup, starts, ends, counts, geom, statics, compact):
        fwd = raster_fwd_compact if compact else raster_fwd
        out = fwd(dup, starts, ends, counts, geom, **statics)
        ctx.save_for_backward(dup, starts, ends, counts, geom, out)
        ctx.statics, ctx.compact = statics, compact
        return out

    @staticmethod
    def backward(ctx, g):
        dup, starts, ends, counts, geom, out = ctx.saved_tensors
        bwd = raster_bwd_compact if ctx.compact else raster_bwd
        dgrad = bwd(dup, out, g.contiguous(), starts, ends, counts, geom,
                    **ctx.statics)
        return dgrad, None, None, None, None, None, None


def window_counts(starts: torch.Tensor, ends: torch.Tensor, chunk: int
                  ) -> torch.Tensor:
    """Compact layout: K-aligned windows covering each tile's rows,
    ``ceil(end / K) - floor(start / K)`` (1 for an empty tile whose start
    is not a multiple of K)."""
    return ((ends + chunk - 1) // chunk - starts // chunk).to(torch.int32)


def rasterize_tiles_cuda(mean2d, conic, alpha, feats, bins: BinnedTiles,
                         topleft, pixel_size, *, w: int, h: int,
                         tile_size: int, chunk: int,
                         T_thresh: float = DEFAULT_T_THRESH,
                         mxu_scans: bool = False,
                         fast_fwd_cumprod: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``rasterize_tiles_pallas``: the compact layout when
    ``bins.gid_s`` is set, else the padded one.  Returns (img [H, W, F],
    T [H, W]).  ``mxu_scans`` / ``fast_fwd_cumprod`` are accepted and
    ignored: the kernels run the exact scans."""
    del mxu_scans, fast_fwd_cumprod
    F = feats.shape[-1]
    statics = dict(n_tiles_w=-(-w // tile_size), tile_size=tile_size,
                   chunk=chunk, F=F, ch_out=ch_out_for(F),
                   T_thresh=float(T_thresh))
    geom = make_geom(topleft, pixel_size, mean2d.device)
    compact = bins.gid_s is not None
    gid = bins.gid_s if compact else bins.padded_gid
    if gid.shape[0] % chunk != 0:
        raise ValueError("binner capacity must be chunk-aligned")
    starts, ends = bins.starts.contiguous(), bins.ends.contiguous()
    if compact:
        # the sentinel id N already marks the rows past the demand
        dup = pack_dup(mean2d, conic, alpha, feats, gid,
                       torch.ones_like(gid, dtype=torch.bool))
        counts = window_counts(starts, ends, chunk)
    else:
        dup = pack_dup(mean2d, conic, alpha, feats, gid, bins.row_valid)
        counts = ((ends - starts + chunk - 1) // chunk).to(torch.int32)
    out = RasterCore.apply(dup, starts, ends, counts, geom, statics, compact)
    return unpack_tiles(out, F, w, h, tile_size)
