"""Tile compositing through the hand-written CUDA kernels K1, K2, K8, K9.

Counterpart of the JAX package's ``ops/pallas_raster.py``.  Two
``torch.autograd.Function``s carry the contract of
``rasterize_tiles_pallas``, one per binning layout:

* padded: forward K1 (``raster_fwd``, ``csrc/raster_fwd.cu``, replacing
  ``_fwd_kernel``), backward K2 (``raster_bwd``, ``csrc/raster_bwd.cu``,
  replacing both ``_bwd_kernel_v2`` and ``_bwd_kernel``);
* compact: forward K8 (``raster_fwd_compact``, the compact instance in
  ``csrc/raster_fwd.cu``, replacing ``_fwd_kernel(compact=True)``),
  backward K9 (``raster_bwd_compact``, in ``csrc/raster_bwd.cu``,
  replacing ``_bwd_kernel_v3``).

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
* K9 runs one block per tile, not the TPU's sequential (tile, window)
  grid: tiles own disjoint rows, so blocks sharing a boundary window
  store disjoint lanes of a zero-filled buffer;
* per-Gaussian gradients aggregate through the duplicate gather's own
  backward, an accumulating index add (``index_select``'s gradient),
  instead of the sort + cumsum aggregation (``_pack_seg_bwd``) that
  works around the TPU's serial scatter.

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
_SMEM_LIMIT = 48 * 1024     # default dynamic shared memory per block


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


def raster_fwd_plain(dup, starts, nchunks, geom, *, n_tiles_w, tile_size,
                     chunk, F, ch_out, T_thresh):
    """Plain version of K1 (no autograd)."""
    with torch.no_grad():
        return composite_tiles(dup, starts, nchunks, geom,
                               n_tiles_w=n_tiles_w, tile_size=tile_size,
                               chunk=chunk, F=F, ch_out=ch_out,
                               T_thresh=T_thresh)


def raster_bwd_plain(dup, out, g, starts, nchunks, geom, *, n_tiles_w,
                     tile_size, chunk, F, ch_out, T_thresh):
    """Plain version of K2: autograd of the plain forward, recomputed.
    (``out`` is unused: the recomputation reproduces it.)"""
    with torch.enable_grad():
        d = dup.detach().requires_grad_(True)
        o = composite_tiles(d, starts, nchunks, geom, n_tiles_w=n_tiles_w,
                            tile_size=tile_size, chunk=chunk, F=F,
                            ch_out=ch_out, T_thresh=T_thresh)
        (grad,) = torch.autograd.grad(o, d, g, allow_unused=True)
    return torch.zeros_like(dup) if grad is None else grad


def raster_fwd_compact_plain(dup, starts, ends, wcount, geom, *, n_tiles_w,
                             tile_size, chunk, F, ch_out, T_thresh):
    """Plain version of K8 (no autograd)."""
    with torch.no_grad():
        return composite_tiles(dup, starts, wcount, geom,
                               n_tiles_w=n_tiles_w, tile_size=tile_size,
                               chunk=chunk, F=F, ch_out=ch_out,
                               T_thresh=T_thresh, ends=ends)


def raster_bwd_compact_plain(dup, out, g, starts, ends, wcount, geom, *,
                             n_tiles_w, tile_size, chunk, F, ch_out,
                             T_thresh):
    """Plain version of K9: autograd of the plain K8, recomputed.  A row
    of a window two tiles share gets both tiles' terms, one of them
    exactly zero.  (``out`` is unused.)"""
    with torch.enable_grad():
        d = dup.detach().requires_grad_(True)
        o = composite_tiles(d, starts, wcount, geom, n_tiles_w=n_tiles_w,
                            tile_size=tile_size, chunk=chunk, F=F,
                            ch_out=ch_out, T_thresh=T_thresh, ends=ends)
        (grad,) = torch.autograd.grad(o, d, g, allow_unused=True)
    return torch.zeros_like(dup) if grad is None else grad


def _check_launch(dup, starts, nchunks, geom, tile_size, chunk, F, ch_out,
                  ends=None):
    cuda_lib.check(dup, "dup", torch.float32, 2)
    cuda_lib.check(starts, "starts", torch.int32, 1)
    cuda_lib.check(nchunks, "nchunks", torch.int32, 1)
    cuda_lib.check(geom, "geom", torch.float32, 1)
    if ends is not None:
        cuda_lib.check(ends, "ends", torch.int32, 1)
        if ends.shape != starts.shape or nchunks.shape != starts.shape:
            raise ValueError("starts, ends and wcount must have one shape")
    P = tile_size * tile_size
    if dup.shape[0] != D_ROWS or dup.shape[1] % chunk != 0:
        raise ValueError(f"dup must be [16, k*{chunk}], got "
                         f"{tuple(dup.shape)}")
    if P % 32 != 0 or P > 1024:
        raise ValueError(f"tile_size {tile_size}: P must be a multiple of "
                         "32 and at most 1024")
    if F > MAX_F or ch_out != ch_out_for(F):
        raise ValueError(f"F={F}, ch_out={ch_out} unsupported")
    if 4 * (6 + F) * (chunk + P) > _SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} needs more shared memory than a "
                         "block has by default")


def raster_fwd(dup, starts, nchunks, geom, *, n_tiles_w, tile_size, chunk,
               F, ch_out, T_thresh):
    """K1: dup [16, cap] -> out [n_tiles, ch_out, P]."""
    kw = dict(n_tiles_w=n_tiles_w, tile_size=tile_size, chunk=chunk, F=F,
              ch_out=ch_out, T_thresh=T_thresh)
    if dup.device.type == "cpu":
        return raster_fwd_plain(dup, starts, nchunks, geom, **kw)
    _check_launch(dup, starts, nchunks, geom, tile_size, chunk, F, ch_out)
    n_tiles = starts.shape[0]
    P = tile_size * tile_size
    out = torch.empty(n_tiles, ch_out, P, dtype=torch.float32,
                      device=dup.device)
    cuda_lib.launch("gsgen_raster_fwd", dup.data_ptr(), dup.shape[1],
                    starts.data_ptr(), nchunks.data_ptr(),
                    geom.data_ptr(), out.data_ptr(), n_tiles,
                    n_tiles_w, tile_size, chunk, F, ch_out, float(T_thresh))
    raster_fwd.launches += 1
    return out


def raster_bwd(dup, out, g, starts, nchunks, geom, *, n_tiles_w, tile_size,
               chunk, F, ch_out, T_thresh):
    """K2: (dup, forward out, its cotangent g) -> grad [16, cap]."""
    kw = dict(n_tiles_w=n_tiles_w, tile_size=tile_size, chunk=chunk, F=F,
              ch_out=ch_out, T_thresh=T_thresh)
    if dup.device.type == "cpu":
        return raster_bwd_plain(dup, out, g, starts, nchunks, geom, **kw)
    _check_launch(dup, starts, nchunks, geom, tile_size, chunk, F, ch_out)
    cuda_lib.check(out, "out", torch.float32, 3)
    cuda_lib.check(g, "g", torch.float32, 3)
    if g.shape != out.shape:
        raise ValueError("g must have the shape of out")
    # chunks the forward skipped and slots no tile owns stay exactly zero
    grad = torch.zeros_like(dup)
    cuda_lib.launch("gsgen_raster_bwd", dup.data_ptr(), dup.shape[1],
                    out.data_ptr(), g.data_ptr(), starts.data_ptr(),
                    nchunks.data_ptr(), geom.data_ptr(),
                    grad.data_ptr(), starts.shape[0], n_tiles_w,
                    tile_size, chunk, F, ch_out, float(T_thresh))
    raster_bwd.launches += 1
    return grad


def raster_fwd_compact(dup, starts, ends, wcount, geom, *, n_tiles_w,
                       tile_size, chunk, F, ch_out, T_thresh):
    """K8: compact dup [16, cap] -> out [n_tiles, ch_out, P]; the last row
    holds the number of windows each tile processed."""
    kw = dict(n_tiles_w=n_tiles_w, tile_size=tile_size, chunk=chunk, F=F,
              ch_out=ch_out, T_thresh=T_thresh)
    if dup.device.type == "cpu":
        return raster_fwd_compact_plain(dup, starts, ends, wcount, geom, **kw)
    _check_launch(dup, starts, wcount, geom, tile_size, chunk, F, ch_out,
                  ends)
    n_tiles = starts.shape[0]
    P = tile_size * tile_size
    out = torch.empty(n_tiles, ch_out, P, dtype=torch.float32,
                      device=dup.device)
    cuda_lib.launch("gsgen_raster_fwd_compact", dup.data_ptr(), dup.shape[1],
                    starts.data_ptr(), ends.data_ptr(), wcount.data_ptr(),
                    geom.data_ptr(), out.data_ptr(), n_tiles, n_tiles_w,
                    tile_size, chunk, F, ch_out, float(T_thresh))
    raster_fwd_compact.launches += 1
    return out


def raster_bwd_compact(dup, out, g, starts, ends, wcount, geom, *,
                       n_tiles_w, tile_size, chunk, F, ch_out, T_thresh):
    """K9: (compact dup, forward out, its cotangent g) -> grad [16, cap]."""
    kw = dict(n_tiles_w=n_tiles_w, tile_size=tile_size, chunk=chunk, F=F,
              ch_out=ch_out, T_thresh=T_thresh)
    if dup.device.type == "cpu":
        return raster_bwd_compact_plain(dup, out, g, starts, ends, wcount,
                                        geom, **kw)
    _check_launch(dup, starts, wcount, geom, tile_size, chunk, F, ch_out,
                  ends)
    cuda_lib.check(out, "out", torch.float32, 3)
    cuda_lib.check(g, "g", torch.float32, 3)
    if g.shape != out.shape:
        raise ValueError("g must have the shape of out")
    # each block stores only its own rows; the rest (rows past the demand,
    # windows the forward skipped) stays exactly zero
    grad = torch.zeros_like(dup)
    cuda_lib.launch("gsgen_raster_bwd_compact", dup.data_ptr(), dup.shape[1],
                    out.data_ptr(), g.data_ptr(), starts.data_ptr(),
                    ends.data_ptr(), wcount.data_ptr(), geom.data_ptr(),
                    grad.data_ptr(), starts.shape[0], n_tiles_w, tile_size,
                    chunk, F, ch_out, float(T_thresh))
    raster_bwd_compact.launches += 1
    return grad


raster_fwd.launches = 0
raster_bwd.launches = 0
raster_fwd_compact.launches = 0
raster_bwd_compact.launches = 0


class RasterCore(torch.autograd.Function):
    """dup -> out through K1; the gradient through K2."""

    @staticmethod
    def forward(ctx, dup, starts, nchunks, geom, statics):
        out = raster_fwd(dup, starts, nchunks, geom, **statics)
        ctx.save_for_backward(dup, starts, nchunks, geom, out)
        ctx.statics = statics
        return out

    @staticmethod
    def backward(ctx, g):
        dup, starts, nchunks, geom, out = ctx.saved_tensors
        dgrad = raster_bwd(dup, out, g.contiguous(), starts, nchunks, geom,
                           **ctx.statics)
        return dgrad, None, None, None, None


class RasterCoreCompact(torch.autograd.Function):
    """Compact dup -> out through K8; the gradient through K9."""

    @staticmethod
    def forward(ctx, dup, starts, ends, wcount, geom, statics):
        out = raster_fwd_compact(dup, starts, ends, wcount, geom, **statics)
        ctx.save_for_backward(dup, starts, ends, wcount, geom, out)
        ctx.statics = statics
        return out

    @staticmethod
    def backward(ctx, g):
        dup, starts, ends, wcount, geom, out = ctx.saved_tensors
        dgrad = raster_bwd_compact(dup, out, g.contiguous(), starts, ends,
                                   wcount, geom, **ctx.statics)
        return dgrad, None, None, None, None, None


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
    if compact:
        # the sentinel id N already marks the rows past the demand
        dup = pack_dup(mean2d, conic, alpha, feats, gid,
                       torch.ones_like(gid, dtype=torch.bool))
        starts, ends = bins.starts.contiguous(), bins.ends.contiguous()
        out = RasterCoreCompact.apply(dup, starts, ends,
                                      window_counts(starts, ends, chunk),
                                      geom, statics)
    else:
        dup = pack_dup(mean2d, conic, alpha, feats, gid, bins.row_valid)
        nchunks = ((bins.ends - bins.starts + chunk - 1) // chunk).to(
            torch.int32)
        out = RasterCore.apply(dup, bins.starts.contiguous(), nchunks, geom,
                               statics)
    return unpack_tiles(out, F, w, h, tile_size)
