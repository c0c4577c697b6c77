"""Tile binning: AABB footprint -> duplication -> lexicographic sort.

Port of the JAX package's ``ops/binning.py``, both layouts.  Every field
of :class:`BinnedTiles` the port keeps equals the JAX package's bit for
bit, so the port keeps its int32 arithmetic, its saturating float->int
casts, its ``mode="drop"`` scatters and its stable (tile, depth-bits)
sort order:

* duplicate slots come from the vectorized repeat ``gid[d] = #(cum <=
  d)`` (kernel K3, :mod:`.expansion_rank`) with a static capacity
  ``cap``; slots past ``cap`` are dropped and ``total`` records the
  demand;
* padded layout: each tile's segment starts at a multiple of ``chunk``,
  so a tile owns whole chunks of the duplicate table and of its gradient
  buffer; ``padded_gid`` is built by kernel K4 (:mod:`.gid_repack`);
* compact layout: no padding; tile ``t`` owns rows ``[starts[t],
  ends[t])`` of the sorted table ``gid_s`` and the kernels (K8, K9) walk
  the ``chunk``-aligned windows covering them, masking the rows of
  neighbouring tiles.

Everything here is index math without gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .expansion_rank import expansion_gid
from .gid_repack import repack_gid
from .oracle import ALPHA_CLAMP, MIN_RENDER_ALPHA
from .projection import conic_from_cov2d

_I32 = torch.int32
_INT_MAX = 2 ** 31 - 1
_INT_MIN = -2 ** 31


class BinnedTiles(NamedTuple):
    """Static-shape tile binning result (field meanings as in the JAX
    package's ``BinnedTiles``).  The padded layout fills the first eight
    fields; the compact layout fills ``starts``, ``ends`` (unaligned),
    ``total``, ``gid_cum``, ``padded_total`` (= ``total``) and ``gid_s``,
    and leaves ``padded_gid``, ``row_valid`` and ``chunk_tile`` None.

    Not ported, because no kernel of the port reads them: ``step_tile`` /
    ``step_window``, the TPU's sequential (tile, window) grid of the
    compact backward (K9 runs one block per tile), and ``vjp_gid`` /
    ``vjp_pos``, the maps of the TPU's sort-based gradient aggregation,
    which the port replaces by the gather's own backward."""

    padded_gid: Optional[torch.Tensor]  # [cap_padded] int32, sentinel N
    row_valid: Optional[torch.Tensor]   # [cap_padded] bool
    starts: torch.Tensor        # [n_tiles] int32 (padded: chunk-aligned)
    ends: torch.Tensor          # [n_tiles] int32
    total: torch.Tensor         # [] int32 duplicate demand before the cap
    gid_cum: torch.Tensor       # [N] int32 surviving-count cumsum
    chunk_tile: Optional[torch.Tensor]  # [cap_padded // chunk] owning tile
    padded_total: torch.Tensor  # [] int32 padded demand
    gid_s: Optional[torch.Tensor] = None  # compact: [cap] sorted ids,
                                          # sentinel N at rows >= total


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with XLA's semantics: truncate toward zero,
    saturate out-of-range values, NaN -> 0 (a plain ``.to(int32)`` is
    undefined out of range)."""
    big = x >= 2147483648.0
    small = x < -2147483648.0
    nan = torch.isnan(x)
    safe = torch.where(big | small | nan, torch.zeros_like(x), x)
    out = safe.to(_I32)
    out = torch.where(big, torch.full_like(out, _INT_MAX), out)
    return torch.where(small, torch.full_like(out, _INT_MIN), out)


def _drop_scatter_max(size: int, idx: torch.Tensor, val: torch.Tensor
                      ) -> torch.Tensor:
    """``zeros(size).at[idx].max(val, mode="drop")`` for int32."""
    buf = torch.zeros(size, dtype=_I32, device=idx.device)
    keep = (idx >= 0) & (idx < size)
    return buf.scatter_reduce(0, idx[keep].long(), val[keep], "amax",
                              include_self=True)


def tile_aabbs(mean2d, cov2d, fx, fy, cx, cy, w: int, h: int,
               tile_size: int, tile_culling_radius: float = 6.0,
               pixel_offset_y: int = 0, alpha=None):
    """Per-Gaussian inclusive tile-space AABB (tl_x, tl_y, br_x, br_y) and
    the overlap mask.

    Pixel bounds are computed in the full image's coordinates and a slab's
    row offset ``pixel_offset_y`` is subtracted after the int32 truncation
    (rounding before the shift would move a Gaussian into another tile
    row), so a Gaussian lands in the same tile row of a full render and of
    its tile-sharded slab.

    Half extents bound the ellipse ``{radial <= D}`` of the CONIC the
    rasterizer evaluates; with ``alpha``, D tightens to the exact support
    ``2 ln(255 a_cl)`` of the ``a·G < 1/255`` cut.  A footprint entirely
    outside the image is dropped, not clamped into edge tiles.
    """
    dev = mean2d.device
    D = torch.tensor(tile_culling_radius, dtype=torch.float32, device=dev)
    dropped = None
    if alpha is not None:
        a_cl = torch.clamp(alpha, max=ALPHA_CLAMP)
        D = torch.minimum(
            D, 2.0 * torch.log(torch.clamp(a_cl, min=1e-12)
                               / MIN_RENDER_ALPHA))
        dropped = D < 0.0
    conic, _ = conic_from_cov2d(cov2d)
    ca, cb, cc = conic[..., 0], conic[..., 1], conic[..., 2]
    detc = ca * cc - cb * cb
    detc = torch.maximum(detc, 1e-7 * (torch.abs(ca * cc) + cb * cb) + 1e-38)
    hx = torch.sqrt(torch.clamp(D * cc / detc, min=0.0))
    hy = torch.sqrt(torch.clamp(D * ca / detc, min=0.0))
    tl_px = _f32_to_i32((mean2d[..., 0] - hx) * fx + cx)
    tl_py = _f32_to_i32((mean2d[..., 1] - hy) * fy + cy)
    br_px = _f32_to_i32((mean2d[..., 0] + hx) * fx + cx)
    br_py = _f32_to_i32((mean2d[..., 1] + hy) * fy + cy)
    if pixel_offset_y:
        # saturating, as the casts are: a bound saturated at INT_MIN would
        # wrap to a large positive row and drop the Gaussian from the slab
        # (the JAX package wraps here)
        tl_py, br_py = (torch.clamp(v.to(torch.int64) - pixel_offset_y,
                                    _INT_MIN, _INT_MAX).to(_I32)
                        for v in (tl_py, br_py))
    overlaps = ((br_px >= 0) & (tl_px <= w - 1)
                & (br_py >= 0) & (tl_py <= h - 1))
    if dropped is not None:
        overlaps = overlaps & ~dropped
    tl_x = torch.clamp(tl_px, 0, w - 1) // tile_size
    tl_y = torch.clamp(tl_py, 0, h - 1) // tile_size
    br_x = torch.clamp(br_px, 0, w - 1) // tile_size
    br_y = torch.clamp(br_py, 0, h - 1) // tile_size
    return tl_x, tl_y, br_x, br_y, overlaps


def bin_gaussians(mean2d, cov2d, depth, active, fx, fy, cx, cy,
                  w: int, h: int, tile_size: int, cap: int,
                  chunk: int = 256, tile_culling_radius: float = 6.0,
                  pixel_offset_y: int = 0, alpha=None, pad_budget=None,
                  layout: str = "padded") -> BinnedTiles:
    """Bin Gaussians into depth-sorted per-tile segments: chunk-aligned
    copies (``layout="padded"``) or the sorted table as it is
    (``layout="compact"``).  ``h`` and ``pixel_offset_y`` select a slab of
    rows ``[pixel_offset_y, pixel_offset_y + h)`` of the full camera."""
    if layout not in ("padded", "compact"):
        raise ValueError(f"binning layout {layout}")
    dev = mean2d.device
    n_tiles_w = -(-w // tile_size)
    n_tiles_h = -(-h // tile_size)
    n_tiles = n_tiles_w * n_tiles_h
    if pad_budget is None:
        pad_budget = n_tiles * chunk
    if pad_budget % chunk != 0:
        raise ValueError("pad_budget must be a multiple of chunk")
    if n_tiles_w > 1023 or n_tiles_h > 1023:
        raise ValueError("geo bit-packing supports tile grids up to 1023 "
                         "per side")
    if cap > 1 << 20:
        raise ValueError("fp32 floor-division margin requires dup cap "
                         "<= 2^20")
    cap_padded = cap + pad_budget
    n = mean2d.shape[0]

    tl_x, tl_y, br_x, br_y, overlaps = tile_aabbs(
        mean2d, cov2d, fx, fy, cx, cy, w, h, tile_size, tile_culling_radius,
        pixel_offset_y, alpha=alpha)
    width = br_x - tl_x + 1
    height = br_y - tl_y + 1
    counts = torch.where(active & overlaps, width * height,
                         torch.zeros_like(width)).to(_I32)

    cum = torch.cumsum(counts, 0, dtype=_I32)
    total = cum[-1] if n else torch.zeros((), dtype=_I32, device=dev)
    cum_excl = torch.cat([torch.zeros(1, dtype=_I32, device=dev), cum[:-1]])

    d = torch.arange(cap, dtype=_I32, device=dev)
    gid = expansion_gid(cum, cap)
    slot_valid = d < total
    gid_safe = torch.clamp(gid, 0, n - 1)

    # width / tl_x / tl_y ride bit-packed in one int32 (10 bits each)
    geo = width | (tl_x << 10) | (tl_y << 20)
    dbits = depth.to(torch.float32).contiguous().view(_I32)
    table = torch.stack([cum_excl, geo, dbits], dim=1)       # [N, 3]
    rows = table[gid_safe.long()]
    local = d - rows[:, 0]
    pg = rows[:, 1]
    gw = pg & 1023
    # dy = local // gw by fp32: (local + 0.5) / gw floors exactly for
    # |local| <= 2^19 (margin argument in the JAX package)
    dy = _f32_to_i32(torch.floor(
        (local.to(torch.float32) + 0.5) / gw.to(torch.float32)))
    dx = local - dy * gw
    tile = ((((pg >> 20) & 1023) + dy) * n_tiles_w
            + ((pg >> 10) & 1023) + dx)

    # stable sort by (tile, order-preserving depth bits), invalid slots to
    # the sentinel tile: one int64 key, high word tile, low word depth
    sbits = rows[:, 2]
    depth_key = sbits ^ ((sbits >> 31) & 0x7FFFFFFF)
    tile_key = torch.where(slot_valid, tile,
                           torch.full_like(tile, n_tiles)).to(_I32)
    depth_key = torch.where(slot_valid, depth_key,
                            torch.full_like(depth_key, 0x7F800000))
    key = tile_key.to(torch.int64) * (1 << 32) + (
        depth_key.to(torch.int64) + (1 << 31))
    _, order = torch.sort(key, stable=True)
    tile_s = tile_key[order]
    gid_s = gid_safe[order]

    tix = torch.arange(n_tiles + 1, dtype=_I32, device=dev)
    edges = torch.searchsorted(tile_s, tix, right=False).to(_I32)
    start_c = edges[:-1]
    end_c = edges[1:]
    seg_len = end_c - start_c

    gid_cum = torch.minimum(cum, torch.minimum(
        torch.tensor(cap, dtype=_I32, device=dev), total))
    if layout == "compact":
        # rows past the demand gather the sentinel (zero) row
        gid_sent = torch.where(d < total, gid_s,
                               torch.full_like(gid_s, n)).to(_I32)
        return BinnedTiles(padded_gid=None, row_valid=None, starts=start_c,
                           ends=end_c, total=total, gid_cum=gid_cum,
                           chunk_tile=None, padded_total=total,
                           gid_s=gid_sent)

    # chunk-aligned layout, clamped to cap_padded (padded_total records the
    # demand when the padding budget overflows)
    aligned_len = ((seg_len + chunk - 1) // chunk) * chunk
    aligned_start = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                               torch.cumsum(aligned_len, 0, dtype=_I32)[:-1]])
    padded_total = aligned_start[-1] + aligned_len[-1]
    starts = torch.clamp(aligned_start, max=cap_padded)
    ends = torch.clamp(aligned_start + seg_len, max=cap_padded)

    # owning tile per chunk slot: scatter-max of each tile's id at its first
    # slot (overflowing tiles dropped) + cummax fill
    n_slots = cap_padded // chunk
    n_slots_c = -(-cap_padded // chunk)
    tid = torch.arange(n_tiles, dtype=_I32, device=dev)
    slot_of_tile = torch.where(aligned_start < cap_padded,
                               aligned_start // chunk,
                               torch.full_like(aligned_start, n_slots_c))
    chunk_tile_c = torch.cummax(
        _drop_scatter_max(n_slots_c, slot_of_tile, tid), 0).values
    chunk_tile = chunk_tile_c[:n_slots]

    end_chunk = ends[torch.clamp(chunk_tile_c, 0, n_tiles - 1).long()]
    row = (torch.arange(chunk, dtype=_I32, device=dev)[None, :]
           + torch.arange(n_slots_c, dtype=_I32, device=dev)[:, None] * chunk)
    row_valid = (row < end_chunk[:, None]).reshape(-1)[:cap_padded]

    offset_t = aligned_start - start_c
    padded_gid = repack_gid(gid_s, chunk_tile, offset_t, ends, cap_padded,
                            chunk, n)
    return BinnedTiles(padded_gid=padded_gid, row_valid=row_valid,
                       starts=starts, ends=ends, total=total,
                       gid_cum=gid_cum, chunk_tile=chunk_tile,
                       padded_total=padded_total)
