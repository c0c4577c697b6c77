"""Colormaps for eval images (depth / opacity / float channels).

Port of the JAX package's ``utils/colormaps.py`` on numpy alone: the JAX
package reads its maps from matplotlib, the port carries their lookup
tables (:mod:`.colormap_tables`) and indexes them as matplotlib's
``Colormap.__call__`` does for floats: ``floor(x * 256)``, 1.0 on the
last entry, NaN black.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _lut(name: str) -> np.ndarray:
    """[256, 3] float64 table of colormap ``name``."""
    if name == "gray":
        return np.repeat(np.linspace(0.0, 1.0, 256)[:, None], 3, axis=1)
    from . import colormap_tables
    table = getattr(colormap_tables, name.upper(), None)
    if table is None:
        raise ValueError(f"colormap {name!r}: the port has gray, viridis "
                         "and turbo")
    return np.array(table.split(), np.float64).reshape(256, 3)


def apply_float_colormap(x: np.ndarray, colormap: str = "viridis"
                         ) -> np.ndarray:
    """[..., 1] floats in [0, 1] -> [..., 3] rgb."""
    v = np.clip(x[..., 0], 0.0, 1.0) * 256.0
    v[v == 256.0] = 255.0
    bad = np.isnan(v)
    idx = np.where(bad, 0, v).astype(int)
    rgb = _lut(colormap)[idx]
    rgb[bad] = 0.0
    return rgb.astype(np.float32)


def apply_depth_colormap(depth: np.ndarray,
                         accumulation: np.ndarray | None = None,
                         near: float | None = None,
                         far: float | None = None,
                         colormap: str = "turbo") -> np.ndarray:
    """Depth [..., 1] -> rgb, scaled to [near, far] (default: min / max),
    dimmed by ``accumulation`` toward white."""
    near = float(np.min(depth)) if near is None else near
    far = float(np.max(depth)) if far is None else far
    x = np.clip((depth - near) / (far - near + 1e-10), 0, 1)
    img = apply_float_colormap(x, colormap)
    if accumulation is not None:
        img = img * accumulation + (1.0 - accumulation)
    return img


def apply_boolean_colormap(mask: np.ndarray) -> np.ndarray:
    """bool [..., 1] -> white/black rgb."""
    return np.repeat(mask.astype(np.float32), 3, axis=-1)


def eval_image_strip(out: dict) -> np.ndarray:
    """rgb | depth | opacity | z_var strip for train logging."""
    rgb = np.clip(np.asarray(out["rgb"]), 0, 1)
    cols = [rgb]
    if "depth" in out:
        op = np.asarray(out["opacity"])[..., None]
        cols.append(apply_depth_colormap(np.asarray(out["depth"])[..., None],
                                         accumulation=op))
        cols.append(apply_float_colormap(op, "gray"))
    if "z_var" in out:
        zv = np.asarray(out["z_var"])[..., None]
        zv = zv / (zv.max() + 1e-10)
        cols.append(apply_float_colormap(np.clip(zv, 0, 1)))
    return np.concatenate(cols, axis=1)
