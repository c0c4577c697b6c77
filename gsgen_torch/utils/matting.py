"""Background matting for image-to-3D inputs.

The JAX package's ``utils/matting.py``, copied into the port (numpy only;
the port imports nothing of the JAX package).  The reference preprocesses
image-to-3D inputs with rembg (utils/background_removal.py in
gsgen3d/gsgen); without its weights, this is a classical matte for an
object shot against a roughly uniform backdrop:

1. the backdrop's colour from the image border (median, MAD scale),
2. each pixel's scaled distance to it,
3. Otsu's threshold on that distance,
4. only backdrop connected to the border stays backdrop (flood fill),
5. a small separable box blur feathers the edge.
"""

from __future__ import annotations

import numpy as np


def _otsu(values: np.ndarray, bins: int = 256) -> float:
    """Otsu's threshold over a 1-D sample."""
    hist, edges = np.histogram(values, bins=bins)
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return float(edges[len(edges) // 2])
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = total - w0
    m0 = np.cumsum(hist * centers) / np.maximum(w0, 1e-12)
    m1 = (np.cumsum((hist * centers)[::-1])[::-1]
          / np.maximum(w1, 1e-12))
    between = w0 * w1 * (m0 - m1) ** 2
    k = int(np.nanargmax(between[:-1]))
    return float(centers[k])


def _flood_border(bg_candidate: np.ndarray) -> np.ndarray:
    """Mask of candidate-background pixels connected to the border
    (iterative 4-neighbour dilation — vectorized BFS)."""
    reach = np.zeros_like(bg_candidate)
    reach[0, :] = bg_candidate[0, :]
    reach[-1, :] = bg_candidate[-1, :]
    reach[:, 0] = bg_candidate[:, 0]
    reach[:, -1] = bg_candidate[:, -1]
    while True:
        grown = reach.copy()
        grown[1:, :] |= reach[:-1, :]
        grown[:-1, :] |= reach[1:, :]
        grown[:, 1:] |= reach[:, :-1]
        grown[:, :-1] |= reach[:, 1:]
        grown &= bg_candidate
        if (grown == reach).all():
            return reach
        reach = grown


def _box_blur(x: np.ndarray, r: int) -> np.ndarray:
    """Separable box blur with edge padding (feathering)."""
    if r <= 0:
        return x
    k = 2 * r + 1
    pad = np.pad(x, ((r, r), (0, 0)), mode="edge")
    c = np.cumsum(pad, axis=0)
    x = (c[k - 1:] - np.concatenate(
        [np.zeros((1,) + c.shape[1:]), c[:-k]], axis=0)) / k
    pad = np.pad(x, ((0, 0), (r, r)), mode="edge")
    c = np.cumsum(pad, axis=1)
    x = (c[:, k - 1:] - np.concatenate(
        [np.zeros(c.shape[:1] + (1,) + c.shape[2:]), c[:, :-k]],
        axis=1)) / k
    return x


def estimate_alpha(rgb: np.ndarray, border_frac: float = 0.04,
                   feather: int = 2) -> np.ndarray:
    """Foreground alpha [H, W] in [0, 1] for an object shot against a
    roughly uniform backdrop.  ``rgb`` is [H, W, 3] float in [0, 1]."""
    rgb = np.asarray(rgb, np.float64)
    H, W = rgb.shape[:2]
    b = max(1, int(round(min(H, W) * border_frac)))
    border = np.concatenate([
        rgb[:b].reshape(-1, 3), rgb[-b:].reshape(-1, 3),
        rgb[:, :b].reshape(-1, 3), rgb[:, -b:].reshape(-1, 3)])
    mu = np.median(border, axis=0)
    # robust per-channel scale (MAD); floor avoids zero-variance walls
    sig = np.median(np.abs(border - mu), axis=0) * 1.4826 + 0.02
    dist = np.sqrt(np.sum(((rgb - mu) / sig) ** 2, axis=-1))
    thr = _otsu(dist.ravel())
    bg_candidate = dist <= thr
    bg = _flood_border(bg_candidate)
    alpha = 1.0 - bg.astype(np.float64)
    return np.clip(_box_blur(alpha, feather), 0.0, 1.0).astype(np.float32)


def ensure_rgba(img: np.ndarray) -> np.ndarray:
    """[H,W,3] or [H,W,4] float in [0,1] -> [H,W,4]: pass RGBA through,
    matte RGB via :func:`estimate_alpha` (the reference expects inputs
    pre-matted by utils/background_removal.py; this is the in-repo
    fallback for backdrop shots)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[-1] == 4:
        return img
    assert img.ndim == 3 and img.shape[-1] == 3, img.shape
    alpha = estimate_alpha(img)
    return np.concatenate([img, alpha[..., None]], axis=-1)
