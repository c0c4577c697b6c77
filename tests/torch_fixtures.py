"""Shared numpy inputs for the gsgen_torch parity tests.

Every input is drawn with numpy from a seed and handed to both packages,
so the tests never compare random streams.
"""

import numpy as np
import torch

RES = 32
TILE = 8
CHUNK = 128
FX = RES / 2.0


def scene2d(n, seed=0, spread=0.6, cov_scale=0.02, F=5, alpha=None):
    """Screen-space scene: mean2d [n,2], cov2d [n,2,2] (SPD), alpha [n],
    feats [n,F], depth [n] — float32 numpy."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform(-spread, spread, (n, 2))
    A = rng.standard_normal((n, 2, 2)) * cov_scale
    cov2d = A @ np.swapaxes(A, 1, 2) + 1e-4 * np.eye(2)
    a = rng.uniform(0.2, 1.0, n) if alpha is None else np.full(n, alpha)
    feats = rng.uniform(0.0, 1.0, (n, F))
    depth = rng.uniform(1.0, 4.0, n)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(mean2d), f32(cov2d), f32(a), f32(feats), f32(depth)


def conic_np(cov2d):
    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    return np.stack([cov2d[:, 1, 1] / det, -cov2d[:, 0, 1] / det,
                     cov2d[:, 0, 0] / det], axis=-1).astype(np.float32)


def scene3d(n, seed=0, capacity=None, mean_std=0.5, svec=0.05):
    """Raw (pre-activation) 3D scene fields as numpy, capacity-padded
    like make_scene: mean, qvec, svec (log), color (logit), alpha
    (logit), active."""
    rng = np.random.default_rng(seed)
    m = capacity or n
    mean = np.zeros((m, 3), np.float32)
    mean[:n] = rng.standard_normal((n, 3)) * mean_std
    qvec = np.zeros((m, 4), np.float32)
    qvec[:, 0] = 1.0
    qvec[:n] = rng.standard_normal((n, 4))
    s = np.full((m, 3), np.log(1e-4), np.float32)
    s[:n] = np.log(svec * rng.uniform(0.5, 1.5, (n, 3)))
    color = np.zeros((m, 3), np.float32)
    color[:n] = rng.standard_normal((n, 3))
    alpha = np.full(m, -10.0, np.float32)
    alpha[:n] = rng.uniform(-1.0, 2.0, n)
    active = np.arange(m) < n
    return dict(mean=mean, qvec=qvec, svec=s.astype(np.float32),
                color=color, alpha=alpha.astype(np.float32), active=active)


def t(x):
    """numpy -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def poison_padding(dup, row_valid, seed):
    """dup with every sentinel slot (row_valid False) overwritten by rows
    that would contribute if walked: alpha 0.9, means inside the test
    image, a conic about a pixel wide, features in [0, 1]."""
    rng = np.random.default_rng(seed)
    bad = ~row_valid
    m = int(bad.sum())
    rows = np.concatenate([
        rng.uniform(-1.0, 1.0, (2, m)),
        np.stack([np.full(m, 200.0), rng.uniform(-20.0, 20.0, m),
                  np.full(m, 200.0)]),
        np.full((1, m), 0.9), rng.uniform(0.0, 1.0, (10, m))])
    out = dup.clone()
    out[:, bad] = t(rows.astype(np.float32)).to(dup.device)
    return out
