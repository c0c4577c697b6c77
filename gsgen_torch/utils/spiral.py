"""Eval camera paths: fixed-elevation orbits and random eval poses.

Port of the JAX package's ``utils/spiral.py`` (numpy on both sides).
"""

from __future__ import annotations

import numpy as np

from ..data.cameras import c2w_from_up_and_look_at

UP = np.array([0.0, 0.0, 1.0])
ORIGIN = np.zeros(3)


def camera_path_fixed_elevation(n_frames: int, n_circles: int = 1,
                                camera_distance: float = 2.0,
                                elevation: float = 45.0) -> np.ndarray:
    """[n_frames, 3, 4] orbit c2ws."""
    azimuth = np.linspace(0, 2 * np.pi * n_circles, n_frames)
    er = np.deg2rad(elevation)
    pos = np.stack([camera_distance * np.cos(azimuth) * np.cos(er),
                    camera_distance * np.sin(azimuth) * np.cos(er),
                    camera_distance * np.sin(er) * np.ones_like(azimuth)], 1)
    return np.stack([c2w_from_up_and_look_at(UP, ORIGIN, p) for p in pos])


def random_pose_fixed_elevation(rng: np.random.Generator,
                                camera_distance: float = 2.0,
                                elevation: float = 45.0) -> np.ndarray:
    """One c2w at a random azimuth and a fixed elevation."""
    ar = rng.random() * 2 * np.pi
    er = np.deg2rad(elevation)
    pos = np.array([camera_distance * np.cos(ar) * np.cos(er),
                    camera_distance * np.sin(ar) * np.cos(er),
                    camera_distance * np.sin(er)])
    return c2w_from_up_and_look_at(UP, ORIGIN, pos)
