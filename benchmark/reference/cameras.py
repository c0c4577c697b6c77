"""gsgen's training camera sampler (data/__init__.py:32-230 in
gsgen3d/gsgen), in numpy, for one resolution and one focal range: the
same seed and the same keys give the same poses as the program's sampler,
draw for draw (the light draws included, though no light is used)."""

from __future__ import annotations

from typing import Dict

import numpy as np

DEFAULTS = dict(batch_size=4, max_steps=15000, center=(0.0, 0.0, 0.0),
                center_aug_std=0.05, azimuth=(-180.0, 180.0),
                azimuth_warmup=0.0, elevation=(-20.0, 90.0),
                elevation_warmup=0.0, elevation_real_uniform=True,
                camera_distance=(2.5, 2.5), focal=(0.75, 1.35), reso=(512,),
                near_plane=0.01, far_plane=100.0, stratified_on_azimuth=True,
                light_distance_range=(2.5, 3.5), light_aug_std=0.3)


def c2w_look_at(up, look_at, pos):
    up = up / np.linalg.norm(up)
    z = look_at - pos
    z = z / np.linalg.norm(z)
    x = np.cross(-up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.zeros([3, 4], dtype=np.float32)
    c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3] = x, y, z, pos
    return c2w


class Cameras:
    def __init__(self, data: Dict, seed: int):
        c = dict(DEFAULTS)
        c.update(data)
        if len(c["reso"]) != 1 or c.get("reso_milestones"):
            raise ValueError("the reference samples one resolution")
        self.c = c
        self.rng = np.random.default_rng(seed)
        self.step = 0
        self._bin = 0

    @property
    def reso(self) -> int:
        return int(self.c["reso"][0])

    @property
    def focal_static(self) -> float:
        return float(np.mean(self.c["focal"])) * self.reso

    def _warm(self, bound, warmup):
        s = min(self.step / (warmup * self.c["max_steps"] + 1e-5), 1.0)
        return bound[0] * s, bound[1] * s

    def _one(self):
        c, rng, reso = self.c, self.rng, self.reso
        dist = rng.uniform(*c["camera_distance"])
        lo, hi = self._warm(c["elevation"], c["elevation_warmup"])
        if c["elevation_real_uniform"]:
            p0, p1 = (lo + 90.0) / 180.0, (hi + 90.0) / 180.0
            elev = float(np.rad2deg(np.arcsin(
                2.0 * (rng.random() * (p1 - p0) + p0) - 1.0)))
        else:
            elev = rng.uniform(lo, hi)
        lo, hi = self._warm(c["azimuth"], c["azimuth_warmup"])
        if c["stratified_on_azimuth"]:
            bs = c["batch_size"]
            self._bin = (self._bin + 1) % bs
            bins = np.linspace(lo, hi, bs + 1)
            lo, hi = bins[self._bin], bins[self._bin + 1]
        azim = rng.uniform(lo, hi)
        er, ar = np.deg2rad(elev), np.deg2rad(azim)
        pos = np.array([dist * np.cos(er) * np.cos(ar),
                        dist * np.cos(er) * np.sin(ar), dist * np.sin(er)])
        center = (np.asarray(c["center"])
                  + rng.standard_normal(3) * c["center_aug_std"])
        c2w = c2w_look_at(np.array([0.0, 0.0, 1.0]), center, pos)
        focal = rng.uniform(*c["focal"]) * reso
        rng.uniform(*c["light_distance_range"])
        rng.standard_normal(3)
        return dict(c2w=c2w, fx=focal, fy=focal, cx=reso / 2.0,
                    cy=reso / 2.0, elevation=elev, azimuth=azim,
                    camera_distance=dist)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        self.step = step
        views = [self._one() for _ in range(self.c["batch_size"])]
        return {k: np.stack([np.asarray(v[k], np.float32) for v in views])
                for k in views[0]}
