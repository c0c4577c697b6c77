"""Camera pose sampling for training.

Host-side numpy port of the reference ``CameraPoseProvider``
(data/__init__.py:32-307 in gsgen3d/gsgen) and of the image-to-3D
``SingleViewCameraPoseProvider`` (data/sit3d.py:8-41), copied verbatim
from the JAX package's ``data/cameras.py``: the same seed gives the same
cameras in both packages.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.camera import CameraIntrinsics


def c2w_from_up_and_look_at(up, look_at, pos):
    """OpenCV-convention [3,4] camera-to-world (data/__init__.py:14-29)."""
    up = up / np.linalg.norm(up)
    z = look_at - pos
    z = z / np.linalg.norm(z)
    y = -up
    x = np.cross(y, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.zeros([3, 4], dtype=np.float32)
    c2w[:3, 0] = x
    c2w[:3, 1] = y
    c2w[:3, 2] = z
    c2w[:3, 3] = pos
    return c2w


@dataclasses.dataclass
class CameraSamplerConfig:
    """Defaults mirror conf/base.yaml:62-92."""

    batch_size: int = 4
    max_steps: int = 15000
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    center_aug_std: float = 0.05
    azimuth: Tuple[float, float] = (-180.0, 180.0)
    azimuth_warmup: float = 0.0
    elevation: Tuple[float, float] = (-20.0, 90.0)
    elevation_warmup: float = 0.0
    elevation_real_uniform: bool = True
    camera_distance: Tuple[float, float] = (2.5, 2.5)
    focal: Sequence = (0.75, 1.35)          # relative focal range(s)
    focal_milestones: Optional[List[int]] = None
    reso: Sequence[int] = (512,)
    reso_milestones: Sequence[int] = ()
    near_plane: float = 0.01
    far_plane: float = 100.0
    stratified_on_azimuth: bool = True
    light_sample: str = "dreamfusion"
    light_distance_range: Tuple[float, float] = (2.5, 3.5)
    light_aug_std: float = 0.3


class CameraPoseProvider:
    """Infinite sampler of training camera batches."""

    def __init__(self, cfg: CameraSamplerConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.step = 0
        self.up = np.array([0.0, 0.0, 1.0])
        self.reso_milestones = [-1] + list(cfg.reso_milestones)
        focal = list(cfg.focal)
        if not isinstance(focal[0], (list, tuple)):
            focal = [focal]
        self.focal = focal
        self.focal_milestones = [-1] + list(cfg.focal_milestones or [])
        assert len(self.reso_milestones) == len(cfg.reso)
        assert len(self.focal_milestones) == len(self.focal)
        self._bin_idx = 0

    def update(self, step: int):
        self.step = step

    # -- curriculum bounds (data/__init__.py:83-120) --
    @property
    def reso(self) -> int:
        return self.cfg.reso[bisect.bisect(self.reso_milestones, self.step) - 1]

    def _warmed(self, bound, warmup):
        s = min(self.step / (warmup * self.cfg.max_steps + 1e-5), 1.0)
        return [bound[0] * s, bound[1] * s]

    @property
    def azimuth_bound(self):
        return self._warmed(self.cfg.azimuth, self.cfg.azimuth_warmup)

    @property
    def elevation_bound(self):
        return self._warmed(self.cfg.elevation, self.cfg.elevation_warmup)

    @property
    def focal_bound(self):
        return self.focal[bisect.bisect(self.focal_milestones, self.step) - 1]

    def next_reso_change(self, step: int):
        """(milestone_step, reso_after) of the NEXT curriculum switch
        after ``step``, or None — lets the trainer compile the next
        resolution's executable ahead of the milestone (round-4 c2f
        soak: each un-prewarmed reso switch stalled ~30 s)."""
        i = bisect.bisect(self.reso_milestones, step)
        if i >= len(self.reso_milestones):
            return None
        return self.reso_milestones[i], self.cfg.reso[i]

    def intrinsics(self, reso: Optional[int] = None) -> CameraIntrinsics:
        """Static intrinsics for the current curriculum resolution; the
        actual per-sample focal jitter is passed as dynamic scalars."""
        reso = reso or self.reso
        f = float(np.mean(self.focal_bound)) * reso
        return CameraIntrinsics(fx=f, fy=f, cx=reso / 2.0, cy=reso / 2.0,
                                w=reso, h=reso, near=self.cfg.near_plane,
                                far=self.cfg.far_plane)

    def _sample_azimuth(self) -> float:
        lo, hi = self.azimuth_bound
        if self.cfg.stratified_on_azimuth:
            # round-robin bins across consecutive samples (data/__init__.py:96-106)
            bs = self.cfg.batch_size
            self._bin_idx = (self._bin_idx + 1) % bs
            bins = np.linspace(lo, hi, bs + 1)
            lo, hi = bins[self._bin_idx], bins[self._bin_idx + 1]
        return self.rng.uniform(lo, hi)

    def _sample_elevation(self) -> float:
        lo, hi = self.elevation_bound
        if self.cfg.elevation_real_uniform:
            # uniform on the sphere between elevation bounds (:155-170)
            p0, p1 = (lo + 90.0) / 180.0, (hi + 90.0) / 180.0
            return float(np.rad2deg(np.arcsin(
                2.0 * (self.rng.random() * (p1 - p0) + p0) - 1.0)))
        return self.rng.uniform(lo, hi)

    def sample_one(self) -> dict:
        """One pose sample (data/__init__.py:151-230)."""
        reso = self.reso
        dist = self.rng.uniform(*self.cfg.camera_distance)
        elevation = self._sample_elevation()
        azimuth = self._sample_azimuth()
        er, ar = np.deg2rad(elevation), np.deg2rad(azimuth)
        pos = np.array([dist * np.cos(er) * np.cos(ar),
                        dist * np.cos(er) * np.sin(ar),
                        dist * np.sin(er)])
        center = np.asarray(self.cfg.center) + \
            self.rng.standard_normal(3) * self.cfg.center_aug_std
        c2w = c2w_from_up_and_look_at(self.up, center, pos)
        focal = self.rng.uniform(*self.focal_bound) * reso

        light_dist = self.rng.uniform(*self.cfg.light_distance_range)
        light_dir = pos + self.rng.standard_normal(3) * self.cfg.light_aug_std
        light_dir /= np.linalg.norm(light_dir)
        return dict(c2w=c2w, fx=focal, fy=focal, cx=reso / 2.0, cy=reso / 2.0,
                    elevation=elevation, azimuth=azimuth, camera_distance=dist,
                    light_pos=(light_dir * light_dist).astype(np.float32),
                    light_color=np.ones(3, np.float32))

    def get_batch(self, batch_size: Optional[int] = None) -> dict:
        """Stacked numpy batch of ``bs`` pose samples."""
        bs = batch_size or self.cfg.batch_size
        samples = [self.sample_one() for _ in range(bs)]
        return {k: np.stack([np.asarray(s[k], np.float32) for s in samples])
                for k in samples[0]}


class SingleViewCameraPoseProvider(CameraPoseProvider):
    """Image-to-3D sampler: the canonical front view with probability
    ``original_view_prob`` (at the mean focal, no centre jitter), else a
    random view; every sample carries ``is_original`` (1.0 or 0.0)."""

    def __init__(self, cfg: CameraSamplerConfig, seed: int = 0,
                 original_view_prob: float = 0.5,
                 original_elevation: float = 0.0,
                 original_azimuth: float = 0.0,
                 original_distance: float = 2.5):
        super().__init__(cfg, seed)
        self.original_view_prob = original_view_prob
        self.original = (original_elevation, original_azimuth,
                         original_distance)

    def sample_one(self) -> dict:
        if self.rng.random() < self.original_view_prob:
            elevation, azimuth, dist = self.original
            reso = self.reso
            er, ar = np.deg2rad(elevation), np.deg2rad(azimuth)
            pos = np.array([dist * np.cos(er) * np.cos(ar),
                            dist * np.cos(er) * np.sin(ar),
                            dist * np.sin(er)])
            c2w = c2w_from_up_and_look_at(
                self.up, np.asarray(self.cfg.center, dtype=np.float64), pos)
            focal = float(np.mean(self.focal_bound)) * reso
            return dict(c2w=c2w, fx=focal, fy=focal, cx=reso / 2.0,
                        cy=reso / 2.0, elevation=elevation, azimuth=azimuth,
                        camera_distance=dist,
                        light_pos=(pos.astype(np.float32)
                                   / np.linalg.norm(pos) * 3.0),
                        light_color=np.ones(3, np.float32), is_original=1.0)
        out = super().sample_one()
        out["is_original"] = 0.0
        return out
