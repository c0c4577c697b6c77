"""Relight a trained scene with an orbiting point light.

Port of the JAX package's ``tools/relight.py`` (reference utils/relight.py
in gsgen3d/gsgen): estimate per-Gaussian surface normals from the point
cloud, modulate the learned albedo by the Blinn half-vector term for each
light position, and render a fixed-camera video with the shaded colours
substituted for the colour field.

The means do not move between frames, so the normals (a KNN plane fit
over the live means: :func:`..models.scene.scene_normals`) and the albedo
are computed once per call, where the JAX package recomputes them inside
every frame; the frames are the same.

Usage: python -m gsgen_torch.tools.relight <ckpt> [--frames 30]
           [--out relight.mp4] [--device cuda]
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.cameras import c2w_from_up_and_look_at
from ..models.scene import RenderConfig, SceneState, render_view, scene_normals
from ..ops.camera import CameraIntrinsics
from ..utils.activations import act, inv_act


def relight_colors(mean: torch.Tensor, normal: torch.Tensor,
                   albedo: torch.Tensor, light_pos: torch.Tensor,
                   light_color: torch.Tensor, cam_pos: torch.Tensor
                   ) -> torch.Tensor:
    """``light_color * |<bisector(L-x, C-x), n>| * albedo`` with backface
    culling via abs (reference utils/relight.py:13-18 compute_color)."""
    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-8)
    bisector = unit(unit(light_pos[None] - mean) + unit(cam_pos[None] - mean))
    dot = torch.clamp(torch.abs(torch.sum(bisector * normal, dim=-1)),
                      0.0, 1.0)
    return light_color[None] * dot[:, None] * albedo


def _shaded_params(params: Dict[str, torch.Tensor], normal, albedo,
                   cfg: RenderConfig, light_pos, light_color, cam_pos
                   ) -> Dict[str, torch.Tensor]:
    """The params with the colour field swapped for the relit colour,
    through the inverse activation (the reference passes ``overrides=
    {"color": ...}`` to its renderer)."""
    shaded = relight_colors(params["mean"], normal, albedo, light_pos,
                            light_color, cam_pos)
    raw = inv_act(cfg.color_act)(torch.clamp(shaded, 1e-4, 1.0 - 1e-4))
    return {**params, "color": raw}


@torch.no_grad()
def relight_frames(state: SceneState, cfg: RenderConfig,
                   n_frames: int = 30, reso: int = 512,
                   camera_pos=(3.0, 0.0, 1.0),
                   light_radius: float = 3.0, light_z: float = 3.0,
                   light_color=(1.0, 1.0, 1.0)) -> np.ndarray:
    """[n_frames, reso, reso, 3] float frames: fixed camera, orbiting
    light (reference utils/relight.py:22-72 relight_video), rendered on
    the device of the scene."""
    if cfg.sh_degree > 0:
        raise ValueError("relight needs per-Gaussian RGB (sh_degree=0)")
    params = state.params
    dev = params["mean"].device
    intr = CameraIntrinsics.from_reso(reso)
    c2w = torch.as_tensor(c2w_from_up_and_look_at(
        np.array([0.0, 0.0, 1.0]), np.zeros(3),
        np.asarray(camera_pos, np.float64)), device=dev)
    lcol = torch.tensor(light_color, dtype=torch.float32, device=dev)
    normal = scene_normals(params, state.active, cfg)
    albedo = act(cfg.color_act)(params["color"])
    bg = torch.zeros(3, device=dev)
    frames = []
    for a in np.linspace(0, 2 * np.pi, n_frames):
        lp = torch.tensor([np.cos(a) * light_radius,
                           np.sin(a) * light_radius, light_z],
                          dtype=torch.float32, device=dev)
        p = _shaded_params(params, normal, albedo, cfg, lp, lcol, c2w[:3, 3])
        out = render_view(p, state.active, c2w, intr, cfg, bg,
                          rgb_only=True)
        frames.append(torch.clamp(out["rgb"], 0.0, 1.0).cpu().numpy())
    return np.stack(frames)


def main(argv=None):
    import argparse

    from ..config import build_trainer, load_config
    from ..io.logging import write_video

    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--config", default="configs/base.yaml")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--reso", type=int, default=512)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = build_trainer(load_config(args.config), device=args.device)
    step = trainer.load(args.ckpt)
    print(f"loaded step {step}")
    frames = relight_frames(trainer.state.scene, trainer.rcfg,
                            n_frames=args.frames, reso=args.reso)
    out = write_video(args.out or "relight.mp4", frames, fps=10)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
