"""End-to-end visual demo and quality gate: multi-view 3D reconstruction.

Port of the JAX package's ``tools/demo_recon.py``.  Optimizes a random
Gaussian blob against the photometric scene-mode mock guidance toward a
known target (three stacked RGB spheres) through the full production
training loop: the render kernels, per-field Adam, the fixed background,
and the densify and prune events of the recipe (every 100 steps from 100
to ``steps - 100``; the JAX ``main`` configures them but never calls
``density_step``, so there they do not fire).  Writes an orbit-strip
image (target / init / final rows) and returns the orbit PSNR against
the target; the recipe's 400 steps must reach 29.0 dB on the card.

``main`` starts from the JAX demo's own initial scene and target draws,
stored in :data:`INIT_FILE` (``tests/test_torch_tools.py`` writes it and
holds it to the JAX package), so the gate compares the same
optimisation in both packages and not two random streams: over other
initial draws the recipe ends anywhere between about 26 and 30 dB, in
either package.  ``main`` also runs under PyTorch's deterministic
algorithms, so the gate gives one number on a card, as the JAX one does
on its chip: the scatter of the per-slot gradients otherwise adds in
launch order, and over 400 steps with density events that order alone
moves the end PSNR by about half a dB from run to run.

Run:  python -m gsgen_torch.tools.demo_recon [out.png] [--steps 400]
          [--device cuda]
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.cameras import CameraSamplerConfig
from ..guidance.mock import MockGuidance
from ..models.background import BackgroundConfig
from ..models.density import DensifyConfig, PruneConfig
from ..models.init import InitConfig
from ..models.scene import RenderConfig, render_view
from ..ops.camera import CameraIntrinsics
from ..training.trainer import Trainer, TrainerConfig
from ..utils.activations import inv_act
from ..utils.spiral import camera_path_fixed_elevation

# the JAX demo's initial raw fields (its 1024 live rows) and target draws
INIT_FILE = Path(__file__).with_name("demo_recon_init.npz")
CENTERS = [(-0.0, 0.0, -0.45), (0.0, 0.0, 0.1), (0.0, 0.0, 0.5)]
RADII = [0.42, 0.3, 0.2]
COLORS = [(0.85, 0.15, 0.15), (0.15, 0.8, 0.2), (0.2, 0.3, 0.9)]


def build_target(generator: Optional[torch.Generator] = None,
                 n_per: int = 1500, directions=None, device="cuda"
                 ) -> Dict[str, torch.Tensor]:
    """Three stacked spheres (red / green / blue), surface-sampled: raw
    params on ``device``.  ``directions`` [3, n_per, 3] (unnormalized)
    replaces the draws, which otherwise come from ``generator`` (a CPU
    generator seeded 0 by default), ``n_per`` normals a sphere."""
    gen = generator or torch.Generator().manual_seed(0)
    means, cols = [], []
    for i, (c, r, col) in enumerate(zip(CENTERS, RADII, COLORS)):
        d = (torch.from_numpy(np.array(directions[i], np.float32))
             if directions is not None else
             torch.randn((n_per, 3), generator=gen, device=gen.device).cpu())
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        means.append(torch.tensor(c) + r * d)
        cols.append(torch.tensor(col).repeat(d.shape[0], 1))
    n = sum(m.shape[0] for m in means)
    logit = inv_act("sigmoid")
    qvec = torch.zeros((n, 4))
    qvec[:, 0] = 1.0
    params = dict(
        mean=torch.cat(means),
        qvec=qvec,
        svec=torch.full((n, 3), float(np.log(np.float32(0.025)))),
        color=logit(torch.clamp(torch.cat(cols), 1e-3, 1 - 1e-3)),
        alpha=torch.full((n,), float(logit(torch.tensor(0.85)))))
    return {k: v.to(torch.float32).to(device) for k, v in params.items()}


@torch.no_grad()
def orbit_strip(params, active, rcfg: RenderConfig, reso: int = 96,
                n: int = 6, distance: float = 2.2,
                elevation: float = 15.0) -> np.ndarray:
    """[reso, n * reso, 3] orbit frames on white, side by side."""
    dev = params["mean"].device
    intr = CameraIntrinsics.from_reso(reso)
    c2ws = camera_path_fixed_elevation(n, 1, distance, elevation)
    bg = torch.ones(3, device=dev)
    frames = []
    for c2w in c2ws:
        out = render_view(params, active,
                          torch.as_tensor(c2w, dtype=torch.float32,
                                          device=dev),
                          intr, rcfg, bg, rgb_only=True)
        frames.append(np.clip(out["rgb"].cpu().numpy(), 0, 1))
    return np.concatenate(frames, axis=1)


def main(out_path: str = "docs/demo_recon.png", steps: int = 400,
         device="cuda") -> float:
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _run(out_path, steps, device)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _run(out_path: str, steps: int, device) -> float:
    from ..io.logging import write_png

    with np.load(INIT_FILE) as z:
        init = dict(z)
    rcfg = RenderConfig(dup_cap=1 << 16, chunk=128)
    target = build_target(directions=init.pop("directions"), device=device)
    t_active = torch.ones(target["mean"].shape[0], dtype=torch.bool,
                          device=device)

    reso = 64
    intr = CameraIntrinsics.from_reso(reso)
    guidance = MockGuidance(mode="scene", target_scene=target,
                            target_active=t_active, intr=intr, rcfg=rcfg)
    tcfg = TrainerConfig(
        max_steps=steps, batch_size=4,
        lr=dict(mean=0.02, svec=0.01, qvec=0.003, color=0.1, alpha=0.05,
                bg=0.003))
    trainer = Trainer(
        cfg=tcfg, rcfg=rcfg,
        init_cfg=InitConfig(num_points=1024, capacity=16384, svec_val=0.06,
                            mean_std=0.5),
        bg_cfg=BackgroundConfig(type="fixed", color=(1.0, 1.0, 1.0)),
        data_cfg=CameraSamplerConfig(
            batch_size=4, max_steps=steps, reso=(reso,),
            camera_distance=(2.0, 2.4)),
        guidance=guidance,
        dcfg=DensifyConfig(enabled=True, warm_up=100, end=steps - 100,
                           period=100, mean2d_thresh=2e-4,
                           split_thresh=0.04),
        pcfg=PruneConfig(enabled=True, warm_up=100, end=steps - 100,
                         period=100, alpha_thresh=0.02),
        init_raw=init, device=device,
    )

    init_strip = orbit_strip(trainer.state.scene.params,
                             trainer.state.scene.active, rcfg)
    for s in range(steps):
        m = trainer.train_step(s)
        trainer.density_step(s)
        if s % 50 == 0 or s == steps - 1:
            print(f"step {s:4d}  loss {float(m['loss_total']):.5f}")

    final_strip = orbit_strip(trainer.state.scene.params,
                              trainer.state.scene.active, rcfg)
    target_strip = orbit_strip(target, t_active, rcfg)

    mse = float(np.mean((final_strip - target_strip) ** 2))
    psnr = -10.0 * np.log10(mse + 1e-12)
    print(f"orbit PSNR vs target: {psnr:.2f} dB")

    strip = np.concatenate([target_strip, init_strip, final_strip], axis=0)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    write_png(out_path, strip)
    print(f"wrote {out_path} (rows: target / init / final)")
    return psnr


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="docs/demo_recon.png")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, a.steps, a.device)
