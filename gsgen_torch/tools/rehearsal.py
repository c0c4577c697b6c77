"""Real-weight end-to-end rehearsal: the reference's
``python main.py --config-name=base prompt.prompt='a corgi'`` moment
(reference main.py:10-33), wired to run on SD 2.1 weights from a local
diffusers directory.

Port of the JAX package's ``tools/rehearsal.py``.

Usage (real weights):
    python -m gsgen_torch.tools.rehearsal \\
        --sd /assets/stable-diffusion-2-1-base \\
        --clip /assets/clip-vit-large-patch14 \\
        --prompt "a corgi" --steps 50 --out runs/rehearsal

``--sd`` is a diffusers-layout dir (unet/ + vae/ safetensors); --clip a
CLIP text-encoder dir in the transformers layout (text_encoder/ +
tokenizer/, or both in one directory; the port reads the tokenizer files
itself, prompt/tokenizer_files.py; without --clip the prompt goes through
base.yaml's encoder).  ``--mock``
runs the same code path (config assembly -> SDS guidance -> train steps
-> eval image) on the tiny random-weight preset.  ``--device`` defaults
to the card.

Assertions: every loss finite, gradient norms finite and nonzero (the
gradient over every optimizer leaf, recovered from Adam's first moments:
``g = (mu_t - 0.9 mu_{t-1}) / 0.1``), a live Gaussian count; writes eval
images (PNG) and a scalars.jsonl to --out.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch


def build_rehearsal_config(prompt: str, steps: int, sd_path=None,
                           clip_path=None, mock: bool = False,
                           reso: int = 512, num_points: int = 4096,
                           capacity: int = 65536, batch_size: int = 4,
                           dtype: str = "bfloat16"):
    """Assemble the production config (configs/base.yaml semantics) with
    real or mock score-network weights."""
    from ..config import load_config
    overrides = [
        f"trainer.max_steps={steps}",
        f"trainer.batch_size={batch_size}",
        f"init.num_points={num_points}",
        f"init.capacity={capacity}",
        f"data.reso=[{reso}]",
        "renderer.chunk=128",
    ]
    cfg = load_config(Path(__file__).parents[2] / "configs" / "base.yaml",
                      overrides)
    cfg["prompt"]["prompt"] = prompt
    g = cfg["guidance"]
    if mock:
        # same guidance class + SDS math, tiny random-weight UNet
        g["backbone"] = "sd_unet"
        g["backbone_preset"] = "tiny"
    else:
        assert sd_path, "--sd required (or --mock)"
        g["backbone"] = "sd_unet"
        g["backbone_preset"] = "sd21"
        g["weights_path"] = str(sd_path)
        g["backbone_dtype"] = dtype
        if clip_path:
            cfg["prompt"]["model_id"] = str(clip_path)
    return cfg


def _grad_norm(mu_before, mu_after, b1: float = 0.9) -> float:
    """The step's gradient norm over every optimizer leaf, from the Adam
    first moments around it (``mu_t = b1 mu_{t-1} + (1 - b1) g``)."""
    sq = sum(float(torch.sum(((mu_after[k] - b1 * mu_before[k])
                              / (1.0 - b1)) ** 2))
             for k in mu_after if k in mu_before
             and mu_before[k].shape == mu_after[k].shape)
    return math.sqrt(sq)


def run(cfg, out_dir, eval_every: int = 25, eval_reso: int = 256,
        log=print, device="cuda"):
    from ..config import build_trainer
    from ..io.logging import write_png
    from ..ops.camera import CameraIntrinsics
    from ..training.evaluation import eval_image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    trainer = build_trainer(cfg, device=device)
    steps = cfg["trainer"]["max_steps"]

    losses = []
    with (out_dir / "scalars.jsonl").open("w") as scalars_f:
        for s in range(steps):
            mu0 = trainer.state.opt.mu
            m = trainer.train_step(s)
            gnorm = _grad_norm(mu0, trainer.state.opt.mu)
            trainer.density_step(s)
            loss = float(m["loss_total"])
            losses.append(loss)
            assert np.isfinite(loss), f"non-finite loss at step {s}: {loss}"
            assert np.isfinite(gnorm), f"non-finite grad norm at step {s}"
            assert gnorm > 0.0, f"zero grad norm at step {s}"
            n_gauss = int(trainer.state.scene.active.sum())
            assert n_gauss > 0, f"no live Gaussian at step {s}"
            scalars_f.write(json.dumps(
                {"step": s, "loss": loss, "grad_norm": gnorm,
                 "n_gauss": n_gauss}) + "\n")
            if s % 10 == 0:
                log(f"step {s:5d} | loss {loss:.5f}")
            if eval_every and (s + 1) % eval_every == 0:
                img = eval_image(trainer.state.scene,
                                 CameraIntrinsics.from_reso(eval_reso),
                                 trainer.rcfg, np.random.default_rng(s))
                write_png(out_dir / f"eval_{s + 1:05d}.png", img)
    log(f"rehearsal done: {steps} steps, final loss {losses[-1]:.5f}, "
        f"outputs in {out_dir}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sd", default=None,
                    help="diffusers-layout SD-2.1 dir (unet/ + vae/)")
    ap.add_argument("--clip", default=None,
                    help="transformers CLIP text-encoder dir")
    ap.add_argument("--prompt", default="a corgi")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reso", type=int, default=512)
    ap.add_argument("--out", default="runs/rehearsal")
    ap.add_argument("--mock", action="store_true",
                    help="tiny random-weight backbone (smoke test)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = build_rehearsal_config(args.prompt, args.steps, args.sd,
                                 args.clip, mock=args.mock, reso=args.reso)
    run(cfg, args.out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
