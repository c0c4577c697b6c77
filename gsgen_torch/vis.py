"""Serve a trained checkpoint in the web viewer (reference vis.py).

The port's counterpart of the root ``vis.py``: builds the config's
trainer on ``--device`` (the card by default), loads the checkpoint of
either package into it and serves the scene with
:class:`.io.viewer.SceneViewer`.

Usage: python -m gsgen_torch.vis <ckpt_dir_or_step_dir> [--port 8090]
           [--config configs/base.yaml] [--device cuda]
"""

import argparse


def main(argv=None, blocking: bool = True):
    """Returns the viewer (serving in a thread when not ``blocking``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--config", default="configs/base.yaml")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .config import build_trainer, load_config
    from .io.viewer import SceneViewer

    trainer = build_trainer(load_config(args.config), device=args.device)
    step = trainer.load(args.ckpt)
    print(f"loaded step {step}", flush=True)
    viewer = SceneViewer(trainer.state.scene, trainer.rcfg, port=args.port)
    viewer.update_state(trainer.state.scene, step=step)
    viewer.serve(blocking=blocking)
    return viewer


if __name__ == "__main__":
    main()
