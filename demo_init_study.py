#!/usr/bin/env python3
"""How much the reconstruction demo's orbit PSNR depends on its start.

Runs ``gsgen_torch.tools.demo_recon.main`` (the 400-step recipe, on the
card) from three kinds of initial scene, all on the JAX demo's target:

* the stored init (the JAX demo's own, ``demo_recon.INIT_FILE``), with and
  without the recipe's densify / prune events;
* the Trainer's own draws (its generator on the card) at ``--seeds``;
* draws from a CPU generator at the same seeds, moved to the card.

Prints one line a run, then the card's name and power limit and a JSON
summary.  Needs a CUDA device.

    python3 demo_init_study.py [--seeds 7] [--steps 400]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    import gsgen_torch.tools.demo_recon as demo
    from gsgen_torch.models.init import initialize

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=7)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()

    stored = demo.Trainer
    start = {}

    class Started(stored):
        """The demo's Trainer from the start ``start`` names."""

        def __init__(self, init_raw=None, **kw):
            kind = start["kind"]
            if kind == "stored":
                super().__init__(init_raw=init_raw, **kw)
                return
            kw["cfg"] = dataclasses.replace(kw["cfg"], seed=start["seed"])
            super().__init__(**kw)
            if kind == "cpu":
                gen = torch.Generator().manual_seed(start["seed"])
                scene = initialize(kw["init_cfg"], self.rcfg, gen, "cpu")
                moved = {f.name: getattr(scene, f.name)
                         for f in dataclasses.fields(scene)}
                moved = {k: ({p: t.to(self.device) for p, t in v.items()}
                             if isinstance(v, dict) else v.to(self.device))
                         for k, v in moved.items()}
                self.state = dataclasses.replace(
                    self.state, scene=dataclasses.replace(scene, **moved))

    demo.Trainer = Started
    runs = []

    def run(kind, seed=None, density=True):
        start.update(kind=kind, seed=seed)
        saved = Started.density_step
        if not density:
            Started.density_step = lambda self, step: {}
        try:
            t0 = time.perf_counter()
            psnr = demo.main("/dev/null", steps=args.steps, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            Started.density_step = saved
        runs.append(dict(start=kind, seed=seed, density=density,
                         psnr_db=psnr, s=secs))
        print(f"run: start {kind} seed {seed} density {density}: orbit "
              f"PSNR {psnr:.3f} dB in {secs:.1f} s", flush=True)

    run("stored")
    run("stored", density=False)
    for seed in range(args.seeds):
        run("trainer", seed)
    for seed in range(args.seeds):
        run("cpu", seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"steps": args.steps, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
