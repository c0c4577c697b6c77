"""The check's readings over many seeds: the program, its faults, the
controls.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13 \
        [--faults half_batch unchanged] \
        [--controls unet=tf32,vae=int8 unet=tf32 vae=fp8]

For each seed one JSON line on standard output holds the numbers of
:func:`.check.compare` (each against the exact reference of that seed)
for

* ``program``: the program as it is, through the timed path's calls;
* each fault the kind plants (``half_batch``: half of each batch left out
  of the guidance, the mean taken over the rest; ``unchanged``: a step
  that leaves the state as it found it);
* each control: the reference put in the program's place with the
  networks named computed in a lower precision (``tf32``, ``fp8``,
  ``int8``), the others exact.  ``control`` is the cell's own: every
  network one precision below the one the traffic states (fp32 -> TF32,
  bf16 -> int8).

The limits in ``workloads/<cell>.json`` are set from these readings
(``PERF.md`` gives them).  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path
from typing import Dict

import torch

from . import check, kinds
from .run import load_cell

# one precision below the stated one: TF32 for fp32 with TF32 off, int8
# (one scale a tensor) for bf16
LOWER = {"float32": "tf32", "bfloat16": "int8"}


def _free(device):
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def parse_control(text: str) -> Dict[str, str]:
    """``"unet=tf32,vae=int8"`` -> ``{"unet": "tf32", "vae": "int8"}``."""
    return dict(part.split("=", 1) for part in text.split(","))


def readings(root: Path, workload: str, seed: int, device: str = "cuda",
             faults=None, controls: Dict[str, Dict[str, str]] = None
             ) -> Dict:
    """One seed's numbers; ``faults`` defaults to every fault the kind
    plants, ``controls`` to the cell's own control."""
    cell = load_cell(root, workload)
    tr = cell["traffic"]
    kind = kinds.load(tr["kind"])
    n = tr["check_steps"]
    faults = kind.FAULTS if faults is None else faults
    if controls is None:
        controls = {"control": {k: LOWER[v]
                                for k, v in tr["precision"].items()}}
    outs = {}
    for name in ("program",) + tuple(faults):
        prog = kind.Program(root, cell, seed, device)
        with (prog.fault(name) if name != "program"
              else contextlib.nullcontext()):
            outs[name] = check.program_steps(prog, n)
        spec = prog.spec
        del prog
        _free(device)
    ref = kind.Reference(cell, spec, seed, device, {})
    ref_out = ref.run(n)
    for name, prec in controls.items():
        c = kind.Reference(cell, spec, seed, device, prec)
        outs[name] = c.run(n)
        del c
        _free(device)
    judges = ref.judges()
    got = {k: {m: v["value"] for m, v in
               check.compare(o, ref_out, judges).items()}
           for k, o in outs.items()}
    del ref
    _free(device)
    return {"seed": seed, **got}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None)
    ap.add_argument("--controls", nargs="*", default=None,
                    help="net=mode,... each; the first is named control, "
                         "the others by their text")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    controls = None
    if a.controls:
        controls = {("control" if i == 0 else t): parse_control(t)
                    for i, t in enumerate(a.controls)}
    for s in a.seeds:
        print(json.dumps(readings(Path.cwd(), a.workload, s, "cuda",
                                  a.faults, controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
