"""What ``correct`` compares: the program's first training steps against
the reference's over the same steps from the same seed.

Three numbers, each a gap between norms (not the norm of a difference)
measured against the reference's norm of that leaf or of the median
leaf, whichever is larger, and taken at the worst leaf or step:

* ``loss_gap``: each step's loss;
* ``grad_gap``: the first step's gradient as Adam received it, worked
  out from the program's first moments after one step (``mu / (1 - b1)``);
* ``change_gap``: each leaf's change over the steps, read before the next
  step moves it.  Leaves whose reference gradient is under a thousandth of
  the median leaf's move under Adam by round-off alone and are left out;
* ``grad_gap_median``: the first gradient's gap at the median leaf (the
  median of the leaves' gaps), steady where a few small leaves swing;
* ``<stage>_gap`` (``eps_gap``: the UNet, ``latent_gap``: the VAE
  encode): each network stage of the first step recomputed by the exact
  reference from the inputs the run gave it, the norm of the difference
  over the reference output's norm, at the worst call.  The training
  numbers see the sum of every stage's error; this one sees a single
  stage, so a stage computed a precision lower shows there even where
  another stage's rounding is the larger in the gradients.

A cell compares the numbers its ``workloads/<cell>.json`` gives limits
for (``PERF.md`` says why each).
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Callable, Dict, Optional

import torch

B1 = 0.9
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
           "eps_gap", "latent_gap")


def program_steps(prog, n_steps: int) -> Dict:
    """Drive ``n_steps`` steps through ``prog.step`` (a kind's
    ``Program``: one step through the program's entry), the first with
    its stages tapped, and read what the comparison needs; the copies
    are small (the optimised leaves, one step's stage inputs)."""
    start = {k: v.detach().clone() for k, v in prog.leaves().items()}
    losses, grads, stages = [], None, {}
    for i in range(n_steps):
        with (prog.tap(stages) if i == 0 else contextlib.nullcontext()):
            prog.step(lambda s, m: losses.append(float(m["loss_total"])))
        if i == 0:
            mu = prog.first_moments()
            grads = {k: mu[k].detach() / (1.0 - B1) for k in start}
    change = {k: v.detach() - start[k] for k, v in prog.leaves().items()}
    return {"losses": losses, "grads": grads, "change": change,
            "stages": stages}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float]):
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - r) / max(r, med, 1e-30) for k, r in ref.items()}


def _worst(gaps: Dict[str, float]):
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _rel(out: torch.Tensor, want: torch.Tensor) -> float:
    d = torch.linalg.norm((out.double() - want.double()).flatten())
    return float(d / max(float(torch.linalg.norm(want.double().flatten())),
                         1e-30))


@torch.no_grad()
def stage_gaps(stages: Dict, judges: Dict[str, Callable]) -> Dict:
    """``{"<stage>_gap": {"value", "at"}}``: each call of a stage
    recomputed by ``judges[stage](args, kwargs)`` from its recorded
    inputs, the worst call's relative gap."""
    out = {}
    for stage, calls in stages.items():
        if not calls or stage not in judges:
            continue
        gaps = [_rel(o, judges[stage](a, kw).float().to(o.device))
                for a, kw, o in calls]
        i = max(range(len(gaps)), key=gaps.__getitem__)
        out[f"{stage}_gap"] = {"value": gaps[i],
                               "at": f"call {i} of {len(gaps)}"}
    return out


def compare(prog: Dict, ref: Dict,
            judges: Optional[Dict[str, Callable]] = None
            ) -> Dict[str, Dict]:
    """``{number: {"value", "at"}}`` for :data:`NUMBERS` (the stage
    numbers where ``judges`` are given and the run tapped its stages)."""
    odd = sorted(set(prog["grads"]) ^ set(ref["grads"]))
    if odd:
        raise ValueError("the program and the reference optimise different "
                         f"leaves: {odd[:6]}")
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("different numbers of steps")
    lg = {i: abs(p - r) / max(abs(r), 1e-30)
          for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    li = max(lg, key=lg.get)
    g_ref = _norms(ref["grads"])
    g_gaps = _gaps(_norms(prog["grads"]), g_ref)
    gg, gk = _worst(g_gaps)
    med = statistics.median(g_ref.values())
    kept = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    cg, ck = _worst(_gaps(_norms({k: prog["change"][k] for k in kept}),
                          _norms({k: ref["change"][k] for k in kept})))
    return {"loss_gap": {"value": lg[li], "at": f"step {li}"},
            "grad_gap": {"value": gg, "at": gk},
            "change_gap": {"value": cg, "at": ck},
            "grad_gap_median": {"value": statistics.median(g_gaps.values()),
                                "at": f"{len(g_gaps)} leaves"},
            **stage_gaps(prog.get("stages", {}), judges or {})}
