"""Time K5 (the flash self-attention forward, ``ops/flash_attention.py``)
at the UNet's bf16 attention shapes on one CUDA card.

    python -m gsgen_torch.tools.k5_bench [--against DIR ...] [--rounds 2]
        [--json OUT]

Shapes: SD 2.1's level 0 [8, 4096, 5, 64], SD 1.5's level 0 [8, 4096, 8,
40] and the two levels ``fused_attention: on`` adds, [8, 1024, 8, 80] and
[8, 256, 8, 160] (CFG batch 8, random inputs from a seed).  Each time is
device time: a CUDA graph of 50 calls replayed 5 times between two events.
Beside it: SDPA's time on the same inputs, the plain version's error, and
the bound (:func:`bound_ms`).  ``chip_smoke.py`` takes its K5 bound, the
H100 peaks behind it and its graph timer from here.

``--against DIR`` (repeatable): the ``gsgen_torch`` of another checkout
(the parent commit unpacked by ``git archive``, say), loaded beside this
one under another module name with its own kernel build, and timed in
turns with it in the same process: each round runs this, the others, the
others in reverse, this.  Each tree is named by its directory.  Prints one
JSON line (also to ``--json``) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = {"SD 2.1 level 0": (8, 4096, 5, 64),
          "SD 1.5 level 0": (8, 4096, 8, 40),
          "SD 1.5 level 1 (on)": (8, 1024, 8, 80),
          "SD 1.5 level 2 (on)": (8, 256, 8, 160)}
PEAK_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
# exp2 on the SFU: 16 a clock per SM, 132 SMs at the 1.98 GHz at which the
# fp32 peak is stated (67e12 = 132 x 128 x 2 x 1.98e9): 4.18e12 a second
PEAK_EXP2 = 16 * 132 * 1.98e9


def bound_ms(B, L, H, D, elem=2):
    """K5's bound, (ms, by): the largest of three times, q, k, v read and
    the output written once at :data:`PEAK_BYTES` ("bytes"), 4 B H L^2 D
    operations at :data:`PEAK_BF16_FLOPS` ("operations"), and one exp2 a
    score, B H L^2 of them, at :data:`PEAK_EXP2` ("exps")."""
    terms = {"bytes": 4 * B * L * H * D * elem / PEAK_BYTES,
             "operations": 4.0 * B * H * L * L * D / PEAK_BF16_FLOPS,
             "exps": float(B * H * L * L) / PEAK_EXP2}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by


def graph_ms(fn, iters=50, reps=5):
    """Device time of one call of ``fn`` without its host launch path: a
    CUDA graph of ``iters`` calls replayed ``reps`` times between two
    events, over iters x reps (the graph's own gaps between kernels
    included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        graph.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (iters * reps)


def load_other(root: Path, alias: str):
    """``ops.flash_attention`` of the ``gsgen_torch`` package under
    ``root``, imported as ``alias`` (its modules import each other
    relatively, so the two packages do not mix)."""
    init = root / "gsgen_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.flash_attention")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi gave no answer"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_bench: no CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from gsgen_torch.ops import flash_attention as fa

    trees = {"this": fa}
    for i, root in enumerate(args.against):
        trees[root.name] = load_other(root.resolve(), f"gsgen_torch_{i}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    res = dict(card=card(), kind=torch.cuda.get_device_name(0), shapes={})
    for label, shp in SHAPES.items():
        B, L, H, D = shp
        gen.manual_seed(60 + L)
        q, k, v = (torch.randn(shp, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(3))
        scale = D ** -0.5
        want = fa.flash_self_attention_plain(q, k, v, scale).float()
        row = dict(shape=list(shp), ms={n: [] for n in trees}, err={})
        for name, mod in trees.items():
            got = mod.flash_self_attention(q, k, v, scale).float()
            row["err"][name] = float((got - want).abs().max())
        row["top"] = float(want.abs().max())
        del want, got
        others = [n for n in trees if n != "this"]
        order = ["this", *others, *others[::-1], "this"] if others \
            else ["this"]
        for _ in range(args.rounds):
            for name in order:
                mod = trees[name]
                row["ms"][name].append(graph_ms(
                    lambda mod=mod: mod.flash_self_attention(q, k, v,
                                                             scale)))
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale))
        row["bound_ms"], row["bound_by"] = bound_ms(B, L, H, D)
        res["shapes"][label] = row
        del q, k, v, qh, kh, vh
    line = json.dumps(res)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    for label, r in res["shapes"].items():
        print(f"{label} {r['shape']}: " + ", ".join(
            f"{n} {min(v):.4f} ms (err {r['err'][n]:.2e})"
            for n, v in r["ms"].items())
            + f", SDPA {r['sdpa_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}", flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
