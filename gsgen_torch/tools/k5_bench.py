"""Time K5 (the flash self-attention forward, ``ops/flash_attention.py``)
at the UNets' attention shapes, or with ``--bwd`` K6 and K7 (its
backward), on one CUDA card.

    python -m gsgen_torch.tools.k5_bench [--bwd] [--dtype TYPE]
        [--against DIR ...] [--rounds 2] [--json OUT]

Forward shapes (:data:`SHAPES`, random inputs from a seed): in bf16 SD
2.1's level 0 [8, 4096, 5, 64], SD 1.5's level 0 [8, 4096, 8, 40] and the
two levels ``fused_attention: on`` adds, [8, 1024, 8, 80] and [8, 256, 8,
160] (CFG batch 8); in fp32 (3xTF32) VSD's [8, 4096, 5, 64] and, with the
lse that K6 and K7 read, [4, 4096, 5, 64], the IF-II upsampler's levels
[2, 16384, 8, 16] and [2, 4096, 8, 32], and SD 1.5's `on` levels (the
mma.sync instance of D = 72-160); ``--dtype`` keeps one type's forward
shapes.
Backward shapes (:data:`BWD_SHAPES`): VSD's fp32 [4, 4096, 5, 64] and the
same SD 1.5 levels at batch 4 in bf16, the `on` levels in fp32 too.  Each
kernel time is device time: a CUDA graph of 50 calls (10 in the backward)
replayed 5 times (3) between two events.  Beside it: SDPA's time on the same inputs (in the backward,
one autograd call of SDPA computing dQ, dK and dV, its device ops' time
from a profiler trace), each tree's error against the plain version,
and the bound (:func:`bound_ms`, :func:`bwd_bound_ms`).
``chip_smoke.py`` takes its K5 and K6 / K7 bounds, the H100 peaks behind
them, its graph timer and its trace reading from here.

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
import math
import subprocess
import sys
from pathlib import Path

import torch

# label: ([B, L, H, D], dtype, whether the lse is written too)
SHAPES = {"SD 2.1 level 0": ((8, 4096, 5, 64), "bfloat16", False),
          "SD 1.5 level 0": ((8, 4096, 8, 40), "bfloat16", False),
          "SD 1.5 level 1 (on)": ((8, 1024, 8, 80), "bfloat16", False),
          "SD 1.5 level 2 (on)": ((8, 256, 8, 160), "bfloat16", False),
          "VSD level 0": ((8, 4096, 5, 64), "float32", False),
          "VSD level 0 +lse": ((4, 4096, 5, 64), "float32", True),
          "IF-II level 1": ((2, 16384, 8, 16), "float32", False),
          "IF-II level 2": ((2, 4096, 8, 32), "float32", False),
          "SD 1.5 level 1 (on) fp32": ((8, 1024, 8, 80), "float32", False),
          "SD 1.5 level 2 (on) fp32": ((8, 256, 8, 160), "float32", False)}
BWD_SHAPES = {"VSD level 0": ((4, 4096, 5, 64), "float32"),
              "SD 1.5 level 0": ((4, 4096, 8, 40), "bfloat16"),
              "SD 1.5 level 1 (on)": ((4, 1024, 8, 80), "bfloat16"),
              "SD 1.5 level 2 (on)": ((4, 256, 8, 160), "bfloat16"),
              "SD 1.5 level 1 (on) fp32": ((4, 1024, 8, 80), "float32"),
              "SD 1.5 level 2 (on) fp32": ((4, 256, 8, 160), "float32")}
PEAK_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
# K5-K7 in fp32 run 3xTF32: three TF32 tensor-core products per product,
# so the rate that design can reach is 495 / 3 TFLOP/s of fp32 work
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
# exp2 on the SFU: 16 a clock per SM, 132 SMs at the 1.98 GHz at which the
# fp32 peak is stated (67e12 = 132 x 128 x 2 x 1.98e9): 4.18e12 a second
PEAK_EXP2 = 16 * 132 * 1.98e9
# the chrome trace's categories of device ops
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def bound_ms(B, L, H, D, dtype=torch.bfloat16, with_lse=False):
    """K5's bound, (ms, by): the largest of three times, q, k, v read and
    the output (and the fp32 lse) written once at :data:`PEAK_BYTES`
    ("bytes"), 4 B H L^2 D operations at :data:`PEAK_BF16_FLOPS` (bf16)
    or :data:`PEAK_3XTF32_FLOPS` (fp32) ("operations"), and one exp2 a
    score, B H L^2 of them, at :data:`PEAK_EXP2` ("exps")."""
    bf16 = dtype == torch.bfloat16
    io = 4 * B * L * H * D * (2 if bf16 else 4) + (4 * B * H * L
                                                    if with_lse else 0)
    terms = {"bytes": io / PEAK_BYTES,
             "operations": 4.0 * B * H * L * L * D
             / (PEAK_BF16_FLOPS if bf16 else PEAK_3XTF32_FLOPS),
             "exps": float(B * H * L * L) / PEAK_EXP2}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by


def bwd_bound_ms(B, L, H, D, dtype, kernel):
    """K6's ("dkv": 8 B H L^2 D operations, dk and dv written) or K7's
    ("dq": 6 B H L^2 D, dq written) bound, (ms, by): the larger of the
    operations at the bf16 or 3xTF32 rate and the bytes of q, k, v, dout,
    lse, Di and the outputs, each moved once."""
    bf16 = dtype == torch.bfloat16
    io = B * L * H * D * (2 if bf16 else 4)
    n_out, units = (2, 8.0) if kernel == "dkv" else (1, 6.0)
    terms = {"bytes": ((4 + n_out) * io + 2 * B * H * L * 4) / PEAK_BYTES,
             "operations": units * B * H * L * L * D
             / (PEAK_BF16_FLOPS if bf16 else PEAK_3XTF32_FLOPS)}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by


def sdpa_bwd_ms(q, k, v, dout, scale, iters=10):
    """Device time of one autograd call through SDPA's backward on [B, H,
    L, D] views of [B, L, H, D] inputs (dQ, dK and dV together): the
    union of its device ops' spans in a torch.profiler trace of ``iters``
    calls after one warm-up call, over ``iters``.  The host loop between
    the calls is left out, as the CUDA graph of :func:`graph_ms` leaves it
    out of K6 and K7."""
    import tempfile

    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    o_h = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    do_h = dout.transpose(1, 2)

    def bwd():
        torch.autograd.grad(o_h, (qh, kh, vh), do_h, retain_graph=True)

    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            bwd()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "sdpa_bwd.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not events:
        raise RuntimeError("the profiler saw no device op in SDPA's "
                           "backward")
    return busy_us(events) / 1e3 / iters


def busy_us(events):
    """Union of the trace events' [ts, ts + dur) spans, in us."""
    busy, end = 0.0, -math.inf
    for e in sorted(events, key=lambda e: e["ts"]):
        t0, d = float(e["ts"]), float(e["dur"])
        busy += max(0.0, t0 + d - max(t0, end))
        end = max(end, t0 + d)
    return busy


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


def turns(trees):
    """The order of one round: this, the others, the others reversed,
    this."""
    others = [n for n in trees if n != "this"]
    return ["this", *others, *others[::-1], "this"] if others else ["this"]


def bwd_rows(trees, rounds, gen):
    """K6 and K7 of every tree at :data:`BWD_SHAPES`, in turns: device ms
    of each, their sum, each tree's largest error over each gradient's
    largest plain value, SDPA's backward and the bounds."""
    fa = trees["this"]
    dev = torch.device("cuda")
    rows = {}
    for label, (shp, dtn) in BWD_SHAPES.items():
        B, L, H, D = shp
        dt = getattr(torch, dtn)
        gen.manual_seed(70 + L + D)
        q, k, v, dout = (torch.randn(shp, generator=gen, device=dev).to(dt)
                         for _ in range(4))
        scale = D ** -0.5
        out, lse = fa.flash_self_attention_lse(q, k, v, scale)
        delta = fa.attention_delta(out, dout)
        args = (q, k, v, dout, lse, delta, scale)
        want = fa.flash_self_attention_bwd_plain(q, k, v, out, lse, dout,
                                                 scale)
        row = dict(shape=list(shp), dtype=dtn, err={},
                   ms={n: dict(dkv=[], dq=[]) for n in trees})
        for name, mod in trees.items():
            dk, dv = mod.flash_bwd_dkv(*args)
            dq = mod.flash_bwd_dq(*args)
            row["err"][name] = max(
                float((a.float() - b.float()).abs().max())
                / float(b.float().abs().max())
                for a, b in zip((dq, dk, dv), want))
        del want, dk, dv, dq
        for _ in range(rounds):
            for name in turns(trees):
                mod = trees[name]
                row["ms"][name]["dkv"].append(graph_ms(
                    lambda mod=mod: mod.flash_bwd_dkv(*args), 10, 3))
                row["ms"][name]["dq"].append(graph_ms(
                    lambda mod=mod: mod.flash_bwd_dq(*args), 10, 3))
        row["sdpa_bwd_ms"] = sdpa_bwd_ms(q, k, v, dout, scale)
        row["bound_ms"] = {kn: bwd_bound_ms(B, L, H, D, dt, kn)
                           for kn in ("dkv", "dq")}
        rows[label] = row
        del q, k, v, dout, out, lse, delta, args
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bwd", action="store_true",
                    help="time K6 and K7 at BWD_SHAPES instead of K5")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default=None, help="time only this type's forward "
                    "shapes")
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_bench: no CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from gsgen_torch.ops import flash_attention as fa
    from gsgen_torch.utils.precision import exact_fp32

    exact_fp32()
    trees = {"this": fa}
    for i, root in enumerate(args.against):
        trees[root.name] = load_other(root.resolve(), f"gsgen_torch_{i}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    res = dict(card=card(), kind=torch.cuda.get_device_name(0), shapes={})
    if args.bwd:
        res["bwd"] = bwd_rows(trees, args.rounds, gen)
        return report(res, args.json)
    for label, (shp, dtn, with_lse) in SHAPES.items():
        if args.dtype not in (None, dtn):
            continue
        B, L, H, D = shp
        dt = getattr(torch, dtn)
        gen.manual_seed(60 + L)
        q, k, v = (torch.randn(shp, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        scale = D ** -0.5

        def call(mod):
            if with_lse:
                return mod.flash_self_attention_lse(q, k, v, scale)
            return mod.flash_self_attention(q, k, v, scale), None

        want, lse_p = (fa.flash_self_attention_plain_lse(q, k, v, scale)
                       if with_lse else
                       (fa.flash_self_attention_plain(q, k, v, scale), None))
        want = want.float()
        row = dict(shape=list(shp), dtype=dtn, lse=with_lse,
                   ms={n: [] for n in trees}, err={})
        for name, mod in trees.items():
            got, lse = call(mod)
            row["err"][name] = float((got.float() - want).abs().max())
            if with_lse:
                row.setdefault("lse_err", {})[name] = float(
                    (lse - lse_p).abs().max())
        row["top"] = float(want.abs().max())
        del want, lse_p, got, lse
        for _ in range(args.rounds):
            for name in turns(trees):
                row["ms"][name].append(graph_ms(
                    lambda mod=trees[name]: call(mod)))
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale))
        row["bound_ms"], row["bound_by"] = bound_ms(B, L, H, D, dt,
                                                    with_lse)
        res["shapes"][label] = row
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return report(res, args.json)


def report(res, path) -> int:
    """Print a line a shape (the least of each tree's times) and the JSON
    line, also to ``path``."""
    line = json.dumps(res)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")
    for label, r in res["shapes"].items():
        print(f"{label} {r['shape']} {r['dtype']}: " + ", ".join(
            f"{n} {min(v):.4f} ms = {100 * r['bound_ms'] / min(v):.1f}% "
            f"of bound (err {r['err'][n] / r['top']:.2e} of max"
            + (f", lse {r['lse_err'][n]:.2e}" if r["lse"] else "") + ")"
            for n, v in r["ms"].items())
            + f", SDPA {r['sdpa_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}", flush=True)
    for label, r in res.get("bwd", {}).items():
        bd = r["bound_ms"]
        best = {n: (min(v["dkv"]), min(v["dq"])) for n, v in r["ms"].items()}
        print(f"{label} {r['shape']} {r['dtype']}: " + " | ".join(
            f"{n}: K6 {k6:.4f} ms ({100 * bd['dkv'][0] / k6:.1f}% of "
            f"bound), K7 {k7:.4f} ms ({100 * bd['dq'][0] / k7:.1f}%), K6 + "
            f"K7 {k6 + k7:.4f} ms (err {r['err'][n]:.2e})"
            for n, (k6, k7) in best.items())
            + f" | SDPA bwd {r['sdpa_bwd_ms']:.4f} ms | bounds K6 "
            f"{bd['dkv'][0]:.4f} {bd['dkv'][1]}, K7 {bd['dq'][0]:.4f} "
            f"{bd['dq'][1]}", flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
