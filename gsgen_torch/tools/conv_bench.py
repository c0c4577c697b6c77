"""Time the 3xTF32 convolution kernel (``ops/conv.py``) at the SD 2.1
UNet's fp32 convolution shapes on one CUDA card, beside cuDNN's IEEE fp32.

    python -m gsgen_torch.tools.conv_bench [--all | --vae] [--check]
                                           [--json OUT]

Shapes: :func:`unet_shapes`, the distinct (Cin, Cout, kernel, stride,
input side) of SD 2.1's UNet at a 64^2 latent with the count of each in a
forward (31 shapes, 66 convolutions).  By default the :data:`TOP` shapes
that take the most fp32 work in a VSD step, at the CFG passes' batch 8;
``--all`` every shape at batch 8 and at the LoRA pass's batch 4, and the
step's sums (two passes at 8, one at 4); ``--vae`` the SD VAE's shapes
that the kernel takes when the VAE runs in fp32 (:func:`vae_shapes`: an
encode of 4 views of 512^2 and a decode of one latent), and their sums
a call.  Each row: the kernel's device
time (a CUDA graph of calls replayed between two events,
``k5_bench.graph_ms``), the plain version's (``F.conv2d``: cuDNN in IEEE
fp32 with ``cudnn.benchmark`` off, what the port ran before), cuDNN's
IEEE fp32 with ``cudnn.benchmark`` on (set in a fresh process before any
call: this tool runs itself with ``--cudnn-benchmark``), and the bound,
the larger of the operations at 495 / 3 TFLOP/s (three TF32 products a
product) and x, w and y moved once at 3.35 TB/s.  ``--check`` adds each
shape's error against an fp64 ``F.conv2d`` over the output's largest
value.  Prints one JSON line (also to ``--json``) with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops.conv import out_size
from .k5_bench import PEAK_3XTF32_FLOPS, PEAK_BYTES, card, graph_ms

TOP = 7   # the 3 x 3 shapes of >= 30 GFLOP a step an image
LATENT = 64
VAE_BATCH = 4   # the views a training step encodes


def traced_shapes(model, run, kind):
    """[(Cin, Cout, R, stride, pad, H), count] of the ``kind`` convolutions
    that ``run(model)`` calls, in the order of their first call (meta
    tensors: nothing is computed)."""
    seen = {}

    def hook(m, inp, _):
        key = (inp[0].shape[1], m.out_channels, m.kernel_size[0],
               m.stride[0], m.padding[0], inp[0].shape[2])
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, kind)]
    with torch.device("meta"):
        run(model)
    for h in hooks:
        h.remove()
    return list(seen.items())


def unet_shapes():
    """The distinct convolutions of SD 2.1's UNet at a ``LATENT``^2 latent
    and the count of each in a forward."""
    from torch import nn

    from gsgen_torch.guidance.unet2d import SD21, UNet2DConditionModel

    with torch.device("meta"):
        unet = UNet2DConditionModel(SD21)
    return traced_shapes(unet, lambda m: m(
        torch.zeros(1, LATENT, LATENT, 4), torch.zeros(1),
        torch.zeros(1, 77, SD21.cross_attention_dim)), nn.Conv2d)


def vae_shapes():
    """The SD VAE's convolutions that the kernel can take in fp32 (those of
    its ResnetBlock2D, Downsample2D and Upsample2D, ``unet2d.Conv2d``), in
    an encode of ``VAE_BATCH`` views of ``8 LATENT``^2 (a training step's)
    and a decode of one latent (a sample's): [((Cin, Cout, R, stride,
    pad, H), count), batch].  The asymmetric downsample pads first, so its
    H is odd and its pad 0."""
    from gsgen_torch.guidance.unet2d import Conv2d
    from gsgen_torch.guidance.vae import AutoencoderKL

    with torch.device("meta"):
        vae = AutoencoderKL()
    side = 8 * LATENT
    enc = traced_shapes(vae, lambda m: m.encode(
        torch.zeros(VAE_BATCH, side, side, 3)), Conv2d)
    dec = traced_shapes(vae, lambda m: m.decode(
        torch.zeros(1, LATENT, LATENT, vae.cfg.latent_channels)), Conv2d)
    return [(sc, VAE_BATCH) for sc in enc] + [(sc, 1) for sc in dec]


def flops(shape, B):
    Cin, Cout, R, s, p, H = shape
    return 2 * B * out_size(H, R, s, p) ** 2 * Cout * Cin * R * R


def bound_ms(shape, B):
    """(ms, by): operations at 495 / 3 TFLOP/s or bytes at 3.35 TB/s."""
    Cin, Cout, R, s, p, H = shape
    Ho = out_size(H, R, s, p)
    nbytes = 4 * (B * Cin * H * H + Cout * Cin * R * R + B * Cout * Ho * Ho)
    t_ops = flops(shape, B) / PEAK_3XTF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def label(shape, B):
    Cin, Cout, R, s, _, H = shape
    return f"{Cin}->{Cout} {R}x{R}/{s} {H}^2 b{B}"


def inputs(shape, B, gen, dev):
    Cin, Cout, R, _, _, H = shape
    x = torch.randn(B, Cin, H, H, generator=gen, device=dev)
    w = torch.randn(Cout, Cin, R, R, generator=gen, device=dev) / (
        Cin * R * R) ** 0.5
    b = torch.randn(Cout, generator=gen, device=dev)
    return x, w, b


def rows_for(todo, check, iters, dev):
    from gsgen_torch.ops import conv

    gen = torch.Generator(device=dev)
    out = {}
    for shape, B in todo:
        _, _, _, s, p, _ = shape
        gen.manual_seed(sum(shape) + B)
        x, w, b = inputs(shape, B, gen, dev)
        row = dict(shape=list(shape), batch=B, flops=flops(shape, B))
        row["bound_ms"], row["bound_by"] = bound_ms(shape, B)
        if not conv.supported(x, w, b, s, p):
            # the port leaves it to cuDNN (conv_out's 4 channels)
            row["ms"] = None
        elif check:
            got = conv.conv2d_3xtf32(x, w, b, s, p).double()
            want = conv.conv2d_plain(x.double(), w.double(), b.double(),
                                     s, p)
            row["err"] = float((got - want).abs().max()
                               / want.abs().max())
            del got, want
        if "ms" not in row:
            row["ms"] = graph_ms(lambda: conv.conv2d_3xtf32(x, w, b, s, p),
                                 iters=iters, reps=3)
        row["plain_ms"] = graph_ms(lambda: conv.conv2d_plain(x, w, b, s, p),
                                   iters=iters, reps=3)
        out[label(shape, B)] = row
        del x, w, b
        torch.cuda.empty_cache()
    return out


def cudnn_benchmark_ms(todo, iters, dev):
    """cuDNN's IEEE fp32 with ``cudnn.benchmark`` on (this process sets it
    before its first call), by label."""
    from gsgen_torch.ops import conv

    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device=dev)
    res = {}
    for shape, B in todo:
        _, _, _, s, p, _ = shape
        gen.manual_seed(sum(shape) + B)
        x, w, b = inputs(shape, B, gen, dev)
        res[label(shape, B)] = graph_ms(
            lambda: conv.conv2d_plain(x, w, b, s, p), iters=iters, reps=3)
        del x, w, b
        torch.cuda.empty_cache()
    return res


def top_shapes(shapes):
    """The :data:`TOP` shapes that take the most work a forward, at the CFG
    passes' batch 8."""
    top = sorted(shapes, key=lambda sc: -flops(sc[0], 1) * sc[1])
    return [(s, 8) for s, _ in top[:TOP]]


def cudnn_benchmark_rows(flags=(), iters=20):
    """:func:`cudnn_benchmark_ms` of the shapes ``flags`` select, from a
    fresh process (``cudnn.benchmark`` is set there before any call)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bench.json"
        cmd = [sys.executable, "-m", "gsgen_torch.tools.conv_bench",
               "--cudnn-benchmark", "--iters", str(iters), "--json",
               str(path), *flags]
        subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL)
        return json.loads(path.read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--all", action="store_true",
                    help="every shape at batch 8 and 4, and the step's sums")
    ap.add_argument("--vae", action="store_true",
                    help="the SD VAE's fp32 shapes, and an encode's and a "
                         "decode's sums")
    ap.add_argument("--check", action="store_true",
                    help="each shape's error against an fp64 F.conv2d")
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_bench: no CUDA card", file=sys.stderr)
        return 1
    from gsgen_torch.utils.precision import exact_fp32

    exact_fp32()
    dev = torch.device("cuda")
    shapes = unet_shapes()
    if args.vae:
        vae = vae_shapes()
        todo = [(s, B) for (s, _), B in vae]
    elif args.all:
        todo = [(s, B) for B in (8, 4) for s, _ in shapes]
    else:
        todo = top_shapes(shapes)
    if args.cudnn_benchmark:
        line = json.dumps(cudnn_benchmark_ms(todo, args.iters, dev))
        if args.json is not None:
            args.json.write_text(line + "\n")
        print(line)
        return 0
    res = dict(card=card(), kind=torch.cuda.get_device_name(0),
               rows=rows_for(todo, args.check, args.iters, dev))
    bench = cudnn_benchmark_rows(
        [f for f, on in (("--all", args.all), ("--vae", args.vae)) if on],
        args.iters)
    for name, row in res["rows"].items():
        row["cudnn_benchmark_ms"] = bench[name]
    for r in res["rows"].values():
        r["port_ms"] = r["plain_ms"] if r["ms"] is None else r["ms"]
    keys = ("port_ms", "plain_ms", "cudnn_benchmark_ms", "bound_ms")
    if args.vae:
        # an encode's sums (its batch) and a decode's (batch 1)
        res["call"] = {
            part: {k: sum(n * res["rows"][label(s, B)][k]
                          for (s, n), B in vae if (B == 1) == (part ==
                                                                "decode"))
                   for k in keys} for part in ("encode", "decode")}
    elif args.all:
        counts = dict(shapes)
        res["step"] = {k: sum(
            (2 if r["batch"] == 8 else 1) * counts[tuple(r["shape"])] * r[k]
            for r in res["rows"].values()) for k in keys}
    line = json.dumps(res)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    for name, r in res["rows"].items():
        kern = ("kernel not taken" if r["ms"] is None else
                f"kernel {r['ms']:.4f} ms = "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
        print(f"{name}: {kern}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), cuDNN IEEE "
              f"{r['plain_ms']:.4f} (benchmark on "
              f"{r['cudnn_benchmark_ms']:.4f})"
              + (f", err {r['err']:.2e} of max" if "err" in r else ""))
    for part, st in res.get("call", {}).items():
        print(f"the SD VAE's {part} convolutions that the kernel takes in "
              f"fp32: the port {st['port_ms']:.2f} ms, cuDNN IEEE "
              f"{st['plain_ms']:.2f} (benchmark on "
              f"{st['cudnn_benchmark_ms']:.2f}), bound "
              f"{st['bound_ms']:.2f}")
    if args.all:
        st = res["step"]
        print(f"a VSD step's UNet forward convolutions (2 passes at 8, 1 at "
              f"4): the port {st['port_ms']:.2f} ms, cuDNN IEEE "
              f"{st['plain_ms']:.2f}"
              f" (benchmark on {st['cudnn_benchmark_ms']:.2f}), bound "
              f"{st['bound_ms']:.2f}")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
