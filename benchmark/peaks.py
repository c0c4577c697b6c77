"""The yardstick: published H100 peaks and the attention kernels' least
times, frozen.

Copied from ``gsgen_torch/tools/k5_bench.py`` (``bound_ms``,
``bwd_bound_ms``, the peaks) and from ``chip_smoke.py``
(``kernel_key``) at commit 0ee71fa, so that a change to the program does
not move the benchmark's rulers.

Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s fp32 outside the tensor
cores, 3.35 TB/s HBM3.  fp32 work counts at 495 / 3 TFLOP/s: three TF32
products a product (3xTF32) is the fastest route that the port's
exact-fp32 policy allows, so no fp32 kernel can read above 100%.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
# exp2 on the SFU: 16 a clock per SM, 132 SMs at 1.98 GHz
PEAK_EXP2 = 16 * 132 * 1.98e9
PEAKS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_FLOPS}


def attn_fwd_bound_s(B, L, H, D, dtype: str, with_lse: bool = False):
    """The forward's least time: q, k, v read and the output (and an fp32
    lse) written once, 4 B H L^2 D operations, one exp2 a score."""
    bf16 = dtype == "bfloat16"
    io = 4 * B * L * H * D * (2 if bf16 else 4) + (4 * B * H * L
                                                    if with_lse else 0)
    return max(io / PEAK_BYTES, 4.0 * B * H * L * L * D / PEAKS[dtype],
               float(B * H * L * L) / PEAK_EXP2)


def attn_bwd_bound_s(B, L, H, D, dtype: str):
    """dK, dV (8 B H L^2 D operations) plus dQ (6 B H L^2 D), each the
    larger of its operations and its bytes moved once."""
    bf16 = dtype == "bfloat16"
    io = B * L * H * D * (2 if bf16 else 4)
    total = 0.0
    for n_out, units in ((2, 8.0), (1, 6.0)):
        total += max(((4 + n_out) * io + 2 * B * H * L * 4) / PEAK_BYTES,
                     units * B * H * L * L * D / PEAKS[dtype])
    return total


def kernel_key(name: str) -> str:
    """A device kernel's name without its template and argument lists."""
    key = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].split("<")[0][-48:]
