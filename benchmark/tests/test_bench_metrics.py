"""The benchmark's arithmetic: busy time as a union of spans, the span
attribution of device ops, the meta-device FLOP count against a hand
count, the attention bound's sites and the readers."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import readers
from benchmark.flops import step_flops
from benchmark.peaks import (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS,
                             attn_bwd_bound_s, attn_fwd_bound_s)
from benchmark.trace import attribute, busy_s

ROOT = Path(__file__).resolve().parents[2]


def test_busy_is_the_union_of_spans():
    assert busy_s([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == 3.0
    assert busy_s([(1.0, 2.0), (1.2, 1.5)]) == 1.0
    assert busy_s([]) == 0.0


def test_attribution_on_a_canned_event_list():
    main, bwd = 1, 2
    spans = [("window", 0.0, 10.0, main), ("render", 1.0, 2.0, main),
             ("vae", 2.0, 3.0, main), ("unet_fwd", 3.0, 5.0, main),
             ("vae_bwd", 6.0, 7.0, bwd)]
    launch = {1: (1.5, main), 2: (2.5, main), 3: (3.5, main),
              4: (4.0, main), 5: (6.5, bwd), 6: (7.5, bwd), 7: (8.0, main)}
    # device ops: (name, start, end, correlation); ops 3 and 4 overlap
    dev = [("k_render", 1.6, 2.1, 1), ("k_vae", 2.6, 3.0, 2),
           ("k_conv", 3.6, 4.6, 3), ("k_conv", 4.1, 5.1, 4),
           ("k_vae_bwd", 6.6, 6.9, 5), ("k_raster_bwd", 7.6, 7.8, 6),
           ("k_adam", 8.1, 8.2, 7), ("k_lost", 9.0, 9.5, 99)]
    # a tag across the parts: an attention core inside the UNet span and
    # its backward on the backward thread
    spans += [("tag.attn", 3.4, 3.7, main), ("tag.attn", 6.4, 6.6, bwd)]
    ev = attribute(dev, launch, spans)
    assert ev["tag_s"] == {"attn": pytest.approx(1.0 + 0.3)}
    p = ev["part_s"]
    assert p["render"] == pytest.approx(0.5 + 0.2)   # fwd + bwd thread
    assert p["vae"] == pytest.approx(0.4 + 0.3)      # fwd + vae_bwd
    assert p["unet_fwd"] == pytest.approx(1.5)       # union, not 2.0
    assert p["other"] == pytest.approx(0.1)
    assert p["unattributed"] == pytest.approx(0.5)
    assert ev["window_s"] == pytest.approx(10.0)
    assert ev["busy_s"] == pytest.approx(0.5 + 0.4 + 1.5 + 0.3 + 0.2
                                         + 0.1 + 0.5)
    assert ev["kernel_s"]["k_conv"] == pytest.approx(2.0)
    assert sum(ev["idle_gaps"].values()) == pytest.approx(
        ev["window_s"] - ev["busy_s"])
    # the device idles from 3.0 to 3.6 while the host is in the UNet
    assert ev["idle_gaps"]["host:unet_fwd"] == pytest.approx(0.6)


ONE_LEVEL = {"block_out_channels": [32], "layers_per_block": 1,
             "attention_head_dim": 2, "cross_attention_dim": 8,
             "down_block_types": ["DownBlock2D"],
             "up_block_types": ["UpBlock2D"], "in_channels": 4,
             "out_channels": 4, "norm_num_groups": 32, "sample_size": 4,
             "use_linear_projection": True}
VAE_ONE = {"block_out_channels": [32], "layers_per_block": 1,
           "latent_channels": 4, "scaling_factor": 0.18215,
           "norm_num_groups": 32}


def hand_unet_flops(B: int, c=32, s=4, cin=4, x=8, L=77) -> int:
    """A one-level UNet's forward, layer by layer: 2 m n k a product."""
    P = s * s
    conv = lambda i, o, k=3: 2 * B * P * i * o * k * k  # noqa: E731
    lin = lambda rows, i, o: 2 * rows * i * o           # noqa: E731
    temb = lin(B, c, 4 * c) + lin(B, 4 * c, 4 * c)
    res = lambda i, o: (conv(i, c) + lin(B, 4 * c, c) + conv(c, c)  # noqa
                        + (conv(i, c, 1) if i != c else 0))
    attn = (lin(B * P, c, c) * 3 + 2 * B * P * P * c * 2 + lin(B * P, c, c)
            + lin(B * P, c, c) + 2 * lin(B * L, x, c)
            + 2 * B * P * L * c * 2 + lin(B * P, c, c))
    ff = lin(B * P, c, 8 * c) + lin(B * P, 4 * c, c)
    mid = 2 * res(c, c) + lin(B * P, c, c) * 2 + attn + ff
    return (temb + conv(cin, c) + res(c, c) + mid + 2 * res(2 * c, c)
            + conv(c, 4))


def test_meta_flop_count_against_a_hand_count():
    traffic = {"guidance": "sds",
               "precision": {"unet": "bfloat16", "vae": "float32"},
               "unet_passes": [{"batch": 2}]}
    got = step_flops(ONE_LEVEL, VAE_ONE, traffic, 1)
    assert got["bfloat16"] == hand_unet_flops(2)
    assert got["float32"] > 0
    # a differentiated pass: the forward and the activations' gradients
    traffic["unet_passes"] = [{"batch": 2, "grad": True, "lora": True}]
    traffic["guidance"] = "vsd"
    grad = step_flops(ONE_LEVEL, VAE_ONE, traffic, 1)["bfloat16"]
    assert 1.8 * hand_unet_flops(2) < grad < 3.5 * hand_unet_flops(2)


def test_attention_sites_and_bound():
    sd21 = json.loads((ROOT / "benchmark/configs/sd21-base.json").read_text())
    sd15 = json.loads((ROOT / "benchmark/configs/sd15.json").read_text())
    assert readers.attn_sites(sd21) == [(5, 64, 4096, 5), (10, 64, 1024, 5),
                                        (20, 64, 256, 5), (20, 64, 64, 1)]
    assert readers.attn_sites(sd15) == [(8, 40, 4096, 5), (8, 80, 1024, 5),
                                        (8, 160, 256, 5), (8, 160, 64, 1)]
    sds = {"precision": {"unet": "bfloat16"}, "unet_passes": [{"batch": 8}]}
    one = attn_fwd_bound_s(8, 4096, 8, 40, "bfloat16")
    assert readers.attn_bound_s(sd15, sds) == pytest.approx(
        5 * one + 5 * attn_fwd_bound_s(8, 1024, 8, 80, "bfloat16")
        + 5 * attn_fwd_bound_s(8, 256, 8, 160, "bfloat16")
        + attn_fwd_bound_s(8, 64, 8, 160, "bfloat16"))
    # SD 1.5's D = 40 is bound by the exps, SD 2.1's fp32 by operations
    assert one == pytest.approx(8 * 8 * 4096 ** 2 / (16 * 132 * 1.98e9))
    ops = 4.0 * 8 * 5 * 4096 ** 2 * 64
    assert attn_fwd_bound_s(8, 4096, 5, 64, "float32") == pytest.approx(
        ops / PEAK_FP32_FLOPS)
    assert attn_bwd_bound_s(4, 4096, 5, 64, "bfloat16") == pytest.approx(
        14.0 * 4 * 5 * 4096 ** 2 * 64 / PEAK_BF16_FLOPS)


def test_readers_return_nothing_without_a_reading():
    ctx = dict(trace=dict(part_s={"vae": 0.5}, kernel_s={"gemm": 1.0},
                          tag_s={}, busy_s=0.8, window_s=1.6),
               traced_steps=10, step_s=0.1, flops={},
               model=json.loads((ROOT / "benchmark/configs/sd15.json")
                                .read_text()),
               traffic={"precision": {"unet": "bfloat16"},
                        "unet_passes": [{"batch": 8}]})
    assert readers.part_ms(ctx, "vae") == pytest.approx(50.0)
    assert readers.part_ms(ctx, "unet_bwd") is None
    assert readers.attn_roofline_pct(ctx) is None
    assert readers.step_mfu_pct(ctx) is None
    # 80 ms busy a traced step against 100 ms a step untraced
    assert readers.idle_pct(ctx) == pytest.approx(20.0)
    ctx["flops"] = {"bfloat16": 0.1 * PEAK_BF16_FLOPS * 0.25}
    assert readers.step_mfu_pct(ctx) == pytest.approx(25.0)
    ctx["trace"]["tag_s"]["attn"] = 0.5
    assert 0.0 < readers.attn_roofline_pct(ctx) <= 100.0
