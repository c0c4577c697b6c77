"""SDXL base 1.0 in the port (the ``sdxl`` preset): stacked transformer
blocks and text-time conditioning in ``guidance/unet2d.py``, the SDXL VAE,
the pooled prompt embeddings and the SDS step, held to the benchmark's
plain reference (``benchmark/reference/sdxl.py``) on the CPU.

The parity cases run ``TINY_SDXL``: SDXL's block layout (no attention at
the top level, stacks of 2 and 3 blocks below) at widths 32 / 64 / 64,
with 8-wide time-id sinusoids and a 16-wide pooled embedding, on the
benchmark's seeded fp32 weights.  The full-width preset is built on the
meta device only.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.kinds.sdxl import make_weights
from benchmark.reference.nets import VAE
from benchmark.reference.sdxl import UNetXL, time_ids
from gsgen_torch.config import _build_backbone, build_trainer, load_config
from gsgen_torch.guidance import unet2d
from gsgen_torch.guidance.convert import load_template
from gsgen_torch.guidance.sd_unet import SDUNetBackbone
from gsgen_torch.prompt.processors import (PromptEmbedding, mock_encode,
                                           mock_pooled)
from gsgen_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
# TINY_SDXL in diffusers' keys (the depth of the attention-free top
# level is never read)
TINY_UNET = {
    "block_out_channels": [32, 64, 64], "attention_head_dim": [2, 2, 4],
    "transformer_layers_per_block": [0, 2, 3], "cross_attention_dim": 64,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                         "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                       "UpBlock2D"],
    "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
    "projection_class_embeddings_input_dim": 64, "sample_size": 8,
    "in_channels": 4, "out_channels": 4, "layers_per_block": 2,
    "norm_num_groups": 32, "use_linear_projection": True,
    "flip_sin_to_cos": True, "freq_shift": 0}
TINY_VAE = {"block_out_channels": [32, 64], "in_channels": 3,
            "out_channels": 3, "latent_channels": 4, "layers_per_block": 1,
            "norm_num_groups": 32, "scaling_factor": 0.18215}
FP32 = {"unet": "float32", "vae": "float32"}
OVERRIDES = ["init.num_points=64", "init.capacity=128", "data.reso=[16]",
             "renderer.tile_size=8", "renderer.chunk=128",
             "renderer.dup_cap=4096", "trainer.batch_size=2",
             "guidance.backbone_preset=tiny_sdxl"]


def gap(got, want) -> float:
    """The largest difference over the largest magnitude."""
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def tiny():
    """The port's TINY_SDXL backbone (fp32) and the reference's UNet and
    VAE, all on one seed's weights."""
    w = make_weights(TINY_UNET, TINY_VAE, 2 ** 31 + 3, "cpu", FP32)
    bb = SDUNetBackbone(unet2d.TINY_SDXL, latent_size=8, device="cpu")
    load_template(bb.unet, w["unet"])
    load_template(bb.vae, w["vae"])
    unet, vae = UNetXL(TINY_UNET), VAE(TINY_VAE)
    unet.load_state_dict(w["unet"])
    vae.load_state_dict(w["vae"])
    return bb, unet.requires_grad_(False), vae.requires_grad_(False)


def test_tiny_sdxl_eps_matches_the_reference(tiny):
    bb, unet, _ = tiny
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 8, 8, 4, generator=g)
    t = torch.tensor([20, 250, 600, 980])
    ctx = torch.randn(4, 77, 64, generator=g)
    pooled = torch.randn(4, 16, generator=g)
    with torch.no_grad():
        got = bb.predict_noise(x, t, ctx, text_embeds=pooled)
        want = unet(x, t, ctx, text_embeds=pooled,
                    time_ids=time_ids(bb.image_size, 4, "cpu"))
    # fp32 on both sides, 13 blocks deep: the order of summation in the
    # matmuls and GroupNorm's reductions (measured 4.3e-6 of the max)
    assert gap(got, want) < 2e-5
    # the text-time conditioning is live: other time ids, other eps
    with torch.no_grad():
        other = unet(x, t, ctx, text_embeds=pooled,
                     time_ids=time_ids(2 * bb.image_size, 4, "cpu"))
    assert gap(other, want) > 1e-3
    # the time ids are one buffer made with the backbone, not a tensor
    # copied to the device on every UNet pass
    assert bb.time_ids(4).data_ptr() == bb.time_ids(2).data_ptr()


def test_tiny_vae_gradient_to_the_image_matches_the_reference(tiny):
    bb, _, vae = tiny
    g = torch.Generator().manual_seed(6)
    img = torch.rand(2, 16, 16, 3, generator=g)
    cot = torch.randn(2, 8, 8, 4, generator=g)
    a = img.clone().requires_grad_(True)
    b = img.clone().requires_grad_(True)
    za = bb.encode_images(a)
    zb = vae.encode(b * 2.0 - 1.0)
    (za * cot).sum().backward()
    (zb * cot).sum().backward()
    # fp32 both ways through 5 convolution layers and the mid-block
    # attention, forward and backward (measured 1.7e-6 and 1.8e-6 of
    # the max)
    assert gap(za, zb) < 1e-5 and gap(a.grad, b.grad) < 1e-5


def test_full_width_preset_is_the_reference_model():
    model = json.loads((ROOT / "benchmark/configs/sdxl-base.json")
                       .read_text())
    bb = SDUNetBackbone(unet2d.SDXL, latent_size=128, device="meta")
    with torch.device("meta"):
        ref = UNetXL(model["unet"])
        ref_vae = VAE(model["vae"])

    def shapes(m):
        return {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes(bb.unet) == shapes(ref)
    assert shapes(bb.vae) == shapes(ref_vae)
    assert sum(p.numel() for p in bb.unet.parameters()) == 2_567_463_684
    assert bb.vae_cfg.scaling_factor == 0.13025 and bb.image_size == 1024
    assert bb.pooled_dim == 1280
    assert type(bb.unet) is unet2d.UNet2DConditionModelXL
    blocks = {k.split(".transformer_blocks.")[1].split(".")[0]
              for k in shapes(bb.unet) if ".transformer_blocks." in k}
    assert blocks == {str(i) for i in range(10)}
    assert any(k.startswith("add_embedding.linear_1.") for k in shapes(ref))


@pytest.mark.parametrize("preset,side", [("sd15", 64), ("sd21", 64),
                                         ("if_pixel", 64), ("tiny", 8),
                                         ("sdxl", 128), ("tiny_sdxl", 8)])
def test_latent_size_comes_from_the_preset(preset, side):
    bb = _build_backbone({"backbone": "sd_unet", "backbone_preset": preset},
                         "meta")
    assert bb.latent_size == side == bb.cfg.sample_size


def test_pooled_embedding_follows_the_context():
    texts = ["a", "", "a, side view", "a, front view", "a, back view",
             "a, overhead view"] + [""] * 4
    e, p = torch.tensor(mock_encode(texts, D=8)), torch.tensor(
        mock_pooled(texts, P=6))
    emb = PromptEmbedding(e[0], e[1], e[2:6], e[6:10], p[0], p[1], p[2:6],
                          p[6:10])
    el = torch.tensor([10.0, 70.0, 0.0, 5.0])
    az = torch.tensor([0.0, 30.0, 100.0, 170.0])
    for vd in (True, False):
        ctx = emb.get_text_embedding(el, az, None, vd)
        pooled = emb.get_pooled_embedding(el, az, None, vd)
        rows = [next(i for i in range(10) if torch.equal(e[i], c))
                for c in ctx]
        assert torch.equal(pooled, p[rows])
    ctx, _ = emb.get_text_embeddings_perp_neg(el, az, None)
    pooled = emb.get_pooled_embeddings_perp_neg(el, az, None)
    # the same interpolation of the view entries, row for row
    want, _ = PromptEmbedding(p[0][None], p[1][None], p[2:6, None],
                              p[6:10, None]).get_text_embeddings_perp_neg(
        el, az, None)
    assert ctx.shape[0] == pooled.shape[0] == 16
    assert torch.equal(pooled, want[:, 0])
    assert not torch.equal(torch.tensor(mock_pooled(["a"])),
                           torch.tensor(mock_pooled(["b"])))


def test_sdxl_overlay_trains_one_step_at_tiny_widths(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config([ROOT / "configs/base.yaml",
                       ROOT / "configs/guidance/sdxl.yaml",
                       ROOT / "configs/prompt/sd.yaml"], OVERRIDES)
    assert cfg["guidance"]["backbone_dtype"] == "bfloat16"
    tr = build_trainer(cfg, device="cpu")
    bb = tr.guidance.backbone
    assert bb.cfg == unet2d.TINY_SDXL
    emb = tr.prompt_processor()
    assert emb.text.shape == (77, 64) and emb.text_vd_pooled.shape == (4, 16)
    assert not (tmp_path / ".cache").exists()     # mock, uncached
    losses = []
    tr.fit(1, callback=lambda s, m: losses.append(float(m["loss_total"])))
    assert len(losses) == 1 and losses[0] > 0.0
    assert torch.isfinite(tr.state.scene.params["mean"]).all()


def test_a_traced_step_counts_every_block_of_the_stacks(tmp_path,
                                                        monkeypatch):
    """One profiled SDS step: a ``xformer`` span a Transformer2DModel (5
    at each stacked level, 1 in the mid block), one ``add_embed``, and a
    self-attention core a transformer block, all on the plain path on the
    CPU: (2 + 3) x 2 at the 16-token level, (2 + 3) x 3 + 3 at the 4-token
    level."""
    monkeypatch.chdir(tmp_path)
    cfg = load_config([ROOT / "configs/base.yaml",
                       ROOT / "configs/guidance/sdxl.yaml",
                       ROOT / "configs/prompt/sd.yaml"], OVERRIDES)
    tr = build_trainer(cfg, device="cpu")
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.fit(1)
    names = [e.name()[len(profiling.PREFIX):]
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profiling.PREFIX)]
    c = profiling.counters()
    assert names.count("unet") == 1
    assert names.count("xformer") == 11 and names.count("add_embed") == 1
    assert c["attn.plain"] == names.count("attn") == 10 + 18
    assert "attn.fused" not in c
    profiling.reset_counters()
    tr.fit(1)
    assert not any(k.startswith("attn.") for k in profiling.counters())
