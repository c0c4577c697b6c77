"""The reference against the port at the TINY widths on the CPU: the
UNet (with LoRA and the camera embedding), the VAE encode, the render and
its gradients, and a whole training step with the program in fp32."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import check, run
from benchmark.kinds import sd
from benchmark.reference.nets import UNet, VAE
from benchmark.reference.render import render_view
from benchmark.tests.tiny import REPO, TINY_UNET, TINY_VAE, write_root
from benchmark.weights import make_weights, split_trainable
from gsgen_torch.guidance.convert import load_template
from gsgen_torch.guidance.unet2d import TINY_VSD, UNet2DConditionModel
from gsgen_torch.guidance.vae import TINY_VAE as PORT_TINY_VAE
from gsgen_torch.guidance.vae import AutoencoderKL
from gsgen_torch.models.scene import RenderConfig, make_scene, render_batch
from gsgen_torch.ops.camera import CameraIntrinsics


def _close(a, b, tol):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.fixture(scope="module")
def weights():
    return make_weights(TINY_UNET, TINY_VAE, 3, "cpu",
                        {"unet": "float32", "vae": "float32"}, vsd=True)


def test_unet_matches_the_port(weights):
    port = UNet2DConditionModel(TINY_VSD)
    frozen, train = split_trainable(weights["unet"])
    load_template(port, frozen)
    port.load_state_dict(train, strict=False)
    ref = UNet(TINY_UNET, lora_rank=4, class_embed_proj_dim=16)
    ref.load_state_dict(weights["unet"])
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, 8, 4, generator=g)
    t = torch.tensor([10, 500, 990])
    ctx = torch.randn(3, 77, 1024, generator=g)
    cam = torch.randn(3, 16, generator=g)
    with torch.no_grad():
        for ls, c in ((0.0, None), (1.0, cam)):
            assert _close(ref(x, t, ctx, class_labels=c, lora_scale=ls),
                          port(x, t, ctx, class_labels=c, lora_scale=ls),
                          1e-5)


def test_vae_encode_matches_the_port(weights):
    port = AutoencoderKL(PORT_TINY_VAE)
    load_template(port, weights["vae"])
    ref = VAE(TINY_VAE)
    ref.load_state_dict(weights["vae"])
    img = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    a, b = img.clone().requires_grad_(), img.clone().requires_grad_()
    za, zb = ref.encode(a * 2 - 1), port.encode(b * 2 - 1)
    assert _close(za, zb, 1e-5)
    (za ** 2).sum().backward()
    (zb ** 2).sum().backward()
    assert _close(a.grad, b.grad, 1e-5)


def test_render_and_its_gradients_match_the_port():
    rng = np.random.default_rng(4)
    n, m, reso = 48, 64, 32
    rcfg = RenderConfig(tile_size=8, chunk=128, dup_cap=8192)
    mean = torch.as_tensor(rng.normal(0, 0.5, (n, 3)), dtype=torch.float32)
    scene = make_scene(mean, torch.as_tensor(rng.normal(size=(n, 4)),
                                             dtype=torch.float32),
                       torch.as_tensor(rng.uniform(0.02, 0.08, (n, 3)),
                                       dtype=torch.float32),
                       torch.as_tensor(rng.uniform(0.1, 0.9, (n, 3)),
                                       dtype=torch.float32),
                       torch.full((n,), 0.7), rcfg, capacity=m)
    c2w = torch.tensor([[0.0, 0.0, -1.0, 2.5], [1.0, 0.0, 0.0, 0.1],
                        [0.0, -1.0, 0.0, 0.2]])
    f = 0.9 * reso
    intr = CameraIntrinsics(fx=f, fy=f, cx=reso / 2, cy=reso / 2, w=reso,
                            h=reso, near=0.01, far=100.0)
    bg = torch.tensor([0.2, 0.5, 0.9])
    fx = torch.tensor([1.1 * f])
    pa = {k: v.clone().requires_grad_() for k, v in scene.params.items()}
    pb = {k: v.clone().requires_grad_() for k, v in scene.params.items()}
    port = render_batch(pa, scene.active, c2w[None], intr, rcfg, bg[None],
                        fx, fx, torch.tensor([reso / 2]),
                        torch.tensor([reso / 2]), rgb_only=True)["rgb"][0]
    view = dict(c2w=c2w, fx=fx[0], fy=fx[0], cx=reso / 2, cy=reso / 2)
    ref = render_view(pb, scene.active, view, bg,
                      dict(frustum_culling_radius=6.0, T_thresh=1e-4,
                           tile_size=8, tile_culling_radius=6.0,
                           svec_act="exp", alpha_act="sigmoid",
                           color_act="sigmoid", near=1e-3),
                      f, reso, 0.01, 100.0)
    assert _close(ref, port, 1e-5)
    w = torch.rand(reso, reso, 3, generator=torch.Generator().manual_seed(5))
    (port * w).sum().backward()
    (ref * w).sum().backward()
    for k in ("mean", "qvec", "svec", "color", "alpha"):
        assert _close(pb[k].grad, pa[k].grad, 1e-4), k


@pytest.mark.parametrize("kind", ["sds", "vsd"])
def test_a_step_matches_the_program_in_fp32(kind, tmp_path, monkeypatch):
    """With the program's UNet and VAE in fp32, the reference follows its
    first step from the same seed: the same draws, loss and gradients."""
    monkeypatch.chdir(tmp_path)
    name = write_root(tmp_path, kind)
    p = tmp_path / "benchmark" / "traffic" / f"{kind}-16.json"
    tr = json.loads(p.read_text())
    tr["overrides"].append("guidance.backbone_dtype=null")
    tr["precision"] = {"unet": "float32", "vae": "float32"}
    p.write_text(json.dumps(tr))
    cell = run.load_cell(tmp_path, name)
    seed = 2 ** 32 + 7
    program = sd.Program(tmp_path, cell, seed, "cpu")
    prog = check.program_steps(program, 1)
    ref = sd.Reference(cell, program.spec, seed, "cpu", {})
    ref_out = ref.run(1)
    got = check.compare(prog, ref_out, ref.judges())
    assert got["loss_gap"]["value"] < 1e-5, got
    assert got["grad_gap"]["value"] < 1e-3, got
    # each UNet call (3 under VSD) and the VAE encode, recomputed from the
    # program's own inputs
    assert [len(prog["stages"][k]) for k in ("eps", "latent")] == [
        3 if kind == "vsd" else 1, 1]
    # fp32 against fp32, the convolutions' algorithms apart (bf16 reads
    # about 1e-2)
    assert got["eps_gap"]["value"] < 1e-4, got
    assert got["latent_gap"]["value"] < 1e-4, got
    assert set(prog["grads"]) == set(ref_out["grads"])


def test_tiny_cell_and_port_presets_agree():
    assert dataclasses.replace(TINY_VSD, lora_rank=0,
                               class_embed_proj_dim=None).block_out_channels \
        == tuple(TINY_UNET["block_out_channels"])
    assert (REPO / "configs" / "base.yaml").exists()
