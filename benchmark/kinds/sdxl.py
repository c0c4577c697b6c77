"""gsgen's text-to-3D trainer under SDXL base 1.0 (a UNet with stacked
transformer blocks and text-time conditioning, and the SD VAE at its own
scaling), with SDS guidance.

:class:`Program` builds the port's trainer through its entry
(``gsgen_torch.config``) as :mod:`.sd` does, puts weights drawn from the
seed into the UNet and the VAE by :mod:`..weights`' rule (over SDXL's
module skeleton, :class:`..reference.sdxl.UNetXL`) and the benchmark's
embedding bank, pooled embeddings included, into the prompt processor.
:class:`Reference` is :class:`..reference.sdxl.ReferenceRunXL` from the
same seed: its fp32 VAE encodes one view at a time under activation
checkpointing, so that the backward at 1024^2 fits on the card beside
the fp32 UNet.

The stages the check recomputes are :mod:`.sd`'s: ``eps``, every UNet
call, and ``latent``, every VAE encode, of the first step.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.config import merged_config
from ..reference.nets import VAE
from ..reference.quant import Precision
from ..reference.sdxl import ReferenceRunXL, UNetXL, time_ids
from ..trace import PREFIX, TAG
from ..weights import DTYPES, _fill, mock_bank, prompt_texts
from . import sd
from .sd import FAULTS, _wrapped, fault  # noqa: F401  (the kind's API)

TEXT_TIME = ("transformer_layers_per_block", "addition_embed_type",
             "addition_time_embed_dim",
             "projection_class_embeddings_input_dim", "sample_size")


def pooled_dim(unet_cfg: Dict) -> int:
    """The pooled text embedding's width: the added embedding's input
    less the six time ids' sinusoids."""
    return (unet_cfg["projection_class_embeddings_input_dim"]
            - 6 * unet_cfg["addition_time_embed_dim"])


def make_weights(unet_cfg: Dict, vae_cfg: Dict, seed: int, device,
                 dtypes: Dict[str, str]) -> Dict:
    """``{"unet": state, "vae": state}`` by :mod:`..weights`' rule (one
    normal draw a network from a generator seeded ``4 seed + 1``, scaled
    by leaf kind) over SDXL's state-dict names."""
    with torch.device("meta"):
        unet = UNetXL(unet_cfg)
        vae = VAE(vae_cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 4 + 1)
    return {"unet": _fill({k: v.shape for k, v in unet.state_dict().items()},
                          gen, DTYPES[dtypes["unet"]], device),
            "vae": _fill({k: v.shape for k, v in vae.state_dict().items()},
                         gen, DTYPES[dtypes["vae"]], device)}


def pooled_bank(prompt: Dict, width: int, device) -> Dict[str, torch.Tensor]:
    """gsgen's mock rule for the pooled embedding of each of the prompt's
    ten texts: the md5 of the text and 1 seed numpy's generator, whose
    normal draw of ``width`` is the vector."""
    vec = []
    for t in prompt_texts(prompt):
        s = int(hashlib.md5(t.encode()).hexdigest()[:8], 16)
        vec.append(np.random.default_rng([s, 1]).standard_normal(width))
    p = torch.as_tensor(np.stack(vec).astype(np.float32), device=device)
    return {"text_pooled": p[0], "uncond_pooled": p[1],
            "text_vd_pooled": p[2:6], "uncond_vd_pooled": p[6:10]}


def check_widths(bb, model: Dict) -> None:
    """:func:`.sd.check_widths`, and the transformer depths and the
    text-time widths."""
    sd.check_widths(bb, model)
    u = model["unet"]
    want = {k: tuple(u[k]) if isinstance(u[k], list) else u[k]
            for k in TEXT_TIME}
    have = {k: getattr(bb.cfg, k) for k in TEXT_TIME}
    if want != have:
        bad = {k: (have[k], want[k]) for k in want if want[k] != have[k]}
        raise RuntimeError(f"the program's widths differ from the "
                           f"configuration's: {bad}")


class Program(sd.Program):
    """The port's trainer for this cell and seed, with SDXL's weights from
    the seed and the benchmark's embedding bank in place."""

    def __init__(self, root, cell: Dict, seed: int, device: str):
        from gsgen_torch.config import build_trainer, load_config
        from gsgen_torch.guidance.convert import load_template
        from gsgen_torch.prompt.processors import PromptEmbedding

        tr, model = cell["traffic"], cell["model"]
        if tr["guidance"] != "sds":
            raise ValueError("the sdxl kind runs SDS")
        self.traffic, self.model, self.vsd = tr, model, False
        paths = [root / p for p in tr["port_configs"]]
        overrides = list(tr["overrides"]) + [
            f"trainer.seed={seed}",
            f"guidance.backbone_preset={model['port_preset']}"]
        cfg = load_config(paths, overrides)
        trainer = build_trainer(cfg, device=device)
        bb = trainer.guidance.backbone
        stated = tr["precision"]
        if (bb._unet_dtype(), bb._vae_dtype()) != (
                DTYPES[stated["unet"]], DTYPES[stated["vae"]]):
            raise RuntimeError(
                f"the program runs the UNet in {bb._unet_dtype()} and the "
                f"VAE in {bb._vae_dtype()}; the traffic states {stated}")
        check_widths(bb, model)
        w = make_weights(model["unet"], model["vae"], seed, device, stated)
        load_template(bb.unet, w.pop("unet"))
        load_template(bb.vae, w.pop("vae"))
        prompt = cfg.get("prompt", {})
        bank = {**mock_bank(prompt, model["unet"]["cross_attention_dim"],
                            device),
                **pooled_bank(prompt, pooled_dim(model["unet"]), device)}
        trainer.prompt_processor.embedding = PromptEmbedding(**bank)
        self.trainer = trainer
        self.batch = int(cfg["trainer"]["batch_size"])
        self.spec = dict(paths=paths, overrides=overrides, bank=bank)

    def instrument(self):
        return instrument(self.trainer)

    def flops(self) -> Dict[str, float]:
        return step_flops(self.model["unet"], self.model["vae"],
                          self.traffic, self.batch)


class Reference(sd.Reference):
    """The plain reference of the cell's first steps from the seed
    (:class:`..reference.sdxl.ReferenceRunXL`), its UNet and VAE in the
    precision named for each."""

    def __init__(self, cell: Dict, spec: Dict, seed: int, device: str,
                 precision: Dict[str, str]):
        tr, model = cell["traffic"], cell["model"]
        w = make_weights(model["unet"], model["vae"], seed, device,
                         tr["precision"])
        self.ref = ReferenceRunXL(
            merged_config(spec["paths"], spec["overrides"]), model["unet"],
            model["vae"], w, spec["bank"], device,
            {k: Precision(precision.get(k, "fp32")) for k in ("unet", "vae")})
        self.exact = all(v == "fp32" for v in precision.values())


@contextlib.contextmanager
def instrument(trainer):
    """:func:`.sd.instrument`'s spans, and the tag ``xformer`` around
    every Transformer2DModel's forward (the boundary of the program's
    ``xformer`` span)."""
    from torch.profiler import record_function

    from gsgen_torch.guidance.unet2d import Transformer2DModel

    def tagged(orig):
        def call(*a, **kw):
            with record_function(PREFIX + TAG + "xformer"):
                return orig(*a, **kw)
        return call

    with contextlib.ExitStack() as stack:
        stack.enter_context(sd.instrument(trainer, False))
        for m in trainer.guidance.backbone.unet.modules():
            if isinstance(m, Transformer2DModel):
                stack.enter_context(_wrapped(m, "forward", tagged))
        yield


def step_flops(unet_cfg: Dict, vae_cfg: Dict, traffic: Dict,
               batch: int) -> Dict[str, float]:
    """A step's FLOPs by precision, counted on the reference's networks on
    the meta device (``torch.utils.flop_counter``): the UNet passes the
    traffic lists and the VAE encode of ``batch`` views, forward and
    backward to the image; the render left out."""
    prec = traffic["precision"]
    lat = int(unet_cfg["sample_size"])
    img = lat * 2 ** (len(vae_cfg["block_out_channels"]) - 1)
    meta = dict(device="meta")
    with torch.device("meta"):
        unet = UNetXL(unet_cfg).requires_grad_(False)
        vae = VAE(vae_cfg).requires_grad_(False)
    out: Dict[str, float] = {}

    def count(dtype, fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        out[dtype] = out.get(dtype, 0.0) + float(fc.get_total_flops())

    def unet_pass(b):
        with torch.no_grad():
            unet(torch.empty(b, lat, lat, unet_cfg["in_channels"], **meta),
                 torch.zeros(b, dtype=torch.long, **meta),
                 torch.empty(b, 77, unet_cfg["cross_attention_dim"], **meta),
                 text_embeds=torch.empty(b, pooled_dim(unet_cfg), **meta),
                 time_ids=time_ids(img, b, "meta"))

    def vae_pass():
        x = torch.empty(batch, img, img, 3, requires_grad=True, **meta)
        vae.encode(x).sum().backward()

    for p in traffic["unet_passes"]:
        if p.get("grad") or p.get("lora"):
            raise ValueError("the sdxl kind runs the frozen UNet forward")
        count(prec["unet"], lambda p=p: unet_pass(p["batch"]))
    count(prec["vae"], vae_pass)
    return out
