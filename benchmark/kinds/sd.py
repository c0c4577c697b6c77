"""gsgen's text-to-3D trainer under a latent diffusion model (SD 1.5 /
2.1: a UNet and a VAE), with SDS or VSD guidance.

:class:`Program` builds the port's trainer through its entry
(``gsgen_torch.config``) from the traffic file, puts weights drawn from
the seed into the UNet and the VAE (``convert.load_template``) and the
benchmark's embedding bank into the prompt processor.  :class:`Reference`
is the plain reference (``benchmark/reference/``) from the same seed.

The stages the check recomputes: ``eps``, every UNet call, and
``latent``, every VAE encode, of the first step.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Dict

import torch

from ..flops import step_flops
from ..reference.config import merged_config
from ..reference.quant import Precision
from ..reference.step import ReferenceRun
from ..trace import PREFIX, TAG, Spans
from ..weights import DTYPES, make_weights, mock_bank, split_trainable

FAULTS = ("half_batch", "unchanged")


def check_widths(bb, model: Dict) -> None:
    """The program's UNet and VAE have the configuration's widths."""
    u, v = model["unet"], model["vae"]
    c = bb.cfg
    heads = u["attention_head_dim"]
    want = dict(block_out_channels=tuple(u["block_out_channels"]),
                layers_per_block=u["layers_per_block"],
                cross_attention_dim=u["cross_attention_dim"],
                attention_head_dim=tuple(
                    heads if isinstance(heads, list)
                    else [heads] * len(u["block_out_channels"])),
                use_linear_projection=bool(u.get("use_linear_projection")),
                in_channels=u["in_channels"], out_channels=u["out_channels"])
    have = {k: getattr(c, k) for k in want}
    have["block_out_channels"] = tuple(have["block_out_channels"])
    have["attention_head_dim"] = tuple(have["attention_head_dim"])
    vc = bb.vae_cfg
    want.update(vae=(tuple(v["block_out_channels"]), v["layers_per_block"],
                     v["latent_channels"], v["scaling_factor"]))
    have.update(vae=(tuple(vc.block_out_channels), vc.layers_per_block,
                     vc.latent_channels, vc.scaling_factor))
    if want != have:
        bad = {k: (have[k], want[k]) for k in want if want[k] != have[k]}
        raise RuntimeError(f"the program's widths differ from the "
                           f"configuration's: {bad}")


def _copy(x):
    """A host copy (fp32 where floating), so that what the check keeps
    adds nothing to the device's peak."""
    if not torch.is_tensor(x):
        return x
    return x.detach().to("cpu", torch.float32 if x.is_floating_point()
                         else x.dtype, copy=True)


def _to(x, dev):
    return x.to(dev) if torch.is_tensor(x) else x


@contextlib.contextmanager
def _wrapped(obj, name: str, make):
    """``obj.<name>`` replaced by ``make(original)`` while open."""
    had = vars(obj).get(name)
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        if had is None:
            delattr(obj, name)
        else:
            setattr(obj, name, had)


@contextlib.contextmanager
def tap(unet, vae, record: Dict):
    """Record every UNet call (``record["eps"]``) and every VAE encode
    (``record["latent"]``) while open, as (args, kwargs, output) with
    detached fp32 host copies of the tensors."""
    eps = record.setdefault("eps", [])
    lat = record.setdefault("latent", [])

    def unet_forward(fwd):
        sig = inspect.signature(fwd)

        def call(*a, **kw):
            out = fwd(*a, **kw)
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            args = b.arguments
            names = list(args)
            eps.append(([_copy(args[n]) for n in names[:3]],
                        {n: _copy(args[n]) for n in names[3:]}, _copy(out)))
            return out
        return call

    def encode(enc):
        def call(x):
            z = enc(x)
            lat.append(([_copy(x)], {}, _copy(z)))
            return z
        return call

    with _wrapped(unet, "forward", unet_forward), \
            _wrapped(vae, "encode", encode):
        yield


class Program:
    """The port's trainer for this cell and seed, with the seed's weights
    and the benchmark's embedding bank in place."""

    def __init__(self, root, cell: Dict, seed: int, device: str):
        from gsgen_torch.config import build_trainer, load_config
        from gsgen_torch.guidance.convert import load_template
        from gsgen_torch.prompt.processors import PromptEmbedding

        tr, model = cell["traffic"], cell["model"]
        self.traffic, self.model = tr, model
        self.vsd = tr["guidance"] == "vsd"
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
        w = make_weights(model["unet"], model["vae"], seed, device, stated,
                         self.vsd)
        frozen, train = split_trainable(w["unet"])
        load_template(bb.unet, frozen)
        load_template(bb.vae, w["vae"])
        with torch.no_grad():
            for k, v in train.items():
                trainer.state.gp[k].copy_(v)
                trainer.guidance.trainable_params[k].copy_(v)
        del w, frozen, train
        bank = mock_bank(cfg.get("prompt", {}),
                         model["unet"]["cross_attention_dim"], device)
        trainer.prompt_processor.embedding = PromptEmbedding(**bank)
        self.trainer = trainer
        self.batch = int(cfg["trainer"]["batch_size"])
        self.spec = dict(paths=paths, overrides=overrides, bank=bank)

    def step(self, callback=None) -> None:
        self.trainer.fit(1, callback=callback)

    def leaves(self) -> Dict[str, torch.Tensor]:
        st = self.trainer.state
        return {**st.scene.params,
                **{f"gp/{k}": v for k, v in st.gp.items()}}

    def first_moments(self) -> Dict[str, torch.Tensor]:
        return self.trainer.state.opt.mu

    def tap(self, record: Dict):
        bb = self.trainer.guidance.backbone
        return tap(bb.unet, bb.vae, record)

    def instrument(self):
        return instrument(self.trainer, self.vsd)

    def fault(self, name: str):
        return fault(self.trainer, name)

    def flops(self) -> Dict[str, float]:
        return step_flops(self.model["unet"], self.model["vae"],
                          self.traffic, self.batch)


class Reference:
    """The plain reference of the cell's first steps from the seed, its
    UNet and VAE in the precision named for each (``"fp32"``, exact, by
    default; ``"tf32"``, ``"fp8"``, ``"int8"``: :mod:`..reference.quant`)."""

    def __init__(self, cell: Dict, spec: Dict, seed: int, device: str,
                 precision: Dict[str, str]):
        tr, model = cell["traffic"], cell["model"]
        w = make_weights(model["unet"], model["vae"], seed, device,
                         tr["precision"], tr["guidance"] == "vsd")
        self.ref = ReferenceRun(
            merged_config(spec["paths"], spec["overrides"]), model["unet"],
            model["vae"], w, spec["bank"], device,
            {k: Precision(precision.get(k, "fp32")) for k in ("unet", "vae")})
        self.exact = all(v == "fp32" for v in precision.values())

    def run(self, n_steps: int) -> Dict:
        stages: Dict = {}
        r = self.ref
        out = r.run(n_steps, first_step=lambda: tap(r.unet, r.vae, stages))
        out["stages"] = stages
        return out

    def judges(self):
        """Each stage recomputed by the exact reference's networks (their
        weights are the seed's: the LoRA leaves the steps move are kept
        apart from the module)."""
        if not self.exact:
            raise ValueError("only the exact reference judges")
        r = self.ref

        def on(fn):
            return lambda a, kw: fn(*[_to(x, r.dev) for x in a],
                                    **{k: _to(v, r.dev)
                                       for k, v in kw.items()})
        return {"eps": on(r.unet), "latent": on(r.vae.encode)}


@contextlib.contextmanager
def fault(trainer, name: str):
    """Plant ``name`` in the program for as long as the context is open:
    ``half_batch`` leaves half of each batch out of the guidance, the mean
    taken over the rest; ``unchanged`` makes a step that returns the state
    as it found it."""
    if name == "half_batch":
        g = trainer.guidance

        def half(orig):
            def loss(rgb, emb, el, az, dist, **kw):
                n, h = rgb.shape[0], rgb.shape[0] // 2
                kw = {k: v[:h] if torch.is_tensor(v) and v.dim() and
                      v.shape[0] == n else v for k, v in kw.items()}
                return orig(rgb[:h], emb, el[:h], az[:h], dist[:h], **kw)
            return loss

        with _wrapped(g, "loss", half):
            yield
    elif name == "unchanged":
        def still(orig):
            def step(*a, **kw):
                state = trainer.state
                out = orig(*a, **kw)
                trainer.state = state
                return out
            return step

        with _wrapped(trainer, "_train_step", still):
            yield
    else:
        raise ValueError(f"fault {name!r}, one of {FAULTS}")


@contextlib.contextmanager
def instrument(trainer, vsd: bool):
    """Spans around the render, the VAE (forward and, through autograd
    hooks, backward) and the UNet (every call; under VSD also the
    backward, from the gradient reaching the LoRA pass's output until the
    VAE backward starts: autograd takes that branch first), and the tag
    ``attn`` around every self-attention core, forward and backward,
    whichever path computes it."""
    from torch.profiler import record_function

    import gsgen_torch.guidance.unet2d as unet2d
    import gsgen_torch.training.trainer as trainer_mod

    bb = trainer.guidance.backbone
    spans = Spans()

    def render(orig):
        def call(*a, **kw):
            with record_function(PREFIX + "render"):
                return orig(*a, **kw)
        return call

    def vae_bwd_start(grad):
        spans.close("unet_bwd")
        spans.open("vae_bwd")

    def vae_bwd_stop(grad):
        spans.close("vae_bwd")
        spans.close("unet_bwd")

    def encode(orig):
        def call(imgs):
            if imgs.requires_grad:
                imgs.register_hook(vae_bwd_stop)
            with record_function(PREFIX + "vae"):
                z = orig(imgs)
            if z.requires_grad:
                z.register_hook(vae_bwd_start)
            return z
        return call

    def unet_fwd(orig):
        def call(*a, **kw):
            with record_function(PREFIX + "unet_fwd"):
                out = orig(*a, **kw)
            if vsd and out.requires_grad:
                out.register_hook(lambda g: spans.open("unet_bwd"))
            return out
        return call

    def self_attention(orig):
        """The core's backward is the stretch from the gradient reaching
        its output to the last of q, k and v receiving theirs."""
        def call(q, k, v, *a, **kw):
            if q.shape[1] != k.shape[1]:            # cross-attention
                return orig(q, k, v, *a, **kw)
            with record_function(PREFIX + TAG + "attn"):
                out = orig(q, k, v, *a, **kw)
            ins = [x for x in (q, k, v) if x.requires_grad]
            if out.requires_grad and ins:
                left = [0]

                def start(g):
                    left[0] = len(ins)
                    spans.open(TAG + "attn")

                def done(g):
                    left[0] -= 1
                    if left[0] == 0:
                        spans.close(TAG + "attn")

                out.register_hook(start)
                for x in ins:
                    x.register_hook(done)
            return out
        return call

    with contextlib.ExitStack() as stack:
        stack.callback(spans.close_all)
        stack.enter_context(_wrapped(trainer_mod, "render_batch", render))
        stack.enter_context(_wrapped(bb, "encode_images", encode))
        stack.enter_context(_wrapped(bb.unet, "forward", unet_fwd))
        for fn in ("flash_self_attention", "flash_self_attention_plain"):
            stack.enter_context(_wrapped(unet2d, fn, self_attention))
        yield
