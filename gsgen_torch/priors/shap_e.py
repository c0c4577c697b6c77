"""Shap-E decode from a latent, and text300M latent sampling.

Port of the JAX package's ``priors/shap_e.py`` (the reference's vendored
shap-e decode path, utils/shap_e_helper.py):

* :class:`ShapEDecoder` parses a shap-e transmitter / vector-decoder state
  dict: each NeRSTF MLP tensor is a per-tensor channels projection
  ``einsum('vd,vcd->vc')`` (plus a LayerNorm or a learned gain) of its
  slice of latent rows, in the checkpoint's key order; plain renderer MLP
  tensors are taken as they are.  Everything is inferred from shapes, as
  the JAX module does: the layer chain, the latent geometry, and the layer
  that takes the direction encoding (:meth:`ShapEDecoder.
  _infer_direction_slot`);
* :meth:`ShapEDecoder.query`: NeRF positional encoding, the relu MLP whose
  weights come from the latent, zero directions, heads sdf (tanh),
  density (exp) and channels (sigmoid);
* :meth:`ShapEDecoder.decode_mesh`: the SDF on a ``grid_size``³ lattice
  over [-bbox, bbox]³ with a -1 border, marching cubes
  (:mod:`..native.mcubes`, the port's copy of the JAX package's native
  marching tetrahedra), the colour head at the vertices, sRGB -> linear;
* :func:`sample_shap_e_latent`: text -> latent with the port's Point-E
  transformer (:class:`..guidance.point_e.PointEModel`, its geometry read
  from the text300M state dict) and Karras-Heun stage sampler
  (:func:`.point_e_sampler.make_stage_sampler`): 64 steps, CFG 15, sigma
  1e-3..160, no churn.

The MLP runs in torch on the decoder's device; the grid, marching cubes
and the colour conversion are the JAX module's numpy code.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def posenc_nerf(x: torch.Tensor, min_deg: int = 0, max_deg: int = 15
                ) -> torch.Tensor:
    """[x | sin(x 2^k) | sin(x 2^k + pi/2)] (encoding.py:200-214)."""
    if min_deg == max_deg:
        return x
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    emb = torch.sin(torch.cat([xb, xb + math.pi / 2.0], dim=-1))
    return torch.cat([x, emb], dim=-1)


def posenc_v1(x: torch.Tensor) -> torch.Tensor:
    """[cos(x 2^k) | sin(x 2^k)] per scalar (encoding.py:9-13)."""
    freqs = 2.0 ** torch.arange(0, 10, dtype=x.dtype, device=x.device)
    f = x.reshape(-1, 1) * freqs[None]
    out = torch.cat([torch.cos(f), torch.sin(f)], dim=1)
    return out.reshape(*x.shape[:-1], -1)


_POSENC = {"nerf": posenc_nerf, "v1": posenc_v1}
# the width of a zero direction's encoding
_DIR_DIM = {"nerf": 3 + 3 * 8 * 2, "v1": 16}


@dataclasses.dataclass
class ShapEProjection:
    """One meta tensor's channels projection (params_proj.py:93-136)."""

    weight: torch.Tensor            # [vectors, channels, d_latent]
    bias: torch.Tensor              # [vectors, channels]
    shape: Tuple[int, ...]          # the tensor's own shape
    ln_scale: Optional[torch.Tensor] = None   # the use_ln variant
    ln_bias: Optional[torch.Tensor] = None
    gain: Optional[torch.Tensor] = None       # the learned_scale variant

    def __call__(self, x_vd: torch.Tensor) -> torch.Tensor:
        h = torch.einsum("vd,vcd->vc", x_vd, self.weight)
        if self.ln_scale is not None:
            mu = torch.mean(h, dim=-1, keepdim=True)
            var = torch.var(h, dim=-1, keepdim=True, unbiased=False)
            h = (h - mu) / torch.sqrt(var + 1e-5)
            h = h * self.ln_scale + self.ln_bias
        elif self.gain is not None:
            h = h * self.gain[None, :]
        return (h + self.bias).reshape(self.shape)


@dataclasses.dataclass
class ShapEDecoder:
    """The transmitter / vector-decoder decode path, read from a
    checkpoint; its tensors live on ``device``."""

    projections: Dict[str, ShapEProjection]     # meta tensor -> projection
    direct: Dict[str, torch.Tensor]             # plain renderer tensors
    layer_dims: List[Tuple[int, int]]           # (d_in, d_out) a layer
    d_latent: int
    latent_ctx: int
    posenc_version: str = "nerf"
    insert_direction_at: Optional[int] = None
    latent_warp: str = "identity"               # identity | tan2
    n_output: int = 5        # sdf (1) + density (1) + channels (3)
    bbox: float = 1.0        # BoundingBoxVolume half-side

    @classmethod
    def from_state_dict(cls, state, posenc_version: str = "nerf",
                        latent_warp: str = "identity", bbox: float = 1.0,
                        device="cuda") -> "ShapEDecoder":
        """Parse a shap-e transmitter / vector_decoder state dict (tensors
        or arrays).  Keys matched anywhere in the tree:
        ``*params_proj.projections.<name>.proj.{weight,bias}``,
        ``*params_proj.projections.<name>.{norm.{weight,bias} | gain}`` and
        ``*renderer.*mlp.{i}.{weight,bias}`` (plain layers); projection
        names use ``__`` for ``.`` (params_proj.py:199)."""
        state = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in state.items()}
        proj_re = re.compile(
            r"params_proj\.projections\.([A-Za-z0-9_]+)\.(proj\.weight|"
            r"proj\.bias|norm\.weight|norm\.bias|gain)$")
        # insertion order matters: the latent rows are sliced a tensor at a
        # time in the checkpoint's key order (params_proj.py:166-174)
        groups: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, v in state.items():
            m = proj_re.search(k)
            if m:
                groups.setdefault(m.group(1), {})[m.group(2)] = v
        if not groups:
            raise ValueError(
                "no params_proj.projections.* keys found — not a shap-e "
                f"transmitter/decoder checkpoint ({len(state)} keys)")

        # a weight [out, in] flattens to (vectors = out, channels = in), a
        # bias [out] to (1, out) (flatten_param_shapes, params_proj.py:13-18)
        projections: Dict[str, ShapEProjection] = {}
        order: List[str] = []
        layer_w: Dict[int, Tuple[Optional[int], Optional[int]]] = {}
        totals: Dict[str, int] = {}
        d_latent = None
        for name_s, g in groups.items():
            full = name_s.replace("__", ".")
            m = re.search(r"(mlp\.(\d+)\.(weight|bias))$", full)
            if m is None:
                raise ValueError(f"unrecognized meta tensor {full!r}")
            # the canonical key, without the submodel prefix
            name = m.group(1)
            pw, pb = g["proj.weight"], g["proj.bias"]    # [v c, d_latent]
            d_latent = pw.shape[1]
            li, kind = int(m.group(2)), m.group(3)
            order.append(name)
            if kind == "weight":
                # resolved below, once the layer's bias has fixed `out`
                totals[name_s] = pw.shape[0]
            else:
                out = pw.shape[0]
                projections[name] = ShapEProjection(
                    weight=pw.reshape(1, out, d_latent),
                    bias=pb.reshape(1, out), shape=(out,),
                    ln_scale=g.get("norm.weight"), ln_bias=g.get("norm.bias"),
                    gain=g.get("gain"))
                layer_w[li] = (layer_w.get(li, (None, None))[0], out)

        # weight tensors: (out, in), out from the same layer's bias (meta
        # together in released checkpoints)
        for name_s, g in groups.items():
            m = re.search(r"(mlp\.(\d+)\.weight)$", name_s.replace("__", "."))
            if m is None:
                continue
            name, li = m.group(1), int(m.group(2))
            total, out = totals[name_s], layer_w[li][1]
            assert out is not None and total % out == 0, (name, total, out)
            inn = total // out
            layer_w[li] = (inn, out)
            projections[name] = ShapEProjection(
                weight=g["proj.weight"].reshape(out, inn, d_latent),
                bias=g["proj.bias"].reshape(out, inn), shape=(out, inn),
                ln_scale=g.get("norm.weight"), ln_bias=g.get("norm.bias"),
                gain=g.get("gain"))
        projections = {n: projections[n] for n in order}

        # the plain renderer MLP layers
        direct: Dict[str, torch.Tensor] = {}
        for k, v in state.items():
            m = re.search(r"renderer\..*?(mlp\.\d+\.(?:weight|bias))$", k)
            if m and "params_proj" not in k:
                direct[m.group(1)] = v
                lm = re.search(r"mlp\.(\d+)\.weight$", k)
                if lm:
                    layer_w[int(lm.group(1))] = (v.shape[1], v.shape[0])

        layer_dims = [layer_w[i] for i in range(max(layer_w) + 1)]
        latent_ctx = sum(int(np.prod(p.shape)) // p.shape[-1]
                         for p in projections.values())
        return cls(projections=projections, direct=direct,
                   layer_dims=layer_dims, d_latent=d_latent,
                   latent_ctx=latent_ctx, posenc_version=posenc_version,
                   insert_direction_at=cls._infer_direction_slot(
                       layer_dims, posenc_version),
                   latent_warp=latent_warp, n_output=layer_dims[-1][1],
                   bbox=bbox)

    @staticmethod
    def _infer_direction_slot(layer_dims, posenc_version):
        """A layer whose d_in exceeds the previous d_out by the direction
        encoding's width takes the concatenated direction."""
        d_dir = _DIR_DIM[posenc_version]
        for i in range(1, len(layer_dims)):
            if layer_dims[i][0] == layer_dims[i - 1][1] + d_dir:
                return i
        return None

    @property
    def device(self) -> torch.device:
        return next(iter(self.projections.values())).weight.device

    def unwarp(self, latent: torch.Tensor) -> torch.Tensor:
        if self.latent_warp == "tan2":
            scale = np.tan(np.tan(1.0))
            return torch.arctan(torch.arctan(latent * scale))
        return latent

    def mlp_params(self, latent) -> Dict[str, torch.Tensor]:
        """latent [latent_ctx * d_latent] (or [ctx, d]) -> the MLP's
        tensors (ChannelsDecoder.bottleneck_to_params, base.py:192-199)."""
        x = self.unwarp(torch.as_tensor(
            latent, dtype=torch.float32, device=self.device)).reshape(
            self.latent_ctx, self.d_latent)
        out = dict(self.direct)
        start = 0
        for name, proj in self.projections.items():
            v = int(np.prod(proj.shape)) // proj.shape[-1]
            out[name] = proj(x[start:start + v])
            start += v
        return out

    def query(self, params: Dict[str, torch.Tensor], pos: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        """The NeRSTF at [Q, 3] positions without a direction (its
        channels zero-filled): sdf, density and the colour channels."""
        h = _POSENC[self.posenc_version](pos)
        n = len(self.layer_dims)
        for i in range(n):
            if i == self.insert_direction_at:
                h = torch.cat([h, h.new_zeros(
                    *h.shape[:-1], _DIR_DIM[self.posenc_version])], dim=-1)
            h = h @ params[f"mlp.{i}.weight"].T + params[f"mlp.{i}.bias"]
            if i < n - 1:
                h = torch.relu(h)
        # the direction-independent head map (nerstf/mlp.py:127-146)
        return {"sdf": torch.tanh(h[..., 0:1]),
                "density": torch.exp(h[..., 1:2]),
                "channels": torch.sigmoid(h[..., 2:5])}

    @torch.no_grad()
    def _query_np(self, params, pts: np.ndarray, head: str,
                  query_batch: int) -> np.ndarray:
        return np.concatenate([
            self.query(params, torch.as_tensor(
                pts[i:i + query_batch], device=self.device))[head]
            .cpu().numpy() for i in range(0, pts.shape[0], query_batch)])

    def sdf_grid(self, params, grid_size: int = 128,
                 query_batch: int = 65536) -> np.ndarray:
        """The SDF of :meth:`mlp_params`' ``params`` at the ``grid_size``³
        lattice over [-bbox, bbox]³."""
        lo, hi = -self.bbox, self.bbox
        idx = np.arange(grid_size, dtype=np.float32)
        coords = lo + idx / (grid_size - 1) * (hi - lo)
        xs, ys, zs = np.meshgrid(coords, coords, coords, indexing="ij")
        pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)
        sdf = self._query_np(params, pts, "sdf", query_batch)[:, 0]
        return sdf.reshape(grid_size, grid_size, grid_size)

    def decode_mesh(self, latent, grid_size: int = 128,
                    query_batch: int = 65536, output_srgb: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """latent -> (verts [V, 3], rgb [V, 3] in [0, 1]): the
        decode_latent_mesh path (stf/renderer.py:170-268)."""
        from ..native.mcubes import marching_cubes

        params = self.mlp_params(latent)
        field = self.sdf_grid(params, grid_size, query_batch)
        # a -1 border closes every surface (stf/renderer.py:201-210)
        full = np.full((grid_size + 2,) * 3, -1.0, np.float32)
        full[1:-1, 1:-1, 1:-1] = field
        verts, _ = marching_cubes(full, 0.0)
        if verts.shape[0] == 0:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.float32))
        # grid index -> world: the padded grid's index range [0, grid + 1]
        # squeezed onto the box, as shap_e/rendering/mc.py:114-115 does
        lo, hi = -self.bbox, self.bbox
        verts_w = verts / (grid_size + 1) * (hi - lo) + lo
        return verts_w.astype(np.float32), self.vertex_colors(
            params, verts_w, query_batch, output_srgb)

    def vertex_colors(self, params, verts: np.ndarray,
                      query_batch: int = 65536, output_srgb: bool = True
                      ) -> np.ndarray:
        """The colour head at world-space vertices [V, 3], in [0, 1]
        (sRGB -> linear where ``output_srgb``, as the reference does)."""
        rgb = self._query_np(params, verts, "channels", query_batch)
        if output_srgb:
            rgb = np.where(rgb <= 0.04045, rgb / 12.92,
                           ((rgb + 0.055) / 1.055) ** 2.4)
        return rgb.astype(np.float32)


def text300m_config_from_state(state):
    """The text300M transformer's geometry from its state dict (its config
    yaml is a download): the CLIP text-vec point-diffusion transformer of
    Point-E over latent rows; 64-wide heads, the family's convention (a
    fused qkv does not reveal the head count)."""
    from ..guidance.point_e import PointEConfig
    w_in = state["input_proj.weight"]          # [width, C_in]
    layers = 1 + max(int(m.group(1)) for k in state
                     if (m := re.match(r"backbone\.resblocks\.(\d+)\.", k)))
    width = w_in.shape[0]
    return PointEConfig(
        input_channels=w_in.shape[1],
        output_channels=state["output_proj.weight"].shape[0], n_ctx=1024,
        width=width, layers=layers, heads=max(1, width // 64),
        clip_feature_dim=state["clip_embed.weight"].shape[1])


@torch.no_grad()
def sample_shap_e_latent(base_weights, textvec=None,
                         generator: Optional[torch.Generator] = None,
                         karras_steps: int = 64,
                         guidance_scale: float = 15.0,
                         sigma_min: float = 1e-3, sigma_max: float = 160.0,
                         cfg=None, device="cuda",
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Text -> Shap-E latent by Karras-Heun sampling
    (utils/shap_e_helper.py:17-42).  ``base_weights``: the text300M state
    dict, or a file of one; ``textvec`` [F] the prompt's projected CLIP
    text vector (None: zeros).  The starting noise [1, C, n_ctx] is drawn
    from ``generator`` unless ``noise`` is given; it is scaled by
    ``sigma_max``.  Returns the latent [n_ctx * C], flattened row by row
    (each latent vector a row)."""
    from ..guidance.convert import read_state_dict
    from ..guidance.point_e import PointEModel
    from .point_e_sampler import make_stage_sampler

    state = {k: v for k, v in read_state_dict(base_weights).items()
             if not k.startswith("clip.")}
    mcfg = cfg or text300m_config_from_state(state)
    model = PointEModel(mcfg, device=device).load_weights(state)
    del state
    sample, smax = make_stage_sampler(
        lambda x, t, cond=None, low_res=None: model.apply(x, t, cond=cond),
        karras_steps, sigma_min, sigma_max, 0.0, guidance_scale, "cosine")
    if textvec is None:
        textvec = torch.zeros(mcfg.clip_feature_dim)
    textvec = torch.as_tensor(textvec, device=device).float().reshape(1, -1)
    cond2 = torch.cat([textvec, torch.zeros_like(textvec)], dim=0)
    if noise is None:
        noise = torch.randn(1, mcfg.input_channels, mcfg.n_ctx,
                            generator=generator, device=device)
    x_T = torch.as_tensor(noise, device=device).float() * smax
    # the latent is x itself (channels-first rows are the latent vectors);
    # the shap-e diffusion config has no channel scale or bias
    lat = sample(x_T, cond2, None, generator=generator)
    return lat[0].T.reshape(-1)
