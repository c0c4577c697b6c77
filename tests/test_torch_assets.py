"""gsgen_torch's asset inits against the JAX package, on the CPU.

``load_point_cloud`` (``.npy`` with and without colours, ``.npz``, binary
and ascii ``.ply``), ``load_mesh`` (``.obj`` with polygons and negative
indices, binary and ascii ``.ply``), ``mesh_init_arrays`` (the same
seeded numpy draws in both packages, with the axis flips), the Shap-E
decoder on random ``vector_decoder``-layout state dicts made with numpy
(LayerNorm / gain / plain projections, both positional encodings, a
direction slot and a plain last layer), ``decode_mesh`` at a small grid,
the text300M latent sampler on a tiny config with the JAX draws injected,
and ``init.type`` ``point_cloud``, ``mesh`` and ``shap_e`` (from a latent
``.npy`` and a decoder written as safetensors) through ``build_trainer``
against the JAX package's.

Tolerances: the readers and the numpy init arrays exactly; the Shap-E
projections, queries, mesh vertices, colours (at the same vertices) and
``shap_e_init_arrays`` within 1e-5 of their largest value (the acceptance
limit: fp32 einsums and sines in two libraries), the colours at each
package's own vertices within 1e-3 (the encoding's 2^14 frequency
amplifies the vertices' last bits); the text300M latent within 1e-3 of its
largest value, and 99.9% of its elements within 2e-4: 8 Karras-Heun steps
at CFG 15 multiply each evaluation's rounding by up to 1 + 2·15, so a few
of 8,192 elements move by up to 4.1e-4 (CFG 3 on the same model: 2.0e-4;
4 steps at CFG 15: 1.1e-2).
"""

import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import gsgen_tpu.priors as priors_j
from gsgen_tpu.config import build_trainer as build_trainer_j
from gsgen_tpu.config import load_config as load_config_j
from gsgen_tpu.guidance import convert as conv_j
from gsgen_tpu.guidance import point_e as pe_j
from gsgen_tpu.priors import shap_e as shap_j
from gsgen_torch import priors
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.guidance import point_e as pe
from gsgen_torch.priors import shap_e

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["init.num_points=96", "init.capacity=128", "data.reso=[32]",
         "renderer.tile_size=8", "renderer.chunk=128",
         "renderer.dup_cap=4096", "trainer.batch_size=2",
         "prompt.use_cache=false", "guidance.type=mock"]


def _close(got, want, share, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=share * scale, err_msg=what)


def _same(got, want):
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# ---- point clouds and meshes ----

def _ply(path, verts, rgb=None, faces=None, ascii_=False):
    props = [("float", n) for n in "xyz"]
    if rgb is not None:
        props += [("uchar", n) for n in ("red", "green", "blue")]
    head = ["ply", "format " + ("ascii 1.0" if ascii_
                                else "binary_little_endian 1.0"),
            f"element vertex {len(verts)}"]
    head += [f"property {t} {n}" for t, n in props]
    if faces is not None:
        head += [f"element face {len(faces)}",
                 "property list uchar int vertex_indices"]
    head.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        for i, v in enumerate(verts):
            row = list(v) + ([] if rgb is None else list(rgb[i]))
            if ascii_:
                f.write((" ".join(str(x) for x in row) + "\n").encode())
            else:
                f.write(struct.pack("<3f", *v))
                if rgb is not None:
                    f.write(struct.pack("<3B", *rgb[i]))
        for face in faces if faces is not None else ():
            if ascii_:
                f.write((" ".join(str(x) for x in [len(face), *face])
                         + "\n").encode())
            else:
                f.write(struct.pack(f"<B{len(face)}i", len(face), *face))


def _cube():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32) * 0.7 + [0.1, -0.2, 0.3]
    quads = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6],
             [0, 2, 6, 4], [1, 5, 7, 3]]
    return v.astype(np.float32), quads


@pytest.mark.parametrize("fmt", ["npy6", "npy3", "npz", "ply", "ply_ascii"])
def test_load_point_cloud_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(1)
    xyz = rng.standard_normal((50, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (50, 3))
    path = tmp_path / ("cloud." + fmt[:3] if fmt != "npz" else "cloud.npz")
    if fmt == "npy6":
        np.save(path, np.concatenate([xyz, rgb / 255.0], 1))
    elif fmt == "npy3":
        np.save(path, xyz)
    elif fmt == "npz":
        np.savez(path, xyz=xyz, rgb=rgb / 255.0)
    else:
        _ply(path, xyz, rgb, ascii_=fmt == "ply_ascii")
    got = priors.load_point_cloud(path)
    _same(got, priors_j.load_point_cloud(path))
    np.testing.assert_allclose(got[0], xyz, rtol=1e-6)
    assert (got[1] is None) == (fmt == "npy3")


@pytest.mark.parametrize("fmt", ["obj", "ply", "ply_ascii"])
def test_load_mesh_matches_jax(tmp_path, fmt):
    verts, quads = _cube()
    path = tmp_path / ("cube." + fmt[:3])
    if fmt == "obj":
        lines = [f"v {x} {y} {z}" for x, y, z in verts] + ["vt 0 0"]
        # 1-based, "i/t" forms and negative (relative) indices
        lines += ["f " + " ".join(f"{i + 1}/1" for i in q)
                  for q in quads[:3]]
        lines += ["f " + " ".join(str(i - len(verts)) for i in q)
                  for q in quads[3:]]
        path.write_text("# cube\n\n" + "\n".join(lines) + "\n")
    else:
        _ply(path, verts, faces=quads, ascii_=fmt == "ply_ascii")
    got = priors.load_mesh(path)
    _same(got, priors_j.load_mesh(path))
    assert got[1].shape == ((12 if fmt != "ply_ascii" else 6), 3)


@pytest.mark.parametrize("flips", [(False, False), (True, False),
                                   (False, True)])
def test_mesh_init_arrays_match_jax(tmp_path, flips):
    verts, quads = _cube()
    _ply(tmp_path / "cube.ply", verts, faces=quads)
    kw = dict(num_points=300, mean_std=0.5, flip_yz=flips[0],
              flip_xy=flips[1], seed=3)
    got = priors.mesh_init_arrays(tmp_path / "cube.ply", **kw)
    want = priors_j.mesh_init_arrays(tmp_path / "cube.ply", **kw)
    _same(got, want)
    assert got[0].shape == (300, 3)
    assert np.linalg.norm(got[0], axis=-1).max() == pytest.approx(0.5, 1e-4)


# ---- Shap-E ----

D_LATENT = 8
POSENC_IN = {"nerf": 3 + 3 * 15 * 2, "v1": 3 * 20}
DIR_DIM = {"nerf": 51, "v1": 16}


def decoder_state(seed, posenc="nerf", variant="ln", hidden=16, layers=3,
                  direction_at=None, plain_last=False, n_out=8):
    """A random state dict in shap-e's ``vector_decoder`` layout, numpy:
    ``params_proj.projections.nerstf__mlp__<i>__{weight,bias}`` (with a
    LayerNorm (``variant`` "ln"), a learned gain ("gain") or neither) for
    the meta layers, ``renderer.nerstf.mlp.<i>.*`` for a plain last
    layer; scaled so that the MLP's weights come out near 1/sqrt(fan_in).
    Returns (state, latent_ctx)."""
    rng = np.random.default_rng(seed)
    dims = [(POSENC_IN[posenc], hidden)] + [(hidden, hidden)] * (
        layers - 1) + [(hidden, n_out)]
    if direction_at is not None:
        dims[direction_at] = (hidden + DIR_DIM[posenc], hidden)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    state, ctx = {}, 0
    for i, (inn, out) in enumerate(dims):
        if plain_last and i == len(dims) - 1:
            state[f"renderer.nerstf.mlp.{i}.weight"] = f32(out, inn) \
                / inn ** .5
            state[f"renderer.nerstf.mlp.{i}.bias"] = 0.1 * f32(out)
            continue
        for kind, (v, c) in (("weight", (out, inn)), ("bias", (1, out))):
            pre = f"params_proj.projections.nerstf__mlp__{i}__{kind}"
            std = (1.0 if variant == "plain" else c ** .5) / (
                c * D_LATENT) ** .5
            state[f"{pre}.proj.weight"] = f32(v * c, D_LATENT) * std
            state[f"{pre}.proj.bias"] = f32(v * c) * 0.1 / c ** .5
            if variant == "ln":
                state[f"{pre}.norm.weight"] = (1 + 0.1 * f32(c)) / c ** .5
                state[f"{pre}.norm.bias"] = 0.1 * f32(c) / c ** .5
            elif variant == "gain":
                state[f"{pre}.gain"] = (1 + 0.1 * f32(c)) / c ** .5
            ctx += v
    return state, ctx


DECODERS = {
    "nerf_ln": dict(),
    "v1_gain": dict(posenc="v1", variant="gain"),
    "nerf_plain_dir": dict(variant="plain", layers=4, direction_at=2,
                           plain_last=True),
}


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_shap_e_decoder_matches_jax(name):
    kw = DECODERS[name]
    state, ctx = decoder_state(4, **kw)
    pv = kw.get("posenc", "nerf")
    dec = shap_e.ShapEDecoder.from_state_dict(state, posenc_version=pv,
                                              device="cpu")
    dec_j = shap_j.ShapEDecoder.from_state_dict(state, posenc_version=pv)
    assert (dec.layer_dims, dec.d_latent, dec.latent_ctx,
            dec.insert_direction_at, dec.n_output) == (
        dec_j.layer_dims, dec_j.d_latent, dec_j.latent_ctx,
        dec_j.insert_direction_at, dec_j.n_output)
    assert dec.latent_ctx == ctx
    assert dec.insert_direction_at == kw.get("direction_at")
    assert list(dec.projections) == list(dec_j.projections)
    rng = np.random.default_rng(5)
    latent = rng.standard_normal(ctx * D_LATENT).astype(np.float32)
    p_t = dec.mlp_params(latent)
    p_j = dec_j.mlp_params(jnp.asarray(latent))
    assert set(p_t) == set(p_j)
    for k in p_j:
        _close(p_t[k].numpy(), p_j[k], 1e-5, k)
    pos = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    q_t = dec.query(p_t, torch.from_numpy(pos))
    q_j = dec_j.query(p_j, jnp.asarray(pos))
    for k in ("sdf", "density", "channels"):
        _close(q_t[k].numpy(), q_j[k], 1e-5, k)
    for x in (pos, pos[:7, :3]):
        for f, f_j in ((lambda a: shap_e.posenc_nerf(a), shap_j.posenc_nerf),
                       (shap_e.posenc_v1, shap_j.posenc_v1)):
            _close(f(torch.from_numpy(x)).numpy(), f_j(jnp.asarray(x)), 1e-6)


def _surface_latent(dec, seed):
    """A latent drawn from a seed (seed 7 with decoder_state(6): a field
    that crosses zero inside the grid)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(dec.latent_ctx * dec.d_latent).astype(
        np.float32)


def test_decode_mesh_matches_jax():
    state, _ = decoder_state(6, variant="plain")
    dec = shap_e.ShapEDecoder.from_state_dict(state, device="cpu")
    dec_j = shap_j.ShapEDecoder.from_state_dict(state)
    latent = _surface_latent(dec, 7)
    verts, rgb = dec.decode_mesh(latent, grid_size=20, query_batch=2048)
    verts_j, rgb_j = dec_j.decode_mesh(latent, grid_size=20,
                                       query_batch=2048)
    assert verts.shape[0] > 100 and verts.shape == verts_j.shape
    _close(verts, verts_j, 1e-5, "verts")
    # the colours at the same vertices: the positional encoding's top
    # frequency (2^14) turns the vertices' last-bit differences into ~1e-4
    _close(dec.vertex_colors(dec.mlp_params(latent), verts_j), rgb_j, 1e-5,
           "rgb")
    _close(rgb, rgb_j, 1e-3, "rgb at the port's own vertices")
    assert np.abs(verts).max() <= dec.bbox + 1e-4
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0


def test_text300m_sampler_matches_jax(tmp_path):
    """A tiny text300M-shaped transformer written as safetensors: the
    geometry read from it, and 8 Karras-Heun steps at CFG 15 from the JAX
    sampler's own starting noise (its first split key)."""
    # 64 wide: one 64-wide head, as the geometry inference assumes
    cfg = pe.PointEConfig(input_channels=8, output_channels=16, n_ctx=1024,
                          width=64, layers=2, heads=1, clip_feature_dim=12)
    g = torch.Generator().manual_seed(8)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=g)
             for k, v in pe.PointEModel(cfg, device="cpu", seed=9)
             .module.state_dict().items()}
    path = tmp_path / "text300m.safetensors"
    save_file(state, str(path))
    got_cfg = shap_e.text300m_config_from_state(state)
    assert got_cfg == cfg
    assert shap_j.text300m_config_from_state(
        {k: v.numpy() for k, v in state.items()}) == pe_j.PointEConfig(
        input_channels=8, output_channels=16, n_ctx=1024, width=64,
        layers=2, heads=1, clip_feature_dim=12)
    tv = np.random.default_rng(10).standard_normal(12).astype(np.float32)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                         (1, 8, 1024)))
    lat = shap_e.sample_shap_e_latent(str(path), tv, karras_steps=8,
                                      device="cpu", noise=torch.tensor(noise))
    lat_j = shap_j.sample_shap_e_latent(conv_j.load_safetensors(str(path)),
                                        jnp.asarray(tv), key, karras_steps=8)
    assert lat.shape == (8 * 1024,)
    _close(lat.numpy(), lat_j, 1e-3)
    near = np.abs(lat.numpy() - np.asarray(lat_j)) <= 2e-4
    assert near.mean() >= 0.999, near.mean()


@pytest.fixture
def asset_dirs(tmp_path, monkeypatch):
    """Separate asset caches for the two packages (each must compute its
    own cloud)."""
    monkeypatch.setenv("GSGEN_ASSET_DIR", str(tmp_path / "assets_t"))
    monkeypatch.setattr(priors_j, "ASSET_DIR", str(tmp_path / "assets_j"))
    return tmp_path


def _init_case(case, folder):
    """The config overrides of one asset init, its files written."""
    if case == "point_cloud":
        rng = np.random.default_rng(12)
        xyz = rng.standard_normal((96, 3)).astype(np.float32) * 0.4
        _ply(folder / "cloud.ply", xyz, rng.integers(0, 256, (96, 3)))
        return ["init.type=point_cloud", f"init_asset={folder / 'cloud.ply'}"]
    if case == "mesh":
        verts, quads = _cube()
        _ply(folder / "cube.ply", verts, faces=quads)
        return ["init.type=mesh", f"init.mesh={folder / 'cube.ply'}",
                "init.flip_yz=true", "init.seed=2"]
    state, _ = decoder_state(6, variant="plain")
    dec = shap_e.ShapEDecoder.from_state_dict(state, device="cpu")
    np.save(folder / "latent.npy", _surface_latent(dec, 7))
    save_file({k: torch.from_numpy(v) for k, v in state.items()},
              str(folder / "decoder.safetensors"))
    return ["init.type=shap_e", f"init.shap_e_latent={folder / 'latent.npy'}",
            f"init.shap_e_decoder={folder / 'decoder.safetensors'}",
            "init.grid_size=20", "init.random_color=false"]


@pytest.mark.parametrize("case", ["point_cloud", "mesh", "shap_e"])
def test_asset_init_through_config_matches_jax(asset_dirs, case):
    over = SMALL + _init_case(case, asset_dirs)
    base = ROOT / "configs" / "base.yaml"
    tr = build_trainer(load_config(base, over), device="cpu")
    tj = build_trainer_j(load_config_j(base, over))
    st, sj = tr.state.scene, tj.state.scene
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(sj.active))
    n = int(st.active.sum())
    assert n == 96
    _close(st.params["mean"].numpy()[:n], np.asarray(sj.params.mean)[:n],
           1e-5, "mean")
    # Shap-E's colours come from each package's own vertices (1e-3 above)
    _close(st.params["color"].numpy()[:n], np.asarray(sj.params.color)[:n],
           1e-3 if case == "shap_e" else 1e-5, "color")
    if case == "shap_e":
        # the cache: a second build needs no decoder
        prompt = load_config(base)["prompt"]["prompt"]
        cached = priors._asset_path(prompt, "shap_e")
        assert cached.exists()
        xyz, rgb = priors.shap_e_generate(prompt, num_points=10)
        assert xyz.shape == (10, 3) and rgb.shape == (10, 3)
    m = tr.train_step(0)
    assert np.isfinite(float(m["loss_total"]))
