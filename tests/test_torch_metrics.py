"""The port's Adan, quality metrics, lens (un)distortion and COLMAP loader
against the JAX package.

The same numpy inputs go through both packages on the CPU; tolerances:

* Adan: 5 steps on injected gradients, with and without weight decay:
  parameters and moments within 1e-6 (abs and rel);
* PSNR within 1e-5 dB, SSIM within 1e-6 (fp32 summation order);
* LPIPS: the random JAX tree carried over by ``lpips_params_from_jax``,
  and both packages' ``load_lpips_params`` on the same ``.pth`` files:
  the trees equal (HWIO against OIHW), the distance within rel 1e-5;
* undistort: the distortion functions within 1e-6, the Newton inverses
  within 1e-5, gradients (autograd against ``jax.grad``) of the inputs
  and the parameters within rel 1e-4 / abs 1e-5;
* COLMAP: binary and text models written by the test, with and without
  downsampling: the intrinsics, names, points and colours equal, the
  c2ws within 1e-6.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.data import colmap as colmap_j
from gsgen_tpu.tools import undistort as und_j
from gsgen_tpu.training import adan as adan_j
from gsgen_tpu.utils import metrics as metrics_j
from gsgen_torch.data import colmap as colmap_t
from gsgen_torch.tools import undistort as und_t
from gsgen_torch.training import adan as adan_t
from gsgen_torch.utils import metrics as metrics_t


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


# ---- Adan ----

@pytest.mark.parametrize("weight_decay", [0.0, 0.02])
def test_adan_matches_jax(weight_decay):
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sj, st = adan_j.adan_init(pj), adan_t.adan_init(pt)
    for i, g in enumerate(grads):
        lr = 0.01 * (i + 1)
        pj, sj = adan_j.adan_update({k: jnp.asarray(v) for k, v in g.items()},
                                    sj, pj, lr, weight_decay=weight_decay)
        pt, st = adan_t.adan_update({k: torch.from_numpy(v) for k, v in
                                     g.items()}, st, pt, lr,
                                    weight_decay=weight_decay)
    assert st.count == int(sj.count) == 5
    for k in p0:
        for a, b in ((pt[k], pj[k]), (st.m[k], sj.m[k]), (st.v[k], sj.v[k]),
                     (st.n[k], sj.n[k]), (st.g_prev[k], sj.g_prev[k])):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)
    assert np.abs(_np(pt["a"]) - p0["a"]).max() > 1e-3


def test_adan_first_step_has_no_gradient_difference():
    """At count 1 the difference term is 0: v stays 0 whatever g_prev
    holds."""
    p = {"x": torch.ones(3)}
    st = adan_t.adan_init(p)
    st.g_prev["x"] = torch.full((3,), 7.0)
    _, st1 = adan_t.adan_update({"x": torch.full((3,), 2.0)}, st, p, 0.1)
    assert torch.equal(st1.v["x"], torch.zeros(3))


# ---- PSNR / SSIM / LPIPS ----

def _images(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_ssim_match_jax():
    a, b = _images(1, (32, 32, 3))
    np.testing.assert_allclose(
        float(metrics_t.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(metrics_j.psnr(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    np.testing.assert_allclose(
        float(metrics_t.ssim(torch.from_numpy(a), torch.from_numpy(b))),
        float(metrics_j.ssim(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    same = torch.from_numpy(a)
    assert float(metrics_t.psnr(same, same)) == pytest.approx(120.0)


@pytest.mark.parametrize("batched", [False, True])
def test_lpips_from_jax_params(batched):
    pj = metrics_j.init_lpips_params(jax.random.PRNGKey(3))
    pt = metrics_t.lpips_params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj))
    shape = (2, 64, 64, 3) if batched else (64, 64, 3)
    a, b = _images(2, shape)
    want = np.asarray(metrics_j.lpips(jnp.asarray(a), jnp.asarray(b), pj))
    got = _np(metrics_t.lpips(torch.from_numpy(a), torch.from_numpy(b), pt))
    assert got.shape == want.shape == ((2,) if batched else ())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(want > 0)


def _write_lpips_files(folder, seed=0):
    """A torchvision-AlexNet-shaped state dict and an lpips ``alex.pth``
    of random weights."""
    g = torch.Generator().manual_seed(seed)
    alex, lin, in_ch = {}, {}, 3
    for i, (fidx, (out_ch, k, _, _, _)) in enumerate(
            zip(metrics_t._ALEX_FEATURES, metrics_t._ALEX)):
        alex[f"features.{fidx}.weight"] = torch.randn(
            out_ch, in_ch, k, k, generator=g) * 0.05
        alex[f"features.{fidx}.bias"] = torch.randn(out_ch, generator=g) * 0.1
        lin[f"lin{i}.model.1.weight"] = torch.rand(1, out_ch, 1, 1,
                                                   generator=g) * 0.1
        in_ch = out_ch
    alex["classifier.1.weight"] = torch.zeros(4, 4)   # ignored
    paths = folder / "alexnet.pth", folder / "alex.pth"
    torch.save(alex, paths[0])
    torch.save(lin, paths[1])
    return [str(p) for p in paths]


def test_load_lpips_params_and_metrics_match_jax(tmp_path):
    paths = _write_lpips_files(tmp_path)
    pj = metrics_j.load_lpips_params(*paths)
    pt = metrics_t.load_lpips_params(*paths)
    for cj, ct in zip(pj["conv"], pt["conv"]):
        np.testing.assert_array_equal(
            np.transpose(np.asarray(cj["w"]), (3, 2, 0, 1)), _np(ct["w"]))
        np.testing.assert_array_equal(np.asarray(cj["b"]), _np(ct["b"]))
    for lj, lt in zip(pj["lin"], pt["lin"]):
        np.testing.assert_array_equal(np.asarray(lj), _np(lt))
    a, b = _images(4, (48, 48, 3))
    mj = metrics_j.Metrics(lpips_weights_path=":".join(paths))(
        jnp.asarray(a), jnp.asarray(b))
    mt = metrics_t.Metrics(lpips_weights_path=":".join(paths))(
        torch.from_numpy(a), torch.from_numpy(b))
    assert set(mt) == set(mj) == {"psnr", "ssim", "lpips"}
    np.testing.assert_allclose(float(mt["psnr"]), float(mj["psnr"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(mt["ssim"]), float(mj["ssim"]),
                               atol=1e-6)
    np.testing.assert_allclose(float(mt["lpips"]), float(mj["lpips"]),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(metrics_t.lpips(torch.from_numpy(a), torch.from_numpy(b),
                              weights_path=":".join(paths))),
        float(mj["lpips"]), rtol=1e-5)
    with pytest.raises(FileNotFoundError):
        metrics_t.load_lpips_params(str(tmp_path / "none.pth"), paths[1])
    with pytest.raises(FileNotFoundError):
        metrics_t.lpips(torch.from_numpy(a), torch.from_numpy(b))


# ---- lens (un)distortion ----

RT_PARAMS = [np.zeros(0), np.array([0.1]), np.array([0.1, -0.05]),
             np.array([0.1, -0.05, 0.01, -0.02]),
             np.array([0.1, -0.05, 0.01, -0.02, 0.01, 0.02, -0.01, 0.005])]
FISHEYE = np.array([0.05, -0.01, 0.004, -0.001])


def _uv(seed=0, n=256):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (n, 2)).astype(np.float32)


@pytest.mark.parametrize("k", [0, 1, 2, 4, 8])
def test_radial_tangential_matches_jax(k):
    uv, p = _uv(k), RT_PARAMS[[0, 1, 2, 4, 8].index(k)].astype(np.float32)
    d_j = np.array(und_j.opencv_lens_distortion(jnp.asarray(uv), p))
    d_t = _np(und_t.opencv_lens_distortion(torch.from_numpy(uv),
                                           torch.from_numpy(p)))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=1e-6)
    u_j = np.asarray(und_j.opencv_lens_undistortion(jnp.asarray(d_j), p))
    u_t = _np(und_t.opencv_lens_undistortion(torch.from_numpy(d_j),
                                             torch.from_numpy(p)))
    np.testing.assert_allclose(u_t, u_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u_t, uv, atol=1e-4)     # the round trip


def test_fisheye_matches_jax():
    uv, p = _uv(9), FISHEYE.astype(np.float32)
    d_j = np.array(und_j.opencv_lens_distortion_fisheye(jnp.asarray(uv), p))
    d_t = _np(und_t.opencv_lens_distortion_fisheye(torch.from_numpy(uv),
                                                   torch.from_numpy(p)))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=1e-6)
    u_j = np.asarray(und_j.opencv_lens_undistortion_fisheye(
        jnp.asarray(d_j), p))
    u_t = _np(und_t.opencv_lens_undistortion_fisheye(torch.from_numpy(d_j),
                                                     torch.from_numpy(p)))
    np.testing.assert_allclose(u_t, u_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u_t, uv, atol=1e-4)


@pytest.mark.parametrize("name,params", [
    ("opencv_lens_distortion", RT_PARAMS[4]),
    ("opencv_lens_undistortion", RT_PARAMS[4]),
    ("opencv_lens_distortion_fisheye", FISHEYE),
    ("opencv_lens_undistortion_fisheye", FISHEYE)])
def test_undistort_gradients_match_jax(name, params):
    uv = _uv(5, 64)
    p = params.astype(np.float32)
    w = np.random.default_rng(6).standard_normal((64, 2)).astype(np.float32)
    fj = getattr(und_j, name)
    g_uv, g_p = jax.grad(lambda x, q: jnp.sum(fj(x, q) * w), argnums=(0, 1))(
        jnp.asarray(uv), jnp.asarray(p))
    x = torch.from_numpy(uv).requires_grad_(True)
    q = torch.from_numpy(p).requires_grad_(True)
    torch.sum(getattr(und_t, name)(x, q) * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(_np(x.grad), np.asarray(g_uv), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(q.grad), np.asarray(g_p), rtol=1e-4,
                               atol=1e-5)
    assert np.abs(np.asarray(g_p)).max() > 1e-3


def test_undistort_rejects_bad_parameter_counts():
    uv = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="parameter count 3"):
        und_t.opencv_lens_distortion(uv, torch.zeros(3))
    with pytest.raises(ValueError, match="fisheye expects 4"):
        und_t.opencv_lens_undistortion_fisheye(uv, torch.zeros(8))


# ---- COLMAP ----

IMAGES = [("b.png", (0.9238795, 0.0, 0.3826834, 0.0), (1.0, 0.0, 3.0)),
          ("a.png", (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 2.0)),
          ("c.png", (0.8, 0.2, -0.3, 0.4), (-0.5, 0.2, 2.5))]
POINTS = [((0.5, 0.5, 0.5), (255, 0, 0)), ((-0.5, 0.1, 0.2), (0, 255, 0)),
          ((0.1, -0.3, 0.7), (12, 34, 56))]


def _write_text_model(d, model="PINHOLE", params=(500.0, 510.0, 320.0,
                                                  240.0)):
    (d / "cameras.txt").write_text(
        f"# cameras\n1 {model} 640 480 {' '.join(map(str, params))}\n")
    lines = ["# images"]
    for i, (name, q, t) in enumerate(IMAGES, 1):
        lines.append(f"{i} {' '.join(map(str, q))} {' '.join(map(str, t))} "
                     f"1 {name}")
        lines.append("1.0 2.0 -1")
    (d / "images.txt").write_text("\n".join(lines) + "\n")
    (d / "points3D.txt").write_text("# points\n" + "".join(
        f"{i} {' '.join(map(str, p))} {' '.join(map(str, c))} 0.1 1 0\n"
        for i, (p, c) in enumerate(POINTS, 1)))


def _write_binary_model(d):
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 0, 800, 600))      # SIMPLE_PINHOLE
        f.write(struct.pack("<3d", 700.0, 400.0, 300.0))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(IMAGES)))
        for i, (name, q, t) in enumerate(IMAGES, 1):
            f.write(struct.pack("<i", i))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *t))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.0, 2.0, 5) * 2)
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(POINTS)))
        for i, (p, c) in enumerate(POINTS, 1):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *p))
            f.write(struct.pack("<3B", *c))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ii", 1, 0) * 2)


def _same_scene(st, sj):
    np.testing.assert_allclose(st.c2ws, sj.c2ws, rtol=1e-6, atol=1e-6)
    assert st.c2ws.dtype == np.float32
    for f in ("fx", "fy", "cx", "cy", "w", "h", "near", "far"):
        assert getattr(st.intr, f) == getattr(sj.intr, f), f
    assert st.image_names == sj.image_names == ["a.png", "b.png", "c.png"]
    np.testing.assert_array_equal(st.points, sj.points)
    np.testing.assert_array_equal(st.colors, sj.colors)
    R = st.c2ws[:, :, :3]
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


@pytest.mark.parametrize("kind", ["text", "binary"])
@pytest.mark.parametrize("downsample", [1, 2])
def test_load_colmap_matches_jax(tmp_path, kind, downsample):
    (_write_text_model if kind == "text" else _write_binary_model)(tmp_path)
    st = colmap_t.load_colmap(tmp_path, downsample=downsample)
    sj = colmap_j.load_colmap(tmp_path, downsample=downsample)
    _same_scene(st, sj)
    assert st.intr.w == (640 if kind == "text" else 800) // downsample


def test_load_colmap_simple_radial_and_unknown_model(tmp_path):
    _write_text_model(tmp_path, "SIMPLE_RADIAL", (600.0, 320.0, 240.0, 0.01))
    _same_scene(colmap_t.load_colmap(tmp_path), colmap_j.load_colmap(tmp_path))
    _write_text_model(tmp_path, "FOV", (600.0, 320.0, 240.0, 0.01))
    with pytest.raises(NotImplementedError, match="FOV"):
        colmap_t.load_colmap(tmp_path)
