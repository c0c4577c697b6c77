"""The port's tools around a trained scene against the JAX package.

Debug scenes, sweeps, relighting, snapshots, the reconstruction demo,
the rehearsal, the viewer, ``make_init_asset`` and ``gsgen_torch.vis``;
CPU, RES 32, TILE 8, CHUNK 128, at most 256 Gaussians.  The JAX side
renders with its Pallas kernels in interpret mode and exact scans.
Tolerances (fp32 summation order):

* renders (debug scenes, orbit strips, relit frames, stills and spiral
  frames, alpha = 1 - T) within the render gates of test_torch_raster.py:
  rtol 1e-4 / atol 1e-5; relit frames atol 2e-5 (the estimated normals'
  3x3 eigh adds rounding); depth colormaps within one step of their
  lookup table (a rounding-level depth may cross a bin);
* ``relight_colors``, ``build_target``'s raw params and
  ``CameraIntrinsics.from_fov``: within 1e-6;
* the sweep's YAML files, the rehearsal config, the demo's trainer
  config, the asset file names: equal;
* the viewer's image: its pixels within 1 of 255 of the JAX viewer's
  (the two renders round to uint8 apart).
"""

import concurrent.futures as cf
import dataclasses
import io
import json
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gsgen_tpu import priors as priors_j
from gsgen_tpu.io import viewer as viewer_j
from gsgen_tpu.models.scene import GaussianParams, SceneState
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.models.scene import render_view as render_view_j
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_tpu.tools import demo_recon as demo_j
from gsgen_tpu.tools import rehearsal as rehearsal_j
from gsgen_tpu.tools import relight as relight_j
from gsgen_tpu.tools import snapshot as snapshot_j
from gsgen_tpu.utils import debug_scenes as debug_j
from gsgen_tpu.utils import sweep as sweep_j
from gsgen_torch import vis
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.io import viewer as viewer_t
from gsgen_torch.io.checkpoint import save_checkpoint
from gsgen_torch.io.logging import encode_png, read_png
from gsgen_torch.models.scene import (FIELDS, RenderConfig, render_view,
                                      scene_from_numpy)
from gsgen_torch.ops.camera import CameraIntrinsics
from gsgen_torch.tools import demo_recon as demo_t
from gsgen_torch.tools import make_init_asset
from gsgen_torch.tools import rehearsal as rehearsal_t
from gsgen_torch.tools import relight as relight_t
from gsgen_torch.tools import snapshot as snapshot_t
from gsgen_torch.utils import colormaps as cmap_t
from gsgen_torch.utils import debug_scenes as debug_t
from gsgen_torch.utils import sweep as sweep_t
from torch_fixtures import CHUNK, RES, TILE, scene3d

RKW = dict(tile_size=TILE, chunk=CHUNK, dup_cap=8192)
RENDER_J = RenderJ(backend="pallas", pallas_interpret=True, mxu_scans=False,
                   fast_fwd_cumprod=False, **RKW)
RENDER_T = RenderConfig(**RKW)
C2W = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.0]], np.float32)
GATE = dict(rtol=1e-4, atol=1e-5)


def _lut_step(name):
    return float(np.abs(np.diff(cmap_t._lut(name), axis=0)).max())


def _jax_state(arrays):
    m = arrays["mean"].shape[0]
    return SceneState(
        params=GaussianParams(**{f: jnp.asarray(arrays[f]) for f in FIELDS}),
        active=jnp.asarray(arrays["active"]), max_radii2d=jnp.zeros(m),
        grad_accum=jnp.zeros(m), grad_cnt=jnp.zeros(m))


def _np_state(state):
    out = {f: state.params[f].numpy() for f in FIELDS}
    out["active"] = state.active.numpy()
    return out


def _sphere_scene(n=200, capacity=256, seed=0):
    """Raw fields of ``n`` Gaussians on a sphere of radius 0.5 (no
    coplanar neighbourhoods: the estimated normals have no ties)."""
    s = scene3d(n, seed=seed, capacity=capacity, svec=0.04)
    d = np.random.default_rng(seed + 1).standard_normal((n, 3))
    s["mean"][:n] = (0.5 * d / np.linalg.norm(d, axis=-1, keepdims=True)
                     ).astype(np.float32)
    return s


def test_from_fov_matches_jax():
    for fov, aspect, reso in ((0.9273, 1.0, 256), (1.2, 4 / 3, 100)):
        a = CameraIntrinsics.from_fov(fov, aspect, reso, near=0.1, far=50.0)
        b = IntrJ.from_fov(fov, aspect, reso, near=0.1, far=50.0)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("channels", [3, 4])
def test_encode_png_roundtrip(tmp_path, channels):
    import imageio.v2 as imageio
    img = np.random.default_rng(channels).integers(
        0, 256, (9, 13, channels), dtype=np.uint8)
    blob = encode_png(img)
    assert blob[:8] == b"\x89PNG\r\n\x1a\n" and blob[25] == (
        2 if channels == 3 else 6)
    (tmp_path / "a.png").write_bytes(blob)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), img)
    with pytest.raises(ValueError, match=r"\[H, W, 3\|4\]"):
        encode_png(np.zeros((4, 4, 2), np.uint8))


# ---- debug scenes ----

@pytest.mark.parametrize("flag", ["one", "two", "paper", "grid", "pressure"])
def test_debug_scene_renders_match_jax(flag):
    kw = dict(n_points=27) if flag == "grid" else {}
    st = debug_t.debug_scene(flag, RENDER_T, device="cpu", **kw)
    if flag == "pressure":
        sj = _jax_state(_np_state(st))          # the port's draws in both
    else:
        sj = debug_j.debug_scene(flag, RENDER_J, **kw)
        for f in FIELDS:
            np.testing.assert_allclose(st.params[f].numpy(),
                                       np.asarray(getattr(sj.params, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
    intr_t, intr_j = CameraIntrinsics.from_reso(RES), IntrJ.from_reso(RES)
    out_t = render_view(st.params, st.active, torch.from_numpy(C2W), intr_t,
                        RENDER_T, torch.zeros(3))
    out_j = jax.jit(lambda p, a: render_view_j(
        p, a, jnp.asarray(C2W), intr_j, RENDER_J, jnp.zeros((3,))))(
            sj.params, sj.active)
    for k in ("rgb", "T", "depth"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   err_msg=k, **GATE)
    assert float(out_t["opacity"].max()) > 0.5


# ---- sweeps ----

SWEEP = {"joint_fields": ["trainer.max_steps", "trainer.batch_size"],
         "trainer.max_steps": [100, 200], "trainer.batch_size": [2, 4],
         "init.num_points": [256, 1024]}


def test_sweep_configs_match_jax(tmp_path):
    pt = sweep_t.generate_sweep_configs("configs/smoke.yaml", SWEEP,
                                        out_dir=str(tmp_path / "t"), base=3)
    pj = sweep_j.generate_sweep_configs("configs/smoke.yaml", SWEEP,
                                        out_dir=str(tmp_path / "j"), base=3)
    assert [p.split("/")[-1] for p in pt] == [p.split("/")[-1] for p in pj] \
        == ["3.yaml", "4.yaml", "5.yaml", "6.yaml"]
    for a, b in zip(pt, pj):
        assert open(a).read() == open(b).read()
    seen = {(c["trainer"]["max_steps"], c["trainer"]["batch_size"],
             c["init"]["num_points"]) for c in map(
                 lambda p: yaml.safe_load(open(p)), pt)}
    assert seen == {(100, 2, 256), (200, 4, 256), (100, 2, 1024),
                    (200, 4, 1024)}


def test_sweep_scheduler_runs_the_port(tmp_path, monkeypatch):
    """Each config launches once on a free slot, as a subprocess that runs
    the port's run_sweep on the given device."""
    import subprocess
    real_popen = subprocess.Popen
    launched = []

    def fake_popen(args, env=None):
        launched.append((env.get("CUDA_VISIBLE_DEVICES"), args[-1]))
        return real_popen([sys.executable, "-c", "pass"])

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    paths = [str(tmp_path / f"{i}.yaml") for i in range(3)]
    res = sweep_t.run_sweep_scheduled(
        paths, slots=[{"CUDA_VISIBLE_DEVICES": "0"},
                      {"CUDA_VISIBLE_DEVICES": "1"}], steps=2,
        log_root=str(tmp_path), poll_s=0.05, device="cpu")
    assert sorted(r["config"] for r in res) == paths
    assert all(r["returncode"] == 0 for r in res)
    assert len(launched) == 3 and {s for s, _ in launched} <= {"0", "1"}
    for _, code in launched:
        assert "from gsgen_torch.utils.sweep import run_sweep" in code
        assert "device='cpu'" in code and "steps=2" in code


def test_run_sweep_trains_each_config(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    spec = {"init.num_points": [64, 96]}
    paths = sweep_t.generate_sweep_configs("configs/smoke.yaml", spec,
                                           out_dir=str(tmp_path / "cfg"))
    res = sweep_t.run_sweep(paths, steps=1, log_root=str(tmp_path / "runs"),
                            device="cpu")
    assert [r["config"] for r in res] == paths
    for r in res:
        lines = (Path(r["run_dir"]) / "scalars.jsonl").read_text(
            ).splitlines()
        assert lines and np.isfinite(json.loads(lines[0])["loss_total"])


# ---- relight ----

def test_relight_colors_matches_jax():
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal((50, 3)).astype(np.float32) for _ in range(3)]
    arrs[2] = np.abs(arrs[2]) * 0.5
    lp, lc, cp = (rng.standard_normal(3).astype(np.float32) * 3,
                  np.float32([1.0, 0.9, 0.8]),
                  rng.standard_normal(3).astype(np.float32) * 3)
    got = relight_t.relight_colors(*map(torch.from_numpy, arrs + [lp, lc, cp]))
    want = relight_j.relight_colors(*map(jnp.asarray, arrs + [lp, lc, cp]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_relight_frames_on_a_sphere_match_jax():
    s = _sphere_scene()
    kw = dict(n_frames=3, reso=RES)
    got = relight_t.relight_frames(scene_from_numpy(s, "cpu"), RENDER_T, **kw)
    want = relight_j.relight_frames(_jax_state(s), RENDER_J, **kw)
    assert got.shape == want.shape == (3, RES, RES, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    assert np.abs(got[0] - got[1]).max() > 1e-2       # the light moved
    with pytest.raises(ValueError, match="sh_degree"):
        relight_t.relight_frames(scene_from_numpy(s, "cpu"),
                                 dataclasses.replace(RENDER_T, sh_degree=1))


# ---- snapshots ----

def test_photos_and_spiral_match_jax():
    s = scene3d(150, seed=5, capacity=200, mean_std=0.4, svec=0.06)
    st, sj = scene_from_numpy(s, "cpu"), _jax_state(s)
    shots_t = snapshot_t.take_photos(st, RENDER_T, reso=RES)
    shots_j = snapshot_j.take_photos(sj, RENDER_J, reso=RES)
    assert list(shots_t) == list(shots_j) == ["front", "left", "right"]
    for name in shots_t:
        rt, rj = shots_t[name]["rgb"], shots_j[name]["rgb"]
        assert rt.shape == rj.shape == (RES, RES, 4)
        np.testing.assert_allclose(rt, rj, err_msg=name, **GATE)
        dt, dj = shots_t[name]["depth"], shots_j[name]["depth"]
        np.testing.assert_allclose(dt[..., 3], dj[..., 3], **GATE)
        np.testing.assert_allclose(dt[..., :3], dj[..., :3], rtol=0,
                                   atol=_lut_step("turbo") + 1e-5)
        assert rt[..., 3].max() > 0.3
    bg = dict(use_bg=True)
    assert snapshot_t.take_photos(st, RENDER_T, reso=RES, **bg)[
        "left"]["rgb"].shape == (RES, RES, 3)
    v_t = snapshot_t.take_spiral(st, RENDER_T, n_frames=3, reso=RES,
                                 rng=np.random.default_rng(1))
    v_j = snapshot_j.take_spiral(sj, RENDER_J, n_frames=3, reso=RES,
                                 rng=np.random.default_rng(1))
    assert v_t.shape == v_j.shape == (3, RES, 2 * RES, 3)
    np.testing.assert_allclose(v_t[:, :, :RES], v_j[:, :, :RES], **GATE)
    np.testing.assert_allclose(v_t[:, :, RES:], v_j[:, :, RES:], rtol=0,
                               atol=_lut_step("turbo") + 1e-5)


def test_still_over_dup_cap_raises():
    st = scene_from_numpy(scene3d(150, seed=5, capacity=200), "cpu")
    with pytest.raises(RuntimeError, match="renderer.dup_cap"):
        snapshot_t.take_photos(
            st, dataclasses.replace(RENDER_T, dup_cap=CHUNK), reso=RES)


# ---- the reconstruction demo ----

def test_demo_target_and_orbit_strip_match_jax():
    key = jax.random.PRNGKey(0)
    dirs = [np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                         (60, 3))) for i in range(3)]
    tj = demo_j.build_target(key, n_per=60)
    tt = demo_t.build_target(n_per=60, directions=dirs, device="cpu")
    for f in FIELDS:
        np.testing.assert_allclose(tt[f].numpy(), np.asarray(getattr(tj, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    kw = dict(reso=RES, n=1)
    strip_t = demo_t.orbit_strip(tt, torch.ones(180, dtype=torch.bool),
                                 RENDER_T, **kw)
    strip_j = demo_j.orbit_strip(tj, jnp.ones(180, bool), RENDER_J, **kw)
    assert strip_t.shape == strip_j.shape == (RES, RES, 3)
    np.testing.assert_allclose(strip_t, strip_j, **GATE)
    assert strip_t.min() < 0.5
    drawn = demo_t.build_target(torch.Generator().manual_seed(3), n_per=60,
                                device="cpu")
    np.testing.assert_allclose(torch.linalg.norm(
        drawn["mean"][:60] - torch.tensor([0.0, 0.0, -0.45]), dim=-1),
        0.42, rtol=1e-5)


class _Built(Exception):
    pass


def jax_demo_init():
    """What ``gsgen_torch/tools/demo_recon_init.npz`` stores: the JAX
    demo's initial scene (the raw fields of its live rows, from its
    Trainer at seed 0) and its target's draws (``normal(fold_in(
    PRNGKey(0), i), (1500, 3))``, unnormalized)."""
    seen = {}

    def build(**kw):
        seen["trainer"] = real(**kw)
        raise _Built

    real = demo_j.Trainer
    demo_j.Trainer = build
    try:
        demo_j.main(steps=400)
    except _Built:
        pass
    finally:
        demo_j.Trainer = real
    scene = seen["trainer"].state.scene
    n = int(np.asarray(scene.active).sum())
    out = {f: np.asarray(getattr(scene.params, f))[:n] for f in FIELDS}
    key = jax.random.PRNGKey(0)
    out["directions"] = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (1500, 3))) for i in range(3)])
    return out


def test_demo_init_file_is_the_jax_demos():
    """The port's demo starts from the JAX demo's initial scene and target
    (the file is written by running this module as a script)."""
    with np.load(demo_t.INIT_FILE) as z:
        stored = dict(z)
    want = jax_demo_init()
    assert sorted(stored) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(stored[k], v, err_msg=k)
    assert stored["mean"].shape == (1024, 3)


def test_demo_trainer_config_matches_jax(monkeypatch):
    """main's Trainer arguments: the same configs in both packages (the
    Trainer is replaced by a recorder that stops main there)."""
    seen = {}

    def recorder(name):
        def build(**kw):
            seen[name] = kw
            raise _Built
        return build

    monkeypatch.setattr(demo_j, "Trainer", recorder("jax"))
    monkeypatch.setattr(demo_t, "Trainer", recorder("torch"))
    for mod in (demo_j, demo_t):
        with pytest.raises(_Built):
            mod.main(steps=400, **({"device": "cpu"} if mod is demo_t
                                   else {}))
    kj, kt = seen["jax"], seen["torch"]
    assert kt.pop("device") == "cpu"
    # the port starts from the JAX demo's initial scene: every raw field
    # of every slot equal to the JAX Trainer's
    monkeypatch.undo()
    scene_j = demo_j.Trainer(**kj).state.scene
    scene_t = demo_t.Trainer(**kt, device="cpu").state.scene
    for f in FIELDS:
        np.testing.assert_array_equal(scene_t.params[f].numpy(),
                                      np.asarray(getattr(scene_j.params, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(scene_t.active.numpy(),
                                  np.asarray(scene_j.active))
    assert sorted(kt.pop("init_raw")) == sorted(FIELDS)
    assert set(kj) == set(kt)
    for k in ("cfg", "init_cfg", "bg_cfg", "data_cfg", "dcfg", "pcfg",
              "rcfg"):
        a, b = dataclasses.asdict(kt[k]), dataclasses.asdict(kj[k])
        common = set(a) & set(b)
        assert {f: a[f] for f in common} == {f: b[f] for f in common}, k
    g = kt["guidance"]
    assert g.mode == "scene" and g.intr == CameraIntrinsics.from_reso(64)
    assert g.target_scene["mean"].shape == (4500, 3)
    assert kt["dcfg"].warm_up == 100 and kt["dcfg"].end == 300


@pytest.mark.parametrize("before", [False, True])
def test_demo_main_runs_deterministic_and_restores(monkeypatch, before):
    """main runs the recipe under PyTorch's deterministic algorithms (one
    PSNR a card) and gives the caller's setting back, also on a raise."""
    seen = []

    def run(out_path, steps, device):
        seen.append(torch.are_deterministic_algorithms_enabled())
        raise _Built

    monkeypatch.setattr(demo_t, "_run", run)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(before)
    try:
        with pytest.raises(_Built):
            demo_t.main(steps=1, device="cpu")
        assert seen == [True]
        assert torch.are_deterministic_algorithms_enabled() is before
    finally:
        torch.use_deterministic_algorithms(was)


# ---- the rehearsal ----

@pytest.mark.parametrize("mock", [True, False])
def test_rehearsal_config_matches_jax(mock):
    kw = dict(mock=mock) if mock else dict(sd_path="/sd", clip_path="/clip")
    assert rehearsal_t.build_rehearsal_config("a corgi", 7, **kw) == \
        rehearsal_j.build_rehearsal_config("a corgi", 7, **kw)


def test_rehearsal_runs_the_mock_config(tmp_path):
    cfg = rehearsal_t.build_rehearsal_config(
        "a corgi", 2, mock=True, reso=32, num_points=256, capacity=1024)
    cfg["renderer"]["dup_cap"] = 16384
    cfg["prompt"]["use_cache"] = False
    losses = rehearsal_t.run(cfg, tmp_path, eval_every=2, eval_reso=32,
                             log=lambda *a: None, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    lines = [json.loads(x) for x in
             (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    assert all(x["grad_norm"] > 0 and np.isfinite(x["grad_norm"])
               for x in lines)
    assert all(x["n_gauss"] == 256 for x in lines)
    img = read_png(tmp_path / "eval_00002.png")
    assert img.shape == (32, 4 * 32, 3)


# ---- viewer, vis and the CLIs on a checkpoint ----

@pytest.fixture(scope="module")
def smoke_ckpt(tmp_path_factory):
    """configs/smoke.yaml trained one step on the CPU, saved at step 1."""
    d = tmp_path_factory.mktemp("ckpt")
    trainer = build_trainer(load_config("configs/smoke.yaml"), device="cpu")
    trainer.fit(1)
    return save_checkpoint(d / "ckpts", 1, trainer.state), trainer


def _captured_jax_image(monkeypatch, state_j, **pose):
    """The uint8 image the JAX viewer hands to PIL's JPEG encoder."""
    import PIL.Image
    got = {}
    real = PIL.Image.fromarray

    def keep(a, *args, **kw):
        got["img"] = np.array(a)
        return real(a, *args, **kw)

    monkeypatch.setattr(PIL.Image, "fromarray", keep)
    viewer_j.SceneViewer(state_j, RENDER_J).render(**pose)
    monkeypatch.setattr(PIL.Image, "fromarray", real)
    return got["img"]


def test_viewer_render_matches_jax(monkeypatch, tmp_path):
    s = scene3d(150, seed=8, capacity=200, mean_std=0.4, svec=0.06)
    pose = dict(azimuth=30, elevation=20, distance=2.5, reso=RES, fov=60.0,
                center=(0.05, 0.0, 0.0))
    jpeg = viewer_t.SceneViewer(scene_from_numpy(s, "cpu"), RENDER_T).render(
        **pose)
    assert jpeg[:2] == b"\xff\xd8"
    import PIL.Image
    assert np.array(PIL.Image.open(io.BytesIO(jpeg))).shape == (RES, RES, 3)
    pil = sys.modules["PIL"]
    monkeypatch.setitem(sys.modules, "PIL", None)
    v = viewer_t.SceneViewer(scene_from_numpy(s, "cpu"), RENDER_T)
    assert v.content_type == "image/png"
    (tmp_path / "v.png").write_bytes(v.render(**pose))
    got = read_png(tmp_path / "v.png")
    monkeypatch.setitem(sys.modules, "PIL", pil)
    want = _captured_jax_image(monkeypatch, _jax_state(s), **pose)
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert got.max() > 60


def _get(port, path):
    return urllib.request.urlopen(f"http://localhost:{port}{path}",
                                  timeout=60).read()


def test_viewer_http_roundtrip_on_a_free_port(smoke_ckpt):
    _, trainer = smoke_ckpt
    v = viewer_t.SceneViewer(trainer.state.scene, trainer.rcfg, port=0)
    v.serve(blocking=False)
    try:
        assert v.port > 0
        assert b"gsgen-torch viewer" in _get(v.port, "/")
        img = _get(v.port, "/render?azimuth=0&elevation=20&distance=2.5"
                           "&reso=32")
        assert img[:2] == b"\xff\xd8"
        with cf.ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda az: _get(
                v.port, f"/render?azimuth={az}&elevation=10&distance=2.5"
                        "&reso=32"), [0, 45, 90, 135]))
        assert all(o[:2] == b"\xff\xd8" for o in outs)
        v.update_state(trainer.state.scene, step=123)
        stats = json.loads(_get(v.port, "/stats"))
        assert stats == {"step": 123, "num_gaussians": 256}
    finally:
        v.httpd.shutdown()
        v.httpd.server_close()


def test_vis_serves_a_checkpoint_on_the_cpu(smoke_ckpt):
    ckpt, trainer = smoke_ckpt
    v = vis.main([ckpt, "--config", "configs/smoke.yaml", "--device", "cpu",
                  "--port", "0"], blocking=False)
    try:
        assert json.loads(_get(v.port, "/stats")) == {
            "step": 1, "num_gaussians": 256}
        for f in FIELDS:
            assert torch.equal(v.state.params[f],
                               trainer.state.scene.params[f]), f
    finally:
        v.httpd.shutdown()
        v.httpd.server_close()


def test_snapshot_and_relight_clis_write_pngs(smoke_ckpt, tmp_path,
                                             monkeypatch, capsys):
    """Without imageio (as on the card's machine) the videos become PNG
    frames; the stills are RGBA PNGs."""
    ckpt, _ = smoke_ckpt
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    common = [ckpt, "--config", "configs/smoke.yaml", "--device", "cpu"]
    assert snapshot_t.main(["photos", *common, "--reso", "32", "--out",
                            str(tmp_path / "stills")]) == 0
    names = sorted(p.name for p in (tmp_path / "stills").iterdir())
    assert names == sorted(f"{n}_{k}.png" for n in ("front", "left", "right")
                           for k in ("rgb", "depth"))
    assert read_png(tmp_path / "stills" / "front_rgb.png").shape == (32, 32, 4)
    assert snapshot_t.main(["spiral", *common, "--reso", "32", "--frames",
                            "3", "--out", str(tmp_path / "spiral.mp4")]) == 0
    frames = sorted((tmp_path / "spiral").iterdir())
    assert len(frames) == 3 and read_png(frames[0]).shape == (32, 64, 3)
    assert relight_t.main([*common, "--reso", "32", "--frames", "2",
                           "--out", str(tmp_path / "relight.mp4")]) == 0
    assert len(list((tmp_path / "relight").iterdir())) == 2
    assert "loaded step 1" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["point_e", "shap_e"])
def test_make_init_asset_uses_the_jax_file_names(tmp_path, monkeypatch,
                                                 capsys, kind):
    prompt = "a small test corgi"
    monkeypatch.setattr(priors_j, "ASSET_DIR", str(tmp_path))
    monkeypatch.setenv("GSGEN_ASSET_DIR", str(tmp_path))
    want = priors_j._asset_path(kind, prompt)
    np.savez(want, xyz=np.zeros((10, 3), np.float32),
             rgb=np.ones((10, 3), np.float32))
    assert make_init_asset.main([kind, prompt, "--device", "cpu"]) == 0
    assert f"wrote {want}  (10 points)" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    import inspect
    for fn in (demo_t.main, demo_t.build_target, rehearsal_t.run,
               sweep_t.run_sweep, sweep_t.run_sweep_scheduled,
               debug_t.debug_scene):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_tools.py
    np.savez_compressed(demo_t.INIT_FILE, **jax_demo_init())
    print(f"wrote {demo_t.INIT_FILE}")
