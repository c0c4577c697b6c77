"""gsgen_torch density control (``models/density.py``, ``utils/ops.py``) vs
the JAX package's, on the same numpy scene, statistics and Adam moments.

Split offsets are random: the test replays the JAX event's draws from its
key (one ``jax.random.split`` per split copy, then ``normal(k, [M, 3])``)
and hands them to the port as ``noise``.  Compared: ``active``, the Adam
moments and the info counts exactly (they are masks and copies of the
same numbers); raw params rtol 1e-5 / atol 1e-6 (the port's exp, log and
rotation matrix round apart from XLA's by an ulp or so); KNN indices
exactly, distances rtol 1e-5 / atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.io.checkpoint import _flatten_with_paths
from gsgen_tpu.models import density as dens_j
from gsgen_tpu.models.background import BackgroundConfig as BgJ
from gsgen_tpu.models.init import InitConfig as InitJ
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.models.scene import SceneState as SceneJ
from gsgen_tpu.data.cameras import CameraSamplerConfig as CamJ
from gsgen_tpu.training.optimizer import AdamState as AdamJ
from gsgen_tpu.training.trainer import Trainer as TrainerJ
from gsgen_tpu.training.trainer import TrainerConfig as TcfgJ
from gsgen_tpu.utils import ops as ops_j
from gsgen_torch.data.cameras import CameraSamplerConfig
from gsgen_torch.models import density
from gsgen_torch.models.background import BackgroundConfig
from gsgen_torch.models.init import InitConfig
from gsgen_torch.models.scene import FIELDS, RenderConfig, scene_from_numpy
from gsgen_torch.training.optimizer import AdamState
from gsgen_torch.training.trainer import Trainer, TrainerConfig, \
    train_state_from_jax_arrays
from gsgen_torch.utils import ops
from torch_fixtures import scene3d, t

RCFG_J, RCFG_T = RenderJ(), RenderConfig()


def _world(n, capacity, seed, svec=0.03, clone_of=None):
    """Raw scene + densify statistics + Adam moments, as numpy.
    ``clone_of=(src, dst)`` copies row src into free slot dst (active)."""
    raw = scene3d(n, seed=seed, capacity=capacity, mean_std=0.5, svec=svec)
    rng = np.random.default_rng(seed + 1)
    if clone_of is not None:
        src, dst = clone_of
        for f in FIELDS:
            raw[f][dst] = raw[f][src]
        raw["active"][dst] = True
    m = capacity
    raw["grad_accum"] = rng.uniform(0.0, 0.1, m).astype(np.float32)
    raw["grad_cnt"] = rng.integers(0, 4, m).astype(np.float32)
    raw["max_radii2d"] = rng.uniform(0.0, 2.0, m).astype(np.float32)
    mom = {k: {f: rng.standard_normal(raw[f].shape).astype(np.float32)
               for f in FIELDS} for k in ("mu", "nu")}
    return raw, mom


def _jax_side(raw, mom):
    p = GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS})
    st = SceneJ(params=p, active=jnp.asarray(raw["active"]),
                **{s: jnp.asarray(raw[s]) for s in
                   ("max_radii2d", "grad_accum", "grad_cnt")})
    opt = AdamJ(*(GaussianParams(**{f: jnp.asarray(mom[k][f])
                                    for f in FIELDS}) for k in ("mu", "nu")),
                count=jnp.int32(3))
    return st, opt


def _torch_side(raw, mom):
    opt = AdamState(mu={f: t(mom["mu"][f]) for f in FIELDS},
                    nu={f: t(mom["nu"][f]) for f in FIELDS}, count=3)
    return scene_from_numpy(raw, "cpu"), opt


def _check(st_t, opt_t, info_t, st_j, opt_j, info_j):
    assert {k: int(v) for k, v in info_j.items()} == info_t
    np.testing.assert_array_equal(st_t.active.numpy(),
                                  np.asarray(st_j.active))
    for f in FIELDS:
        np.testing.assert_allclose(st_t.params[f].numpy(),
                                   np.asarray(getattr(st_j.params, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
        for k in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(opt_t, k)[f].numpy(),
                np.asarray(getattr(getattr(opt_j, k), f)), err_msg=k + f)
    for s in ("grad_accum", "grad_cnt", "max_radii2d"):
        np.testing.assert_array_equal(getattr(st_t, s).numpy(),
                                      np.asarray(getattr(st_j, s)))


def _replay(key, n_copies, m):
    """The normals the JAX event draws for its split copies."""
    out = []
    for _ in range(n_copies):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (m, 3))))
    return out


CASES = {
    # name: (DensifyConfig overrides, n, capacity, split copies drawn)
    "legacy": (dict(use_legacy=True, mean2d_thresh=0.01), 40, 128, 2),
    "official": (dict(use_legacy=False, type="official", n_splits=3,
                      mean2d_thresh=0.01), 40, 192, 3),
    "scale": (dict(use_legacy=False, type="scale", scale_max=0.03), 40, 128,
              2),
    "all": (dict(use_legacy=False, type="all"), 40, 96, 2),
    "compatness": (dict(use_legacy=False, type="compatness"), 40, 192, 0),
    "shrink_then_compatness": (dict(use_legacy=False,
                                    type="shrink_then_compatness"), 40, 192,
                               0),
    "legacy_compatness": (dict(use_legacy=True, type="compatness",
                               mean2d_thresh=0.01), 40, 256, 2),
    # few free slots: some split copies find none, so their sources stay
    "overflow": (dict(use_legacy=False, type="all"), 40, 52, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_matches_jax(case):
    over, n, cap, n_copies = CASES[case]
    cfg_j = dataclasses.replace(dens_j.DensifyConfig(), **over)
    cfg_t = dataclasses.replace(density.DensifyConfig(), **over)
    raw, mom = _world(n, cap, seed=len(case))
    key = jax.random.PRNGKey(7)
    st_j, opt_j, info_j = dens_j.densify(*_jax_side(raw, mom), cfg_j, RCFG_J,
                                         key)
    st_t, opt_t, info_t = density.densify(
        *_torch_side(raw, mom), cfg_t, RCFG_T,
        noise=_replay(key, n_copies, cap) if n_copies else None)
    _check(st_t, opt_t, info_t, st_j, opt_j, info_j)
    grew = int(st_t.active.sum()) - n
    assert grew > 0 and sum(info_t.values()) > 0
    if case == "overflow":
        assert int(st_t.active.sum()) == cap
        assert info_t["num_split"] < 2 * n     # not every copy was placed
        assert bool(st_t.active[:n].any())     # unplaced sources survive


def test_densify_compactness_with_clone_tie():
    """Row 30 cloned exactly into the free slot 5 (lower index): for both
    copies the zero-distance tie puts index 5 first, as jax.lax.top_k
    orders equal values."""
    raw, mom = _world(40, 96, seed=3, clone_of=(30, 5))
    raw["active"][5:8] = [True, False, False]
    active = t(raw["active"])
    d_t, i_t = ops.knn_self(t(raw["mean"]), 3, mask=active)
    d_j, i_j = ops_j.knn_self(jnp.asarray(raw["mean"]), 3,
                              mask=jnp.asarray(raw["active"]))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-6)
    assert int(i_t[5, 0]) == 30 and int(i_t[30, 0]) == 30
    cfg = dict(use_legacy=False, type="compatness", K=3)
    st_j, opt_j, info_j = dens_j.densify(
        *_jax_side(raw, mom), dataclasses.replace(dens_j.DensifyConfig(),
                                                  **cfg), RCFG_J,
        jax.random.PRNGKey(0))
    st_t, opt_t, info_t = density.densify(
        *_torch_side(raw, mom), dataclasses.replace(density.DensifyConfig(),
                                                    **cfg), RCFG_T)
    _check(st_t, opt_t, info_t, st_j, opt_j, info_j)


def test_knn_blocks_and_surface_distance_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((300, 3)).astype(np.float32)
    mask = rng.random(300) > 0.2
    monkeypatch.setattr(ops, "KNN_ROWS", 64)     # several row blocks
    d_t, i_t = ops.knn(t(pts[:100]), t(pts), 5, mask=t(mask))
    d_j, i_j = ops_j.knn(jnp.asarray(pts[:100]), jnp.asarray(pts), 5,
                         mask=jnp.asarray(mask))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-6)
    sv = rng.uniform(0.01, 0.2, (300, 3)).astype(np.float32)
    q = rng.standard_normal((300, 4)).astype(np.float32)
    want = ops_j.distance_to_gaussian_surface(*map(jnp.asarray,
                                                   (pts, sv, q, pts[::-1])))
    got = ops.distance_to_gaussian_surface(*map(t, (pts, sv, q,
                                                    pts[::-1].copy())))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("radii3d", [0.0, 0.04])
def test_prune_matches_jax(radii3d):
    raw, mom = _world(40, 64, seed=9)
    cfg = dict(enabled=True, radii2d_thresh=1.0, alpha_thresh=0.5,
               radii3d_thresh=radii3d)
    st_j, opt_j, info_j = dens_j.prune(
        *_jax_side(raw, mom), dens_j.PruneConfig(**cfg), RCFG_J,
        jnp.float32(1.5), jnp.float32(0.4))
    st_t, opt_t, info_t = density.prune(
        *_torch_side(raw, mom), density.PruneConfig(**cfg), RCFG_T, 1.5, 0.4)
    _check(st_t, opt_t, info_t, st_j, opt_j, info_j)
    assert 0 < int(st_t.active.sum()) < 40
    assert (info_t["num_pruned_svec"] > 0) == (radii3d > 0)


def test_trainer_density_step_matches_jax():
    """A step where a compactness densify (no random draws) and a prune
    (thresholds through C() at the step) both fire, from the same state.
    The port leaves every non-scene moment alone, even one whose leading
    dim is the capacity."""
    kw = dict(max_steps=100, batch_size=1)
    rkw = dict(tile_size=8, chunk=128, dup_cap=4096)
    init = dict(num_points=48, capacity=160, svec_val=0.05, mean_std=0.4)
    data = dict(batch_size=1, max_steps=100, reso=(32,))
    dkw = dict(enabled=True, use_legacy=False, type="compatness",
               warm_up=2, period=2, end=10)
    pkw = dict(enabled=True, warm_up=0, period=1, end=10,
               radii2d_thresh=1.5, alpha_thresh=0.45)
    tj = TrainerJ(cfg=TcfgJ(**kw),
                  rcfg=RenderJ(backend="pallas", pallas_interpret=True,
                               mxu_scans=False, **rkw),
                  init_cfg=InitJ(**init), bg_cfg=BgJ(type="random"),
                  data_cfg=CamJ(**data),
                  dcfg=dens_j.DensifyConfig(**dkw),
                  pcfg=dens_j.PruneConfig(**pkw))
    raw, mom = _world(48, 160, seed=21)
    st_j, opt_j = _jax_side(raw, mom)
    tj.state = tj.state._replace(scene=st_j, opt=tj.state.opt._replace(
        mu=(opt_j.mu,) + tuple(tj.state.opt.mu[1:]),
        nu=(opt_j.nu,) + tuple(tj.state.opt.nu[1:])))
    tt = Trainer(cfg=TrainerConfig(**kw), rcfg=RenderConfig(**rkw),
                 init_cfg=InitConfig(**init),
                 bg_cfg=BackgroundConfig(type="random"),
                 data_cfg=CameraSamplerConfig(**data),
                 dcfg=density.DensifyConfig(**dkw),
                 pcfg=density.PruneConfig(**pkw), device="cpu")
    tt.state = train_state_from_jax_arrays(_flatten_with_paths(tj.state),
                                           "cpu")
    other = torch.ones(160)
    tt.state.opt.mu["gp/other"] = other
    info_j = tj.density_step(4)
    info_t = tt.density_step(4)
    assert info_t == info_j and info_t["num_compact"] > 0
    assert info_t["num_pruned_radii2d"] > 0
    assert all(type(v) is int for v in info_t.values())
    arrays = _flatten_with_paths(tj.state)
    st = tt.state
    np.testing.assert_array_equal(st.scene.active.numpy(),
                                  arrays[".scene/.active"])
    for f in FIELDS:
        np.testing.assert_allclose(st.scene.params[f].numpy(),
                                   arrays[f".scene/.params/.{f}"],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(st.opt.mu[f].numpy(),
                                      arrays[f".opt/.mu/[0]/.{f}"])
    assert st.opt.mu["gp/other"] is other
    assert tt.density_step(5).keys() == {"num_pruned_radii2d",
                                         "num_pruned_alpha",
                                         "num_pruned_svec"}
