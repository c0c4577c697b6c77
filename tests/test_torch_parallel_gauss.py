"""gsgen_torch Gaussian-sharded rendering (``parallel/gaussian_sharded.py``)
vs the JAX package's, the sharded-state helpers, and the guidance
``Protocol``.

The JAX side runs on the 8-device virtual CPU mesh (4 devices on
``gauss``, 2 x 2 for gauss x tile), the port as 4 gloo ranks started once
for the file (``torch_parallel_ranks.py``), both on the same numpy scene:
256 live Gaussians in a capacity of 512, 64^2, tile 8, chunk 64.
Tolerances: images rtol 1e-4 / atol 1e-5 (T atol 1e-6); the
Gaussian-sharded gradients rtol 1e-5 / atol 1e-7
(``test_gaussian_sharded.py``'s own), against the JAX sharded render and
against the port's one-process render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from gsgen_tpu.models.init import InitConfig as InitJ
from gsgen_tpu.models.init import initialize as initialize_j
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_tpu.parallel import gaussian_sharded as gs_j
from gsgen_tpu.parallel.mesh import make_mesh as make_mesh_j
from gsgen_torch.guidance.base import Guidance
from gsgen_torch.guidance.mock import MockGuidance
from gsgen_torch.guidance.sds import SDSGuidance
from gsgen_torch.guidance.vsd import VSDGuidance
from gsgen_torch.models.scene import (FIELDS, RenderConfig, render_view,
                                      scene_from_numpy)
from gsgen_torch.ops.camera import CameraIntrinsics
from gsgen_torch.parallel.gaussian_sharded import interleave_shards

RKW = dict(dup_cap=8192, chunk=64, tile_size=8, backend="xla")
RES = 64
C2W = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.5]], np.float32)
IMG_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
STATS = ("max_radii2d", "grad_accum", "grad_cnt")


@pytest.fixture(scope="module")
def scene():
    st = initialize_j(jax.random.PRNGKey(0),
                      InitJ(num_points=256, capacity=512, svec_val=0.05,
                            mean_std=0.4), RenderJ(**RKW))
    raw = {f: np.asarray(getattr(st.params, f)) for f in FIELDS}
    raw["active"] = np.asarray(st.active)
    rng = np.random.default_rng(0)
    for s in STATS:
        raw[s] = rng.uniform(0.0, 1.0, 512).astype(np.float32)
    return raw


@pytest.fixture(scope="module")
def port(scene, tmp_path_factory):
    return ranks.run(ranks.gauss_cases, dict(
        scene=scene, rcfg=RKW, reso=RES, c2w=C2W),
        tmp_path_factory.mktemp("gauss"))


def _sharded_j(scene, mesh):
    sh = NamedSharding(mesh, P("gauss"))
    params = GaussianParams(**{f: jax.device_put(jnp.asarray(scene[f]), sh)
                               for f in FIELDS})
    return params, jax.device_put(jnp.asarray(scene["active"]), sh)


@pytest.fixture(scope="module")
def jax_gauss(scene):
    mesh = make_mesh_j(4, axes=("gauss",))
    params, active = _sharded_j(scene, mesh)
    tap = jax.device_put(jnp.zeros((512, 2), jnp.float32),
                         NamedSharding(mesh, P("gauss")))

    def loss(p, t):
        out = gs_j.render_view_gaussian_sharded(
            p, active, jnp.asarray(C2W), IntrJ.from_reso(RES),
            RenderJ(**RKW), jnp.ones((3,)), mesh, mean2d_tap=t)
        return jnp.mean(out["rgb"] ** 2) + jnp.mean(out["T"]), out

    (_, out), (g, g_tap) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, tap)
    grads = {f: np.asarray(getattr(g, f)) for f in FIELDS}
    grads["tap"] = np.asarray(g_tap)
    return {k: np.asarray(v) for k, v in out.items()}, grads


@pytest.fixture(scope="module")
def jax_gauss_tile(scene):
    mesh = make_mesh_j(4, axes=("gauss", "tile"), shape=(2, 2))
    params, active = _sharded_j(scene, mesh)

    def loss(p):
        out = gs_j.render_view_gauss_tile_sharded(
            p, active, jnp.asarray(C2W), IntrJ.from_reso(RES),
            RenderJ(**RKW), jnp.ones((3,)), mesh)
        return jnp.mean(out["rgb"] ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return ({k: np.asarray(v) for k, v in out.items()},
            {f: np.asarray(getattr(g, f)) for f in FIELDS})


@pytest.fixture(scope="module")
def one_process(scene):
    """The port's unsharded render and the gradients of both losses."""
    def run(rgb_only):
        p = {f: torch.tensor(scene[f], requires_grad=True) for f in FIELDS}
        tap = torch.zeros(512, 2, requires_grad=True)
        out = render_view(p, torch.tensor(scene["active"]),
                          torch.tensor(C2W), CameraIntrinsics.from_reso(RES),
                          RenderConfig(**RKW), torch.ones(3),
                          rgb_only=rgb_only, mean2d_tap=tap)
        loss = torch.mean(out["rgb"] ** 2)
        if not rgb_only:
            loss = loss + torch.mean(out["T"])
        g = torch.autograd.grad(loss, list(p.values()) + [tap])
        return ({k: v.detach().numpy() for k, v in out.items()},
                {k: v.numpy() for k, v in zip(list(p) + ["tap"], g)})
    return run(False), run(True)


def _cat(port, key, ranks_=range(ranks.WORLD)):
    """A per-Gaussian result, its shards concatenated in rank order."""
    return {k: np.concatenate([port[r][key][k] for r in ranks_])
            for k in port[0][key]}


def _check_images(got, want, keys):
    for k in keys:
        tol = dict(IMG_TOL, atol=1e-6) if k == "T" else IMG_TOL
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)
    assert int(got["n_dup"]) == int(want["n_dup"])


@pytest.mark.parametrize("ref", ["jax", "one_process"])
def test_gaussian_sharded_render(port, jax_gauss, one_process, ref):
    want = jax_gauss[0] if ref == "jax" else one_process[0][0]
    _check_images(port[0]["out"], want, ("rgb", "T", "depth", "opacity",
                                         "z_var"))
    got = {k: np.concatenate([port[r]["out"][k] for r in range(4)])
           for k in ("radii2d", "visible")}
    np.testing.assert_allclose(got["radii2d"], want["radii2d"], **IMG_TOL)
    np.testing.assert_array_equal(got["visible"], want["visible"])


@pytest.mark.parametrize("field", FIELDS + ("tap",))
def test_gaussian_sharded_gradients_reduce_scatter(port, jax_gauss,
                                                   one_process, field):
    """Each rank gets its own shard's gradient rows."""
    got = _cat(port, "grads")[field]
    assert port[0]["grads"][field].shape[0] == 512 // ranks.WORLD
    np.testing.assert_allclose(got, one_process[0][1][field], **GRAD_TOL)
    np.testing.assert_allclose(got, jax_gauss[1][field], **GRAD_TOL)


@pytest.mark.parametrize("ref", ["jax", "one_process"])
def test_gauss_tile_render(port, jax_gauss_tile, one_process, ref):
    want = jax_gauss_tile[0] if ref == "jax" else one_process[1][0]
    for r in range(ranks.WORLD):
        _check_images(port[r]["out_gt"], want, ("rgb", "T"))


@pytest.mark.parametrize("field", FIELDS)
def test_gauss_tile_gradients(port, jax_gauss_tile, one_process, field):
    """Rank (g, t) holds shard g's gradient, summed over every slab."""
    got = _cat(port, "grads_gt", (0, 2))[field]
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(port[a]["grads_gt"][field],
                                      port[b]["grads_gt"][field])
    np.testing.assert_allclose(got, one_process[1][1][field], **GRAD_TOL)
    np.testing.assert_allclose(got, jax_gauss_tile[1][field],
                               **GRAD_TOL)


def test_interleave_shards_matches_jax(scene):
    from gsgen_tpu.models.scene import SceneState as SceneJ
    st_j = SceneJ(params=GaussianParams(**{f: jnp.asarray(scene[f])
                                           for f in FIELDS}),
                  active=jnp.asarray(scene["active"]),
                  **{s: jnp.asarray(scene[s]) for s in STATS})
    want = gs_j.interleave_shards(st_j, 4)
    got = interleave_shards(scene_from_numpy(scene, "cpu"), 4)
    for f in FIELDS:
        np.testing.assert_array_equal(got.params[f].numpy(),
                                      np.asarray(getattr(want.params, f)))
    for s in ("active",) + STATS:
        np.testing.assert_array_equal(getattr(got, s).numpy(),
                                      np.asarray(getattr(want, s)))
    # numpy arrays too, and the scene's live rows spread over the shards
    arr = interleave_shards({"active": scene["active"]}, 4)["active"]
    assert [int(a.sum()) for a in np.split(arr, 4)] == [64] * 4


@pytest.mark.parametrize("rank", range(4))
def test_state_converter_builds_a_shard(scene, port, rank):
    """scene_from_numpy(shard=(rank, D)) holds the rank's rows of the
    interleaved scene; shard_scene on the ranks cut the scene itself."""
    inter = interleave_shards(scene, 4)
    got = scene_from_numpy(scene, "cpu", shard=(rank, 4))
    rows = slice(rank * 128, (rank + 1) * 128)
    for f in FIELDS:
        np.testing.assert_array_equal(got.params[f].numpy(), inter[f][rows])
        np.testing.assert_array_equal(port[rank]["sharded"][f],
                                      scene[f][rows])
    for s in ("active",) + STATS:
        np.testing.assert_array_equal(getattr(got, s).numpy(),
                                      inter[s][rows])


@pytest.mark.parametrize("cls", [MockGuidance, SDSGuidance, VSDGuidance])
def test_guidance_protocol(cls):
    """Every guidance of the port has the Protocol's ``loss``."""
    assert issubclass(cls, Guidance)
    assert isinstance(MockGuidance(), Guidance)
