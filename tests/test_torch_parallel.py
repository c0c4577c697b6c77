"""gsgen_torch tile-sharded rendering (``parallel/sharded_render.py``, the
slab arguments of ``render_view``) vs the JAX package's.

The JAX side runs on the 8-device virtual CPU mesh that conftest forces
(4 devices on the ``tile`` axis, 2 x 2 for data x tile); the port runs as
4 gloo ranks, started once for the file (``torch_parallel_ranks.py``).
Both get the JAX package's own small scene (``test_parallel.py``: 300
Gaussians, 64^2, tile 8, chunk 64, the XLA backend) as numpy arrays.
Tolerances are the JAX tests': images rtol 1e-4 / atol 1e-5 (T atol
1e-6), tile-sharded gradients rtol 5e-3 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from gsgen_tpu.models.init import InitConfig as InitJ
from gsgen_tpu.models.init import initialize as initialize_j
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.models.scene import render_view as render_view_j
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_tpu.parallel.mesh import make_mesh as make_mesh_j
from gsgen_tpu.parallel.sharded_render import \
    render_batch_data_tile_sharded as data_tile_j
from gsgen_tpu.parallel.sharded_render import \
    render_view_tile_sharded as tile_j
from gsgen_torch.models.scene import FIELDS, RenderConfig, render_view
from gsgen_torch.ops import binning
from gsgen_torch.ops.camera import CameraIntrinsics

RKW = dict(dup_cap=8192, chunk=64, tile_size=8, backend="xla")
RES = 64
IMG_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
IMAGE_KEYS = ("rgb", "T", "depth", "opacity", "z_var")


def _c2w(deg):
    """Camera at distance 2.5 on the x-z circle, looking at the origin."""
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0, -np.sin(a), 2.5 * np.sin(a)],
                     [0, 1, 0, 0],
                     [np.sin(a), 0, np.cos(a), -2.5 * np.cos(a)]],
                    np.float32)


C2W = _c2w(0.0)
C2WS = np.stack([_c2w(a) for a in (0.0, 20.0, -20.0, 40.0)])


@pytest.fixture(scope="module")
def scene():
    st = initialize_j(jax.random.PRNGKey(0),
                      InitJ(num_points=300, svec_val=0.04, mean_std=0.4),
                      RenderJ(**RKW))
    raw = {f: np.asarray(getattr(st.params, f)) for f in FIELDS}
    raw["active"] = np.asarray(st.active)
    return raw


@pytest.fixture(scope="module")
def port(scene, tmp_path_factory):
    """Every rank's results of ``tile_cases``."""
    return ranks.run(ranks.tile_cases, dict(
        scene=scene, rcfg=RKW, reso=RES, c2w=C2W, c2ws=C2WS),
        tmp_path_factory.mktemp("tile"))


def _params_j(raw):
    from gsgen_tpu.models.scene import GaussianParams
    return GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS})


@pytest.fixture(scope="module")
def jax_tile(scene):
    """The JAX tile-sharded render on 4 devices and its gradients."""
    mesh = make_mesh_j(4, axes=("tile",))
    active = jnp.asarray(scene["active"])

    def loss(params, tap):
        out = tile_j(params, active, jnp.asarray(C2W), IntrJ.from_reso(RES),
                     RenderJ(**RKW), jnp.ones((3,)), mesh, mean2d_tap=tap)
        return jnp.mean(out["rgb"] ** 2), out

    (_, out), (g, g_tap) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        _params_j(scene), jnp.zeros((active.shape[0], 2), jnp.float32))
    grads = {f: np.asarray(getattr(g, f)) for f in FIELDS}
    grads["tap"] = np.asarray(g_tap)
    return {k: np.asarray(v) for k, v in out.items()}, grads


def _t_params(raw, grad=False):
    return {f: torch.tensor(raw[f], requires_grad=grad) for f in FIELDS}


@pytest.fixture(scope="module")
def one_process(scene):
    """The port's unsharded render of the same view and its gradients."""
    p = _t_params(scene, grad=True)
    tap = torch.zeros(len(scene["active"]), 2, requires_grad=True)
    out = render_view(p, torch.tensor(scene["active"]), torch.tensor(C2W),
                      CameraIntrinsics.from_reso(RES), RenderConfig(**RKW),
                      torch.ones(3), mean2d_tap=tap)
    g = torch.autograd.grad(torch.mean(out["rgb"] ** 2),
                            list(p.values()) + [tap])
    grads = {k: v.numpy() for k, v in zip(list(p) + ["tap"], g)}
    return {k: v.detach().numpy() for k, v in out.items()}, grads


def _check_out(got, want, what):
    for k in IMAGE_KEYS + ("radii2d",):
        tol = dict(IMG_TOL, atol=1e-6) if k == "T" else IMG_TOL
        np.testing.assert_allclose(got[k], want[k], **tol,
                                   err_msg=f"{what} {k}")
    np.testing.assert_array_equal(got["visible"], want["visible"])
    assert int(got["n_dup"]) == int(want["n_dup"]), what


def test_tile_sharded_render_matches_jax(port, jax_tile):
    _check_out(port[0]["out"], jax_tile[0], "vs JAX")


def test_tile_sharded_render_matches_one_process(port, one_process):
    _check_out(port[0]["out"], one_process[0], "vs one process")


def test_every_rank_gets_the_whole_view(port):
    for r in range(1, ranks.WORLD):
        for k, v in port[0]["out"].items():
            np.testing.assert_array_equal(port[r]["out"][k], v, err_msg=k)
        for k, v in port[0]["grads"].items():
            np.testing.assert_array_equal(port[r]["grads"][k], v, err_msg=k)


@pytest.mark.parametrize("field", FIELDS + ("tap",))
def test_tile_sharded_gradients_match_jax(port, jax_tile, field):
    np.testing.assert_allclose(port[0]["grads"][field], jax_tile[1][field],
                               **GRAD_TOL)


@pytest.mark.parametrize("field", FIELDS + ("tap",))
def test_tile_sharded_gradients_match_one_process(port, one_process, field):
    np.testing.assert_allclose(port[0]["grads"][field],
                               one_process[1][field], **GRAD_TOL)


def test_tile_sharded_needs_h_divisible(port):
    assert "must divide by devices*tile_size=32" in port[0]["h_error"]


def test_mesh_helpers(port):
    for r, res in enumerate(port):
        h = res["helpers"]
        d, t = h["coords"]
        assert (d, t) == divmod(r, 2)
        np.testing.assert_array_equal(
            h["shard"], np.arange(8.0).reshape(4, 2)[2 * d:2 * d + 2])
        np.testing.assert_array_equal(h["replicate"], np.zeros(3))
        assert h["placements"] == ("(Replicate(), Replicate())",
                                   "(Shard(dim=0), Replicate())")


def test_data_tile_render_matches_jax(port, scene):
    mesh = make_mesh_j(4, axes=("data", "tile"), shape=(2, 2))
    rgb = jax.jit(lambda p: data_tile_j(
        p, jnp.asarray(scene["active"]), jnp.asarray(C2WS),
        IntrJ.from_reso(RES), RenderJ(**RKW), jnp.ones((4, 3)), mesh))(
        _params_j(scene))
    np.testing.assert_allclose(port[0]["rgb_2d"], np.asarray(rgb),
                               **IMG_TOL)


def test_data_tile_gradients_match_one_process(port, scene):
    p = _t_params(scene, grad=True)
    rgb = torch.stack([render_view(
        p, torch.tensor(scene["active"]), torch.tensor(c), CameraIntrinsics
        .from_reso(RES), RenderConfig(**RKW), torch.ones(3),
        rgb_only=True)["rgb"] for c in C2WS])
    np.testing.assert_allclose(port[0]["rgb_2d"], rgb.detach().numpy(),
                               **IMG_TOL)
    g = torch.autograd.grad(torch.mean(rgb ** 2), list(p.values()))
    for f, gr in zip(p, g):
        np.testing.assert_allclose(port[3]["grads_2d"][f], gr.numpy(),
                                   **GRAD_TOL, err_msg=f)


@pytest.mark.parametrize("y0", [0, 16, 32, 48])
def test_slab_render_matches_jax_and_full_rows(scene, y0):
    """One slab alone through render_view: ``cull_intr`` (the full
    camera) and ``pixel_offset_y``, against the JAX render_view with the
    same arguments and against the slab's rows of the full render."""
    intr_j = IntrJ.from_reso(RES)
    slab_j = dataclasses.replace(intr_j, h=16)
    want = jax.jit(lambda p, y: render_view_j(
        p, jnp.asarray(scene["active"]), jnp.asarray(C2W), slab_j,
        RenderJ(**RKW), jnp.ones((3,)), cull_intr=intr_j,
        pixel_offset_y=y))(_params_j(scene), jnp.int32(y0))
    intr = CameraIntrinsics.from_reso(RES)
    args = (_t_params(scene), torch.tensor(scene["active"]),
            torch.tensor(C2W))
    with torch.no_grad():
        got = render_view(*args, dataclasses.replace(intr, h=16),
                          RenderConfig(**RKW), torch.ones(3),
                          cull_intr=intr, pixel_offset_y=y0)
        full = render_view(*args, intr, RenderConfig(**RKW), torch.ones(3))
    for k in ("rgb", "T", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **IMG_TOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(),
                                   full[k][y0:y0 + 16].numpy(), **IMG_TOL,
                                   err_msg=k)
    assert int(got["n_dup"]) == int(want["n_dup"])
    np.testing.assert_array_equal(got["visible"].numpy(),
                                  np.asarray(want["visible"]))


def test_slab_binning_keeps_saturated_footprints():
    """A footprint whose top bound saturates at INT_MIN stays in every
    slab it covers: its rows are shifted saturating (the JAX package's
    int32 subtraction wraps it to a large positive row and drops it from
    every slab below the first)."""
    mean2d = torch.tensor([[0.0, 0.0], [0.1, 0.1]])
    cov2d = torch.tensor([[[1e-4, 0.0], [0.0, 1e15]],
                          [[1e-3, 0.0], [0.0, 1e-3]]])
    aabb = binning.tile_aabbs(mean2d, cov2d, 64.0, 64.0, 32.0, 32.0, 64, 64,
                              8)
    assert aabb[4].tolist() == [True, True]
    for y0 in (16, 32, 48):
        tl_x, tl_y, br_x, br_y, overlaps = binning.tile_aabbs(
            mean2d, cov2d, 64.0, 64.0, 32.0, 32.0, 64, 16, 8,
            pixel_offset_y=y0)
        assert bool(overlaps[0]), y0
        assert (int(tl_y[0]), int(br_y[0])) == (0, 1), y0


def test_one_process_needs_no_group():
    """init_distributed is a no-op for one process; a mesh needs a group."""
    import torch.distributed as dist

    from gsgen_torch.parallel.mesh import init_distributed, make_mesh
    assert init_distributed() is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(1, ("tile",), device_type="cpu")
