"""gsgen_torch Gaussian-sharded training (``gaussian_sharded_train_step``,
``sharded_density_step``, ``gauss_tile_train_step``) vs the JAX package's,
and the port's multichip dry run on 4 CPU ranks.

Both packages interleave the same numpy scene (256 anisotropic Gaussians
in a capacity of 512, 64^2, tile 8, chunk 64) over 4 shards (2 on the
gauss x tile mesh), take Gaussian-sharded Adam steps with one shard-local
densify (clone and split) + prune event after step 2, and gauss x tile
steps.  The event's split offsets are the JAX event's own draws: it draws
with the same key on every shard, one ``split`` per copy, then
``normal(k, [N/4, 3])``, which the port's ranks get as ``noise``.
Compared: the event's counts and the live mask exactly (the allocation is
deterministic per shard), the losses as ``test_gaussian_sharded.py``
holds them (rtol 1e-6 / atol 1e-7 before the event, rtol 2e-3 / atol
1e-5 throughout; rel 2e-3 on gauss x tile), the parameters after the
first step where the gradient is meaningful as it holds them (rtol 1e-4 /
atol 1e-6), every parameter within 2 lr a step, and the two final
scenes' renders above 40 dB PSNR.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from gsgen_tpu.models.density import DensifyConfig as DensJ
from gsgen_tpu.models.density import PruneConfig as PruneJ
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.models.scene import SceneState as SceneJ
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_tpu.parallel import gaussian_sharded as gs_j
from gsgen_tpu.parallel.mesh import make_mesh as make_mesh_j
from gsgen_tpu.training.optimizer import adam_init as adam_init_j
from gsgen_torch.models.scene import FIELDS, RenderConfig, render_view
from gsgen_torch.ops.camera import CameraIntrinsics
from gsgen_torch.parallel.dryrun import dryrun_multichip
from torch_fixtures import scene3d

RKW = dict(dup_cap=8192, chunk=64, tile_size=8, backend="xla")
RES = 64
C2W = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.5]], np.float32)
LR = 1e-2
STEPS, EVENT_AT, GT_STEPS = 5, 2, 3
# legacy clone + split: a Gaussian with any scale over 0.06 splits
DCFG = dict(mean2d_thresh=0.01, split_thresh=0.06, use_legacy=True)
PCFG = dict(enabled=True, alpha_thresh=0.35, radii2d_thresh=0.0)
KEY = 5


@pytest.fixture(scope="module")
def raw():
    """256 anisotropic, rotated Gaussians in a capacity of 512 (an
    isotropic scene's rotation gradient is zero up to rounding)."""
    return scene3d(256, seed=3, capacity=512, mean_std=0.4, svec=0.05)


@pytest.fixture(scope="module")
def scene_j(raw):
    zeros = jnp.zeros(512, jnp.float32)
    return SceneJ(params=GaussianParams(**{f: jnp.asarray(raw[f])
                                           for f in FIELDS}),
                  active=jnp.asarray(raw["active"]), max_radii2d=zeros,
                  grad_accum=zeros, grad_cnt=zeros)


def _put(tree, mesh):
    sh = NamedSharding(mesh, P("gauss"))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sh) if getattr(x, "ndim", 0) >= 1
        else x, tree)


def _hot(st):
    return st._replace(grad_accum=jnp.ones_like(st.grad_accum) * 10.0,
                       grad_cnt=jnp.ones_like(st.grad_cnt))


def _noise():
    """The JAX event's split draws on one shard of 128 rows."""
    key, out = jax.random.PRNGKey(KEY), []
    for _ in range(2):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (128, 3))))
    return out


@pytest.fixture(scope="module")
def jax_run(scene_j):
    mesh = make_mesh_j(4, axes=("gauss",))
    intr, rcfg, bg = IntrJ.from_reso(RES), RenderJ(**RKW), jnp.ones((3,))
    st = _put(gs_j.interleave_shards(scene_j, 4), mesh)
    opt = _put(gs_j.interleave_shards(adam_init_j(scene_j.params), 4), mesh)
    step = gs_j.gaussian_sharded_train_step(mesh, intr, rcfg, lr=LR)
    losses = []
    for s in range(STEPS):
        p, opt, loss = step(st.params, st.active, opt, jnp.asarray(C2W), bg)
        st = st._replace(params=p)
        losses.append(float(loss))
        if s == 0:
            first = ({f: np.asarray(getattr(p, f)) for f in FIELDS},
                     {f: np.asarray(getattr(opt.mu, f)) for f in FIELDS})
        if s == EVENT_AT:
            st = _hot(st)
            build = gs_j.sharded_density_step(mesh, DensJ(**DCFG),
                                              PruneJ(**PCFG), rcfg)
            st, opt, info = build(st, opt)(
                st, opt, jax.random.PRNGKey(KEY), jnp.float32(0.0),
                jnp.float32(PCFG["alpha_thresh"]))
    res = dict(losses=losses, info={k: int(v) for k, v in info.items()},
               first=first,
               params={f: np.asarray(getattr(st.params, f)) for f in FIELDS},
               active=np.asarray(st.active))

    mesh2 = make_mesh_j(4, axes=("gauss", "tile"), shape=(2, 2))
    st2 = _put(gs_j.interleave_shards(scene_j, 2), mesh2)
    opt2 = _put(gs_j.interleave_shards(adam_init_j(scene_j.params), 2),
                mesh2)
    step2 = gs_j.gauss_tile_train_step(mesh2, intr, rcfg, lr=LR)
    gt_losses = []
    for _ in range(GT_STEPS):
        p, opt2, loss = step2(st2.params, st2.active, opt2,
                              jnp.asarray(C2W), bg)
        st2 = st2._replace(params=p)
        gt_losses.append(float(loss))
    res.update(gt_losses=gt_losses, gt_active=np.asarray(st2.active),
               gt_params={f: np.asarray(getattr(st2.params, f))
                          for f in FIELDS})
    return res


@pytest.fixture(scope="module")
def port(raw, tmp_path_factory):
    return ranks.run(ranks.density_cases, dict(
        scene=raw, rcfg=RKW, reso=RES, c2w=C2W, steps=STEPS,
        event_at=EVENT_AT, gt_steps=GT_STEPS, dcfg=DCFG, pcfg=PCFG,
        noise=_noise(), lr=LR), tmp_path_factory.mktemp("density"))


def _within_steps(got, want, steps, what):
    """Adam moves an element by at most about lr a step."""
    for f in FIELDS:
        assert np.abs(got[f] - want[f]).max() <= 2 * LR * steps, (what, f)


def _psnr(a, b):
    return -10.0 * np.log10(float(np.mean((a - b) ** 2)) + 1e-12)


def _render(params, active):
    with torch.no_grad():
        return render_view({f: torch.tensor(params[f]) for f in FIELDS},
                           torch.tensor(active), torch.tensor(C2W),
                           CameraIntrinsics.from_reso(RES),
                           RenderConfig(**RKW), torch.ones(3),
                           rgb_only=True)["rgb"].numpy()


def _cat(port, key, sub, ranks_=range(ranks.WORLD)):
    """``port[r][key][sub]`` (a dict of per-Gaussian arrays) of the given
    ranks, concatenated in rank order."""
    return {k: np.concatenate([port[r][key][sub][k] for r in ranks_])
            for k in port[0][key][sub]}


def test_event_counts_match_jax(port, jax_run):
    assert port[0]["info"] == jax_run["info"]
    assert jax_run["info"]["num_clone"] > 0 and \
        jax_run["info"]["num_split"] > 0
    assert jax_run["info"]["num_pruned_alpha"] > 0
    for r in range(1, ranks.WORLD):
        assert port[r]["info"] == port[0]["info"]


def test_event_is_shard_local_like_jax(port, jax_run):
    """The same slots hold the same Gaussians: live mask equal."""
    active = np.concatenate([port[r]["state"]["active"]
                             for r in range(ranks.WORLD)])
    np.testing.assert_array_equal(active, jax_run["active"])


def test_sharded_train_losses_match_jax(port, jax_run):
    got, want = port[0]["losses"], jax_run["losses"]
    np.testing.assert_allclose(got[:EVENT_AT + 1], want[:EVENT_AT + 1],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)


def test_first_sharded_step_matches_jax(port, jax_run):
    """After one step, where the gradient is meaningful (|mu| / 0.1 over
    1e-6): parameters rtol 1e-4 / atol 1e-6 (test_gaussian_sharded.py's
    rule; elsewhere Adam's eps=1e-15 step is sign(rounding noise))."""
    p_j, mu_j = jax_run["first"]
    params = _cat(port, "first", "params")
    mu = _cat(port, "first", "mu")
    for f in FIELDS:
        sig = np.abs(mu_j[f]) > 1e-7
        assert sig.sum() >= 100, f         # not a vacuous comparison
        np.testing.assert_allclose(params[f][sig], p_j[f][sig], rtol=1e-4,
                                   atol=1e-6, err_msg=f)
        np.testing.assert_allclose(mu[f], mu_j[f], rtol=2e-3,
                                   atol=2e-4 * np.abs(mu_j[f]).max(),
                                   err_msg=f)
    _within_steps(params, p_j, 1, "first step")


def test_sharded_train_state_matches_jax(port, jax_run):
    """The final states render alike (> 40 dB, test_gaussian_sharded.py's
    bar for two runs of Adam steps and events)."""
    params = _cat(port, "state", "params")
    _within_steps(params, jax_run["params"], STEPS, "gauss")
    active = np.concatenate([port[r]["state"]["active"]
                             for r in range(ranks.WORLD)])
    assert _psnr(_render(params, active),
                 _render(jax_run["params"], jax_run["active"])) > 40.0


def test_moments_stay_on_their_shard(port):
    for r in range(ranks.WORLD):
        for f in FIELDS:
            assert port[r]["state"]["mu"][f].shape[0] == 512 // ranks.WORLD
            assert port[r]["state"]["nu"][f].shape[0] == 512 // ranks.WORLD


def test_gauss_tile_train_steps_match_jax(port, jax_run):
    for r in range(ranks.WORLD):
        np.testing.assert_allclose(port[r]["gt_losses"],
                                   jax_run["gt_losses"], rtol=2e-3)
    params = {f: np.concatenate([port[r]["gt_params"][f] for r in (0, 2)])
              for f in FIELDS}      # ranks (0, t) and (1, t) hold the shards
    _within_steps(params, jax_run["gt_params"], GT_STEPS, "gauss x tile")
    active = jax_run["gt_active"]       # no event: the same on both sides
    assert _psnr(_render(params, active),
                 _render(jax_run["gt_params"], active)) > 40.0


def test_dryrun_multichip_on_cpu(capfd):
    dryrun_multichip(4, device_type="cpu")
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip ok")]
    assert len(lines) == 9, lines
