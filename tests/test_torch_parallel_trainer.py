"""gsgen_torch ``Trainer(tile_mesh=...)`` and ``Trainer(data_mesh=...)``
vs the JAX trainer with a 4-device tile mesh and vs the port's
one-process trainer.

Every trainer starts from the JAX trainer's initial state with
anisotropic, rotated Gaussians (carried over with
``train_state_from_jax_arrays``), samples the same numpy cameras
(same seed) on a fixed background with mock guidance, and takes one step;
the port's ranks are 4 gloo processes started once for the file.  The
JAX test's tolerances (``test_parallel.py::test_trainer_with_tile_mesh``):
loss rtol 1e-4, updated means atol 1e-5.  Against the port's one-process
step: Adam first moments and ``grad_accum`` rtol 2e-3 / atol 2e-4 of
their largest value, ``grad_cnt`` and ``max_radii2d`` as the
one-process statistics, and parameters as ``test_torch_trainer.py``
holds them (Adam moves an element by about lr x sign(gradient), so an
element whose gradient sits at rounding level may move the other way: at
least 99.9% within 1e-4 of lr, all within 2 lr).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from gsgen_tpu.data.cameras import CameraSamplerConfig as CamJ
from gsgen_tpu.guidance.mock import MockGuidance as MockJ
from gsgen_tpu.io.checkpoint import _flatten_with_paths
from gsgen_tpu.models.background import BackgroundConfig as BgJ
from gsgen_tpu.models.density import DensifyConfig as DensJ
from gsgen_tpu.models.density import PruneConfig as PruneJ
from gsgen_tpu.models.init import InitConfig as InitJ
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.parallel.mesh import make_mesh as make_mesh_j
from gsgen_tpu.training.trainer import Trainer as TrainerJ
from gsgen_tpu.training.trainer import TrainerConfig as TcfgJ
from gsgen_torch.models.scene import FIELDS
from gsgen_torch.training.trainer import TrainerConfig
from torch_fixtures import scene3d

RKW = dict(dup_cap=8192, chunk=64, tile_size=8, backend="xla")
KW = dict(cfg=dict(max_steps=10, batch_size=2, seed=3, auto_dup_bucket=False,
                   eval_image_period=0, eval_video_period=0, save_period=0),
          init=dict(num_points=64, capacity=64, svec_val=0.05, mean_std=0.4),
          data=dict(batch_size=2, max_steps=10, reso=(64,)))
# each field's initial learning rate (the trainers' default schedules)
LR = {f: v if np.isscalar(v) else v[0] for f, v in TrainerConfig().lr.items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer with a 4-device tile mesh: its initial state (as
    flattened numpy arrays), then its first step's metrics and state."""
    tj = TrainerJ(cfg=TcfgJ(**KW["cfg"]), rcfg=RenderJ(**RKW),
                  init_cfg=InitJ(**KW["init"]), bg_cfg=BgJ(type="fixed"),
                  data_cfg=CamJ(**KW["data"]), guidance=MockJ(),
                  dcfg=DensJ(enabled=False), pcfg=PruneJ(enabled=False),
                  tile_mesh=make_mesh_j(4, axes=("tile",)))
    # anisotropic, rotated Gaussians (the base init is isotropic, whose
    # rotation gradient is zero up to rounding)
    raw = scene3d(64, seed=11, mean_std=0.4)
    tj.state = tj.state._replace(scene=tj.state.scene._replace(
        params=GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS})))
    state0 = {k: np.asarray(v) for k, v in
              _flatten_with_paths(tj.state).items()}
    m = tj.train_step(0)
    return state0, {k: np.asarray(v) for k, v in m.items()}, \
        _flatten_with_paths(tj.state)


@pytest.fixture(scope="module")
def port(jax_run, tmp_path_factory):
    return ranks.run(ranks.trainer_cases, dict(
        state=jax_run[0], rcfg=RKW, trainer=KW),
        tmp_path_factory.mktemp("trainer"))


def _one_process(state0, batch):
    """The port's one-process trainer from the same state, one step."""
    inp = dict(state=state0, rcfg=RKW, trainer=dict(
        KW, cfg=dict(KW["cfg"], batch_size=batch),
        data=dict(KW["data"], batch_size=batch)))
    tr = ranks._trainer(inp)
    return ranks._trainer_result(tr, tr.train_step(0))


@pytest.fixture(scope="module")
def one_process(jax_run):
    return {2: _one_process(jax_run[0], 2), 4: _one_process(jax_run[0], 4)}


def test_tile_mesh_trainer_matches_jax(port, jax_run):
    _, m_j, arrays = jax_run
    got = port[0]["tile"]
    np.testing.assert_allclose(float(got["metrics"]["loss_total"]),
                               float(m_j["loss_total"]), rtol=1e-4)
    np.testing.assert_allclose(got["params"]["mean"],
                               arrays[".scene/.params/.mean"], atol=1e-5)


def test_tile_mesh_bucket_sees_summed_duplicates(port, jax_run):
    """n_dup_max is the largest view's duplicates summed over its slabs,
    which the JAX trainer's bucket policy reads too."""
    assert int(port[0]["tile"]["metrics"]["n_dup_max"]) == \
        int(jax_run[1]["n_dup_max"])


def _check_step(got, want, what):
    np.testing.assert_allclose(float(got["metrics"]["loss_total"]),
                               float(want["metrics"]["loss_total"]),
                               rtol=1e-4, err_msg=what)
    for f in FIELDS:
        mu = want["mu"][f]
        np.testing.assert_allclose(got["mu"][f], mu, rtol=2e-3,
                                   atol=2e-4 * np.abs(mu).max(),
                                   err_msg=f"{what} mu {f}")
        diff = np.abs(got["params"][f] - want["params"][f])
        assert diff.max() <= 2 * LR[f], (what, f)
        assert np.mean(diff <= 1e-4 * LR[f] + 1e-6) >= 0.999, (what, f)
    acc = want["stats"]["grad_accum"]
    np.testing.assert_allclose(got["stats"]["grad_accum"], acc, rtol=2e-3,
                               atol=2e-4 * np.abs(acc).max(), err_msg=what)
    for s in ("grad_cnt", "max_radii2d"):
        np.testing.assert_allclose(got["stats"][s], want["stats"][s],
                                   rtol=1e-6, err_msg=f"{what} {s}")


@pytest.mark.parametrize("case,batch", [("tile", 2), ("data", 4),
                                        ("data_tile", 4)])
def test_sharded_step_matches_one_process(port, one_process, case, batch):
    for r, res in enumerate(port):
        _check_step(res[case], one_process[batch], f"{case} rank {r}")


def test_data_mesh_bucket_jumps_from_the_reduced_demand(port, jax_run):
    """Across a resolution switch every data rank predicts the bucket from
    n_dup_max reduced over the ranks, so all jump alike, as the
    one-process trainer over the whole batch does."""
    inp = ranks.c2f_inputs(dict(state=jax_run[0], rcfg=RKW, trainer=dict(
        KW, cfg=dict(KW["cfg"], batch_size=4),
        data=dict(KW["data"], batch_size=4))))
    want = ranks.c2f_steps(ranks._trainer(inp))
    assert want["bucket"][1] > want["bucket"][0], want
    for r, res in enumerate(port):
        assert res["data_c2f"] == want, (r, res["data_c2f"], want)


@pytest.mark.parametrize("case", ["tile", "data", "data_tile"])
def test_ranks_end_the_step_alike(port, case):
    """Every rank holds the same state after the step (the all-reduced
    gradients and statistics are the same on each)."""
    for r in range(1, ranks.WORLD):
        for f in FIELDS:
            np.testing.assert_array_equal(port[r][case]["params"][f],
                                          port[0][case]["params"][f])
        for s, v in port[0][case]["stats"].items():
            np.testing.assert_array_equal(port[r][case]["stats"][s], v)
