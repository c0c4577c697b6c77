"""Rank programs of the gsgen_torch parallel tests (no JAX here: the ranks
are new processes that import only torch and the port).

:func:`run` writes a test's inputs to a pickle, starts the ranks over
gloo (``gsgen_torch.parallel.mesh.spawn_ranks``) and returns what each
rank wrote back.  Each rank program runs every case of its test file, so
the ranks start once per file.
"""

import dataclasses
import pickle
from pathlib import Path

import torch

from gsgen_torch.data.cameras import CameraSamplerConfig
from gsgen_torch.guidance.mock import MockGuidance
from gsgen_torch.models.background import BackgroundConfig
from gsgen_torch.models.density import DensifyConfig, PruneConfig
from gsgen_torch.models.init import InitConfig
from gsgen_torch.models.scene import RenderConfig, scene_from_numpy
from gsgen_torch.ops.camera import CameraIntrinsics
from gsgen_torch.parallel.gaussian_sharded import (
    gauss_tile_train_step, gaussian_sharded_train_step, interleave_shards,
    render_view_gauss_tile_sharded, render_view_gaussian_sharded,
    shard_scene, sharded_density_step)
from gsgen_torch.parallel.mesh import (batch_sharded, make_mesh, replicate,
                                       replicated, shard_batch)
from gsgen_torch.parallel.sharded_render import (
    render_batch_data_tile_sharded, render_view_tile_sharded)
from gsgen_torch.training.optimizer import adam_init
from gsgen_torch.training.trainer import (Trainer, TrainerConfig,
                                          train_state_from_jax_arrays)

WORLD = 4


def run(fn, inputs, folder):
    """``fn(rank, folder)`` on WORLD gloo ranks; their outputs by rank."""
    from gsgen_torch.parallel.mesh import spawn_ranks
    folder = Path(folder)
    with open(folder / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn_ranks(fn, WORLD, str(folder), device_type="cpu")
    outs = []
    for r in range(WORLD):
        with open(folder / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _load(folder):
    with open(Path(folder) / "in.pkl", "rb") as f:
        return pickle.load(f)


def _save(folder, rank, res):
    with open(Path(folder) / f"out{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return x


def _params(raw):
    return {k: torch.tensor(raw[k]) for k in
            ("mean", "qvec", "svec", "color", "alpha")}


def _grads(loss, tensors):
    return dict(zip(tensors, torch.autograd.grad(loss,
                                                 list(tensors.values()))))


def _leaf(tensors):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in tensors.items()}


def _rcfg(d):
    return RenderConfig(**d)


def tile_cases(rank, folder):
    """Tile-sharded render and gradients (with a mean2d tap), the data x
    tile render and its gradients, the H % (D tile) error."""
    inp = _load(folder)
    rcfg, intr = _rcfg(inp["rcfg"]), CameraIntrinsics.from_reso(inp["reso"])
    c2w = torch.tensor(inp["c2w"])
    bg = torch.ones(3)
    active = torch.tensor(inp["scene"]["active"])
    res = {}
    mesh = make_mesh(WORLD, ("tile",), device_type="cpu")
    p = _leaf({**_params(inp["scene"]),
               "tap": torch.zeros(active.shape[0], 2)})
    tap = p.pop("tap")
    out = render_view_tile_sharded(p, active, c2w, intr, rcfg, bg, mesh,
                                   mean2d_tap=tap)
    res["out"] = _np(out)
    res["grads"] = _np(_grads(torch.mean(out["rgb"] ** 2),
                              {**p, "tap": tap}))
    try:
        render_view_tile_sharded(p, active, c2w,
                                 CameraIntrinsics.from_reso(48), rcfg, bg,
                                 mesh)
    except ValueError as e:
        res["h_error"] = str(e)

    mesh2 = make_mesh(WORLD, ("data", "tile"), shape=(2, 2),
                      device_type="cpu")
    res["helpers"] = dict(
        shard=_np(shard_batch({"x": torch.arange(8.0).reshape(4, 2)},
                              mesh2)["x"]),
        replicate=_np(replicate({"y": torch.full((3,), float(rank))},
                                mesh2)["y"]),
        placements=(repr(replicated(mesh2)), repr(batch_sharded(mesh2))),
        coords=(mesh2.get_local_rank("data"), mesh2.get_local_rank("tile")))
    p = _leaf(_params(inp["scene"]))
    c2ws = torch.tensor(inp["c2ws"])
    rgb = render_batch_data_tile_sharded(p, active, c2ws, intr, rcfg,
                                         torch.ones(len(c2ws), 3), mesh2)
    res["rgb_2d"] = _np(rgb)
    res["grads_2d"] = _np(_grads(torch.mean(rgb ** 2), p))
    _save(folder, rank, res)


def _trainer(inp, **mesh):
    kw = inp["trainer"]
    tr = Trainer(
        cfg=TrainerConfig(**kw["cfg"]), rcfg=_rcfg(inp["rcfg"]),
        init_cfg=InitConfig(**kw["init"]),
        bg_cfg=BackgroundConfig(type="fixed"),
        data_cfg=CameraSamplerConfig(**kw["data"]), guidance=MockGuidance(),
        dcfg=DensifyConfig(enabled=False), pcfg=PruneConfig(enabled=False),
        device="cpu", **mesh)
    tr.state = train_state_from_jax_arrays(inp["state"], "cpu")
    return tr


def _trainer_result(tr, m):
    st = tr.state
    return dict(metrics=_np(m), params=_np(st.scene.params),
                mu=_np(st.opt.mu),
                stats={s: _np(getattr(st.scene, s))
                       for s in ("grad_accum", "grad_cnt", "max_radii2d")})


def trainer_cases(rank, folder):
    """One trainer step with ``tile_mesh`` (batch of the JAX test), and
    one with ``data_mesh`` and one on a data x tile mesh (batch 4)."""
    inp = _load(folder)
    res = {}
    tr = _trainer(inp, tile_mesh=make_mesh(WORLD, ("tile",),
                                           device_type="cpu"))
    res["tile"] = _trainer_result(tr, tr.train_step(0))
    inp4 = dict(inp, trainer={**inp["trainer"], "cfg": {
        **inp["trainer"]["cfg"], "batch_size": 4}, "data": {
        **inp["trainer"]["data"], "batch_size": 4}})
    tr = _trainer(inp4, data_mesh=make_mesh(WORLD, ("data",),
                                            device_type="cpu"))
    res["data"] = _trainer_result(tr, tr.train_step(0))
    mesh2 = make_mesh(WORLD, ("data", "tile"), shape=(2, 2),
                      device_type="cpu")
    tr = _trainer(inp4, data_mesh=mesh2, tile_mesh=mesh2)
    res["data_tile"] = _trainer_result(tr, tr.train_step(0))
    tr = _trainer(c2f_inputs(inp4), data_mesh=make_mesh(
        WORLD, ("data",), device_type="cpu"))
    res["data_c2f"] = c2f_steps(tr)
    _save(folder, rank, res)


def c2f_inputs(inp):
    """``inp`` with a resolution switch at step 1 (32^2 -> 64^2) and the
    duplicate bucket's policy on, from a 512 bucket."""
    kw = inp["trainer"]
    return dict(inp, rcfg={**inp["rcfg"], "dup_cap": 512}, trainer={
        **kw, "cfg": {**kw["cfg"], "auto_dup_bucket": True,
                      "dup_bucket_min": 256},
        "data": {**kw["data"], "reso": (32, 64), "reso_milestones": (1,)}})


def c2f_steps(tr):
    """Two steps across the switch: each step's n_dup_max and bucket."""
    out = dict(n_dup_max=[], bucket=[])
    for s in range(2):
        out["n_dup_max"].append(int(tr.train_step(s)["n_dup_max"]))
        out["bucket"].append(tr.dup_bucket)
    return out


def gauss_cases(rank, folder):
    """The Gaussian-sharded render (with a mean2d tap) and the gauss x
    tile render, each with its gradients."""
    inp = _load(folder)
    rcfg, intr = _rcfg(inp["rcfg"]), CameraIntrinsics.from_reso(inp["reso"])
    c2w = torch.tensor(inp["c2w"])
    bg = torch.ones(3)
    res = {}
    mesh = make_mesh(WORLD, ("gauss",), device_type="cpu")
    st = shard_scene(scene_from_numpy(inp["scene"], "cpu"), mesh)
    p = _leaf({**st.params, "tap": torch.zeros(st.active.shape[0], 2)})
    tap = p.pop("tap")
    out = render_view_gaussian_sharded(p, st.active, c2w, intr, rcfg, bg,
                                       mesh, mean2d_tap=tap)
    res["out"] = _np(out)
    res["grads"] = _np(_grads(torch.mean(out["rgb"] ** 2)
                              + torch.mean(out["T"]), {**p, "tap": tap}))
    res["sharded"] = _np(st.params)

    mesh2 = make_mesh(WORLD, ("gauss", "tile"), shape=(2, 2),
                      device_type="cpu")
    st2 = shard_scene(scene_from_numpy(inp["scene"], "cpu"), mesh2)
    p = _leaf(st2.params)
    out = render_view_gauss_tile_sharded(p, st2.active, c2w, intr, rcfg, bg,
                                         mesh2)
    res["out_gt"] = _np(out)
    res["grads_gt"] = _np(_grads(torch.mean(out["rgb"] ** 2), p))
    _save(folder, rank, res)


def density_cases(rank, folder):
    """Gaussian-sharded train steps with a shard-local densify and prune
    event between them (split offsets injected), and gauss x tile train
    steps."""
    inp = _load(folder)
    rcfg, intr = _rcfg(inp["rcfg"]), CameraIntrinsics.from_reso(inp["reso"])
    c2w = torch.tensor(inp["c2w"])
    bg = torch.ones(3)
    res = {}
    mesh = make_mesh(WORLD, ("gauss",), device_type="cpu")
    full = scene_from_numpy(inp["scene"], "cpu")
    st = shard_scene(interleave_shards(full, WORLD), mesh)
    opt = shard_scene(interleave_shards(adam_init(full.params), WORLD), mesh)
    step = gaussian_sharded_train_step(mesh, intr, rcfg, lr=inp["lr"])
    event = sharded_density_step(mesh, DensifyConfig(**inp["dcfg"]),
                                 PruneConfig(**inp["pcfg"]), rcfg)
    losses = []
    for s in range(inp["steps"]):
        params, opt, loss = step(st.params, st.active, opt, c2w, bg)
        st = dataclasses.replace(st, params=params)
        losses.append(float(loss))
        if s == 0:
            res["first"] = dict(params=_np(params), mu=_np(opt.mu))
        if s == inp["event_at"]:
            st = dataclasses.replace(
                st, grad_accum=torch.full_like(st.grad_accum, 10.0),
                grad_cnt=torch.ones_like(st.grad_cnt))
            st, opt, info = event(st, opt, 0.0, inp["pcfg"]["alpha_thresh"],
                                  noise=[torch.tensor(n)
                                         for n in inp["noise"]])
            res["info"] = info
    res["losses"] = losses
    res["state"] = dict(params=_np(st.params), active=_np(st.active),
                        mu=_np(opt.mu), nu=_np(opt.nu))

    mesh2 = make_mesh(WORLD, ("gauss", "tile"), shape=(2, 2),
                      device_type="cpu")
    st2 = shard_scene(interleave_shards(full, 2), mesh2)
    opt2 = shard_scene(interleave_shards(adam_init(full.params), 2), mesh2)
    step2 = gauss_tile_train_step(mesh2, intr, rcfg, lr=inp["lr"])
    losses = []
    for s in range(inp["gt_steps"]):
        params, opt2, loss = step2(st2.params, st2.active, opt2, c2w, bg)
        st2 = dataclasses.replace(st2, params=params)
        losses.append(float(loss))
    res["gt_losses"] = losses
    res["gt_params"] = _np(st2.params)
    _save(folder, rank, res)
