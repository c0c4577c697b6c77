"""The multichip dry run: every parallel layout on ``n`` ranks.

Port of the JAX package's ``__graft_entry__.py::dryrun_multichip``.
:func:`dryrun_multichip` starts ``n`` ranks (:func:`.mesh.spawn_ranks`:
start method ``spawn``, a ``FileStore`` in a temporary directory; NCCL on
``cuda``, one card a rank, gloo on ``cpu``) and runs, on tiny shapes:

1. the data-parallel trainer step (the batch's views split over ``data``,
   the gradients all-reduced), its loss against the one-process step's;
2. the tile-sharded render forward and backward, its gradients against
   the one-process render's;
3. a trainer step with ``tile_mesh``;
4. the 2-D data x tile batch render, forward and backward;
5. the Gaussian-sharded render forward and backward (gradients
   reduce-scattered: each rank's against its rows of the one-process
   gradients) and its train step (Adam moments sharded);
6. the gauss x tile render, forward and backward;
7. multi-step runs: 8 Gaussian-sharded steps with a shard-local densify
   event, a prune event and a duplicate-bucket growth, then 4 gauss x tile
   steps with a densify event.

Rank 0 prints one ``dryrun_multichip ok (...)`` line a phase; a failed
check raises in its rank and so in :func:`dryrun_multichip`.  The
trainers use mock guidance on a fixed background (the JAX dry run draws a
random one), so that the data-parallel step can be held to the
one-process step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.cameras import CameraSamplerConfig
from ..guidance.mock import MockGuidance
from ..models.background import BackgroundConfig
from ..models.density import DensifyConfig, PruneConfig
from ..models.init import InitConfig, initialize
from ..models.scene import RenderConfig, render_view
from ..ops.camera import CameraIntrinsics
from ..training.optimizer import adam_init
from ..training.trainer import Trainer, TrainerConfig
from .collectives import all_reduce
from .gaussian_sharded import (gauss_tile_train_step,
                               gaussian_sharded_grad_step,
                               gaussian_sharded_train_step,
                               interleave_shards,
                               render_view_gauss_tile_sharded,
                               render_view_gaussian_sharded, shard_scene,
                               sharded_density_step)
from .mesh import axis_group, axis_rank, make_mesh, shard_rows, spawn_ranks
from .sharded_render import (render_batch_data_tile_sharded,
                             render_view_tile_sharded)

C2W = [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, -2.5]]
TS = 8
RCFG = RenderConfig(dup_cap=8192, chunk=64, tile_size=TS, backend="xla")


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """Run every phase (module docstring) on ``n_devices`` ranks."""
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need as many cards; "
                           f"{torch.cuda.device_count()} found")
    spawn_ranks(_dryrun_rank, n_devices, n_devices, device_type,
                device_type=device_type)


def _make_trainer(dev, n_points=256, capacity=512, reso=32, batch_size=2,
                  rcfg=RenderConfig(dup_cap=16384, chunk=128), **mesh):
    return Trainer(
        cfg=TrainerConfig(max_steps=100, batch_size=batch_size,
                          auto_dup_bucket=False),
        rcfg=rcfg,
        init_cfg=InitConfig(num_points=n_points, capacity=capacity,
                            svec_val=0.05, mean_std=0.4),
        bg_cfg=BackgroundConfig(type="fixed"),
        data_cfg=CameraSamplerConfig(batch_size=batch_size, max_steps=100,
                                     reso=(reso,),
                                     camera_distance=(2.0, 2.5)),
        guidance=MockGuidance(mode="constant_color"),
        dcfg=DensifyConfig(enabled=False), pcfg=PruneConfig(enabled=False),
        device=dev, **mesh)


def _grads(loss_fn, params):
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(p)
    return loss.detach(), dict(zip(p, torch.autograd.grad(loss,
                                                           list(p.values()))))


def _close(got, want, rtol, atol, what):
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max())
        raise AssertionError(f"{what}: max abs error {err:.3e}")


def _dryrun_rank(rank: int, n: int, device_type: str) -> None:
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    say = print if rank == 0 else (lambda *a, **k: None)
    c2w = torch.tensor(C2W, device=dev)
    white = torch.ones(3, device=dev)

    def scene(seed, **kw):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return initialize(InitConfig(svec_val=0.05, mean_std=0.4, **kw),
                          RCFG, gen, dev)

    # 1: data-parallel trainer step against the one-process step
    mesh = make_mesh(n, ("data",), device_type=device_type)
    m = _make_trainer(dev, batch_size=n, data_mesh=mesh).train_step(0)
    m_ref = _make_trainer(dev, batch_size=n).train_step(0)
    _close(m["loss_total"], m_ref["loss_total"], 1e-4, 0.0, "dp loss")
    say("dryrun_multichip ok (dp train step):", n, "devices; loss =",
        float(m["loss_total"]), flush=True)

    # 2: tile-sharded render forward + backward against one process
    tmesh = make_mesh(n, ("tile",), device_type=device_type)
    intr2 = CameraIntrinsics.from_reso(TS * n * 2)
    st = scene(0, num_points=128)

    def loss_tile(p):
        out = render_view_tile_sharded(p, st.active, c2w, intr2, RCFG, white,
                                       tmesh, rgb_only=True)
        return torch.mean(out["rgb"] ** 2)

    def loss_one(p):
        out = render_view(p, st.active, c2w, intr2, RCFG, white,
                          rgb_only=True)
        return torch.mean(out["rgb"] ** 2)

    _, g = _grads(loss_tile, st.params)
    _, g_ref = _grads(loss_one, st.params)
    for k in g:
        _close(g[k], g_ref[k], 5e-3, 1e-5, f"tile-sharded grad {k}")
    say("dryrun_multichip ok (tile-sharded fwd+bwd, grads match one "
        "process):", n, "devices; |grad mean| =",
        float(g["mean"].abs().sum()), flush=True)

    # 3: a trainer step with per-view tile-sharded rendering
    tr = _make_trainer(dev, n_points=64, capacity=64, reso=intr2.w,
                       rcfg=RCFG, tile_mesh=tmesh)
    m = tr.train_step(0)
    say("dryrun_multichip ok (tile-sharded train step):", n,
        "devices; loss =", float(m["loss_total"]), flush=True)

    # 4: data x tile: views over data, tile rows over tile
    d_data = 2 if n % 2 == 0 and n > 1 else 1
    mesh2d = make_mesh(n, ("data", "tile"), shape=(d_data, n // d_data),
                       device_type=device_type)
    intr3 = CameraIntrinsics.from_reso(TS * (n // d_data))
    B = 2 * d_data
    c2ws = c2w.expand(B, 3, 4)
    bgs = torch.ones(B, 3, device=dev)
    _, g2 = _grads(lambda p: torch.mean(render_batch_data_tile_sharded(
        p, st.active, c2ws, intr3, RCFG, bgs, mesh2d) ** 2), st.params)
    say("dryrun_multichip ok (2-D data x tile mesh fwd+bwd):",
        (d_data, n // d_data), "; |grad mean| =",
        float(g2["mean"].abs().sum()), flush=True)

    # 5: Gaussian-sharded render (grads reduce-scattered) and train step
    gmesh = make_mesh(n, ("gauss",), device_type=device_type)
    g_rank = axis_rank(gmesh, "gauss")
    intr_g = CameraIntrinsics.from_reso(TS * n)
    st_g = scene(1, num_points=16 * n, capacity=32 * n)
    st_sh = shard_scene(st_g, gmesh)
    lg, gg = gaussian_sharded_grad_step(
        lambda p, a: torch.mean(render_view_gaussian_sharded(
            p, a, c2w, intr_g, RCFG, white, gmesh, rgb_only=True)["rgb"]
            ** 2))(st_sh.params, st_sh.active)
    _, gg_ref = _grads(lambda p: torch.mean(render_view(
        p, st_g.active, c2w, intr_g, RCFG, white, rgb_only=True)["rgb"] ** 2),
        st_g.params)
    for k in gg:
        _close(gg[k], shard_rows(gg_ref[k], n, g_rank), 1e-5, 1e-7,
               f"gaussian-sharded grad {k}")
    say("dryrun_multichip ok (gaussian-sharded fwd+bwd, grads "
        "reduce-scattered):", n, "devices; loss =", float(lg), flush=True)
    opt_sh = adam_init(st_sh.params)
    p2, o2, l2 = gaussian_sharded_train_step(gmesh, intr_g, RCFG)(
        st_sh.params, st_sh.active, opt_sh, c2w, white)
    ns = st_sh.active.shape[0]
    if o2.mu["mean"].shape[0] != ns or p2["mean"].shape[0] != ns:
        raise AssertionError("Adam moments or params left their shard")
    say("dryrun_multichip ok (gaussian-sharded train step, Adam moments "
        "sharded):", n, "devices; loss =", float(l2), flush=True)

    # 6: gauss x tile
    d_g = 2 if n % 2 == 0 and n > 1 else 1
    mesh_gt = make_mesh(n, ("gauss", "tile"), shape=(d_g, n // d_g),
                        device_type=device_type)
    st_gt = shard_scene(st_g, mesh_gt)
    _, g_gt = _grads(lambda p: torch.mean(render_view_gauss_tile_sharded(
        p, st_gt.active, c2w, intr_g, RCFG, white, mesh_gt)["rgb"] ** 2),
        st_gt.params)
    say("dryrun_multichip ok (gauss x tile 2-D mesh fwd+bwd):",
        (d_g, n // d_g), "; |grad mean| =", float(g_gt["mean"].abs().sum()),
        flush=True)

    # 7: resharding events: densify, prune, a duplicate-bucket growth
    dcfg = DensifyConfig(enabled=True, mean2d_thresh=1e-4, split_thresh=1e9,
                         use_legacy=False)
    pcfg = PruneConfig(enabled=True, alpha_thresh=0.05, radii2d_thresh=0.0)
    off = DensifyConfig(enabled=False)
    st8 = shard_scene(interleave_shards(st_g, n), gmesh)
    opt8 = shard_scene(interleave_shards(adam_init(st_g.params), n), gmesh)
    rcfg_now = RCFG
    sfn = gaussian_sharded_train_step(gmesh, intr_g, rcfg_now)
    n0 = int(st_g.active.sum())
    for s in range(8):
        p8, opt8, l8 = sfn(st8.params, st8.active, opt8, c2w, white)
        st8 = dataclasses.replace(st8, params=p8)
        if not torch.isfinite(l8):
            raise AssertionError(f"gaussian-sharded step {s}: loss {l8}")
        if s == 2:
            st8 = _hot(st8)
            st8, opt8, di = sharded_density_step(
                gmesh, dcfg, PruneConfig(enabled=False), rcfg_now)(
                st8, opt8, 0.0, 0.0)
            if di["num_clone"] <= 0:
                raise AssertionError(f"densify event cloned nothing: {di}")
        if s == 4:
            st8, opt8, _ = sharded_density_step(gmesh, off, pcfg, rcfg_now)(
                st8, opt8, 0.0, pcfg.alpha_thresh)
        if s == 5:
            rcfg_now = dataclasses.replace(rcfg_now,
                                           dup_cap=rcfg_now.dup_cap * 2)
            sfn = gaussian_sharded_train_step(gmesh, intr_g, rcfg_now)
    n1 = int(all_reduce(st8.active.sum().reshape(1),
                        axis_group(gmesh, "gauss")))
    if n1 <= n0:
        raise AssertionError(f"live Gaussians {n0} -> {n1}")
    say("dryrun_multichip ok (gaussian-sharded densify/prune/bucket-growth "
        "events):", n, "devices;", n0, "->", n1, "gaussians", flush=True)

    stgt = shard_scene(interleave_shards(st_g, d_g), mesh_gt)
    optgt = shard_scene(interleave_shards(adam_init(st_g.params), d_g),
                        mesh_gt)
    tfn = gauss_tile_train_step(mesh_gt, intr_g, RCFG)
    for s in range(4):
        pgt, optgt, lgt = tfn(stgt.params, stgt.active, optgt, c2w, white)
        stgt = dataclasses.replace(stgt, params=pgt)
        if not torch.isfinite(lgt):
            raise AssertionError(f"gauss x tile step {s}: loss {lgt}")
        if s == 1:
            stgt, optgt, di2 = sharded_density_step(
                mesh_gt, dcfg, PruneConfig(enabled=False), RCFG)(
                _hot(stgt), optgt, 0.0, 0.0)
            if di2["num_clone"] <= 0:
                raise AssertionError(f"densify event cloned nothing: {di2}")
    say("dryrun_multichip ok (gauss x tile densify event):", (d_g, n // d_g),
        flush=True)


def _hot(state):
    """Densify statistics that make every live Gaussian a candidate."""
    return dataclasses.replace(
        state, grad_accum=torch.full_like(state.grad_accum, 10.0),
        grad_cnt=torch.ones_like(state.grad_cnt))
