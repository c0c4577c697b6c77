"""The coarse-to-fine curriculum against the JAX package: the camera
sampler across resolution and focal milestones, and the trainer's
duplicate bucket across resolution switches.

At a feedback step within ``reso_prewarm_lead`` of a milestone, the JAX
trainer predicts the bucket the next resolution needs and compiles it
ahead; at the switch it jumps onto the smallest bucket it holds for the
new intrinsics (gsgen_tpu/training/trainer.py:527-539, :573-589).  The
port keeps that policy as bookkeeping.  Both trainers start from the
same state (``test_torch_trainer._pair``); the JAX side renders with its
pure-XLA scan, its own choice on the CPU.  ``dup_bucket`` and
``n_dup_max`` must be equal at every step, the losses within rtol 1e-4,
and the final state within ``test_trajectory_matches_jax_trainer``'s
tolerances.
"""

import numpy as np
import pytest

from gsgen_tpu.data.cameras import CameraPoseProvider as ProviderJ
from gsgen_tpu.data.cameras import CameraSamplerConfig as CamJ
from gsgen_torch.data.cameras import CameraPoseProvider, CameraSamplerConfig
from test_torch_trainer import _pair, check_states_match, check_step_metrics

# dup_cap, resolutions, milestones, steps.  At 256 the bucket jumps at both
# switches, the second onto the bucket that the feedback at step 10 (24^2)
# predicted for 48^2; at 1024 it jumps once; at 4096 nothing jumps.  The
# slowest case comes first.
TRAJECTORIES = [
    pytest.param(256, (16, 24, 48), (2, 12), 13, id="cap256-two-switches"),
    pytest.param(1024, (16, 48), (2,), 4, id="cap1024"),
    pytest.param(4096, (16, 48), (2,), 4, id="cap4096-no-jump"),
]


@pytest.mark.parametrize("dup_cap,reso,milestones,steps", TRAJECTORIES)
def test_bucket_across_switches_matches_jax_trainer(dup_cap, reso,
                                                     milestones, steps):
    tj, tt = _pair(backend="xla", dup_cap=dup_cap, dup_bucket_min=256,
                   auto_dup_bucket=True,
                   data=dict(reso=reso, reso_milestones=milestones))
    buckets = []
    try:
        for s in range(steps):
            m_j = tj.train_step(s)
            m_t = tt.train_step(s)
            buckets.append(tt.dup_bucket)
            assert tt.dup_bucket == tj.dup_bucket, (s, buckets)
            check_step_metrics(m_t, m_j, s)
        check_states_match(tj, tt, steps)
    finally:
        # the JAX trainer's compile-ahead threads: a process that exits
        # while they run aborts
        for t in list(tj._prewarm_threads.values()):
            t.join()
    assert tt.data.reso == reso[-1]
    jumped = [buckets[m] > buckets[m - 1] for m in milestones]
    assert jumped == [dup_cap < 4096] * len(milestones), buckets


def test_bucket_growth_and_shrink_match_jax_trainer():
    """The growth and shrink rules on one run of feedback readings.  The
    JAX trainer is given no intrinsics, so it shrinks at a streak of 20
    without waiting for a compile, as the port always does; the port
    records the half bucket from a streak of 10, where the JAX trainer
    compiles it ahead."""
    tj, tt = _pair(backend="xla", dup_cap=4096, dup_bucket_min=1024)
    intr = tt.data.intrinsics()
    readings = [3700] + [10] * 20 + [10] * 10 + [2000] + [10] * 25
    for i, n in enumerate(readings):
        tj._adjust_dup_bucket(n)
        tt._adjust_dup_bucket(n, intr)
        assert tt.dup_bucket == tj.dup_bucket, (i, n)
    assert tt.dup_bucket == 2048
    assert {(intr, 4096), (intr, 2048)} <= tt._bucket_keys


def test_pose_provider_across_milestones_matches_jax():
    """Both samplers over steps that cross two resolution milestones and a
    focal one: the same intrinsics, next switch and batches."""
    kw = dict(batch_size=3, max_steps=20, reso=(16, 32, 48),
              reso_milestones=(4, 9), focal=((0.7, 1.35), (0.9, 1.1)),
              focal_milestones=(6,), azimuth_warmup=0.3,
              elevation_warmup=0.3, center_aug_std=0.05)
    pj = ProviderJ(CamJ(**kw), seed=5)
    pt = CameraPoseProvider(CameraSamplerConfig(**kw), seed=5)
    seen = set()
    for step in range(12):
        pj.update(step)
        pt.update(step)
        assert pt.reso == pj.reso
        assert pt.next_reso_change(step) == pj.next_reso_change(step)
        it, ij = pt.intrinsics(), pj.intrinsics()
        assert (it.fx, it.fy, it.cx, it.cy, it.w, it.h, it.near, it.far) \
            == (ij.fx, ij.fy, ij.cx, ij.cy, ij.w, ij.h, ij.near, ij.far)
        nxt = pt.next_reso_change(step)
        if nxt is not None:
            a, b = pt.intrinsics(reso=nxt[1]), pj.intrinsics(reso=nxt[1])
            assert (a.fx, a.w) == (b.fx, b.w)
        seen.add((it.w, it.fx))
        bt, bj = pt.get_batch(), pj.get_batch()
        assert sorted(bt) == sorted(bj)
        for k in bj:
            np.testing.assert_allclose(np.asarray(bt[k]), np.asarray(bj[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    # 16^2, 32^2 before and after the focal switch, 48^2
    assert len(seen) == 4, seen
    assert pt.next_reso_change(11) is None
