"""gsgen_torch geometry vs the JAX package: activations, transforms,
camera, projection — values and gradients.

Tolerances: rtol 1e-5 / atol 1e-6 for values (fp32 elementwise math with
different library exp/log/sqrt); gradients rtol 1e-4 / atol 1e-6 (the
chain rule reorders a few products).  The frustum masks must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.ops import camera as cam_j
from gsgen_tpu.ops import projection as proj_j
from gsgen_tpu.ops import transforms as tf_j
from gsgen_tpu.utils import activations as act_j
from gsgen_torch.ops import camera as cam_t
from gsgen_torch.ops import projection as proj_t
from gsgen_torch.ops import transforms as tf_t
from gsgen_torch.utils import activations as act_t
from torch_fixtures import t

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _c2w(seed=0):
    """A look-at camera 2.5 from the origin (numpy, like the sampler)."""
    from gsgen_torch.data.cameras import c2w_from_up_and_look_at
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal(3)
    pos = 2.5 * pos / np.linalg.norm(pos)
    return c2w_from_up_and_look_at(np.array([0.0, 0.0, 1.0]),
                                   np.zeros(3), pos)


@pytest.mark.parametrize("name", sorted(act_t.ACTIVATIONS))
def test_activations_and_inverses(name):
    rng = np.random.default_rng(1)
    x = rng.uniform(-3, 3, 64).astype(np.float32)
    np.testing.assert_allclose(act_t.act(name)(t(x)).numpy(),
                               np.asarray(act_j.act(name)(jnp.asarray(x))),
                               **VAL)
    y = rng.uniform(0.01, 0.99, 64).astype(np.float32)
    np.testing.assert_allclose(
        act_t.inv_act(name)(t(y)).numpy(),
        np.asarray(act_j.inv_act(name)(jnp.asarray(y))), rtol=1e-5,
        atol=1e-5)


def test_transforms_values_and_grads():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((32, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.2, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(tf_t.quat_to_rotmat(t(q)).numpy(),
                               np.asarray(tf_j.quat_to_rotmat(q)), **VAL)
    cov_j = tf_j.quat_scale_to_cov3d(jnp.asarray(q), jnp.asarray(s))
    qt, st = t(q).requires_grad_(True), t(s).requires_grad_(True)
    cov_t = tf_t.quat_scale_to_cov3d(qt, st)
    np.testing.assert_allclose(cov_t.detach().numpy(), np.asarray(cov_j),
                               **VAL)
    w = rng.standard_normal((32, 3, 3)).astype(np.float32)
    gq, gs = jax.grad(lambda a, b: jnp.sum(tf_j.quat_scale_to_cov3d(a, b)
                                           * w), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(s))
    (cov_t * t(w)).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq), **GRAD)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), **GRAD)


def test_camera_intrinsics_and_frustum():
    for reso in (32, 512):
        a, b = cam_t.CameraIntrinsics.from_reso(reso), \
            cam_j.CameraIntrinsics.from_reso(reso)
        for f in ("fx", "fy", "cx", "cy", "w", "h", "near", "far", "yfov",
                  "aspect", "pixel_size", "image_topleft"):
            assert getattr(a, f) == getattr(b, f), f
        assert hash(a) == hash(cam_t.CameraIntrinsics.from_reso(reso))
    intr_t = cam_t.CameraIntrinsics(fx=40.0, fy=40.0, cx=16.0, cy=16.0,
                                    w=32, h=32, near=0.01, far=100.0)
    intr_j = cam_j.CameraIntrinsics(fx=40.0, fy=40.0, cx=16.0, cy=16.0,
                                    w=32, h=32, near=0.01, far=100.0)
    c2w = _c2w(3)
    n_t, p_t = cam_t.get_frustum(t(c2w), intr_t)
    n_j, p_j = cam_j.get_frustum(jnp.asarray(c2w), intr_j)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **VAL)
    rng = np.random.default_rng(4)
    pts = (rng.standard_normal((500, 3)) * 1.5).astype(np.float32)
    radii = rng.uniform(0.0, 0.3, 500).astype(np.float32)
    m_t = cam_t.sphere_in_frustum(t(pts), t(radii), n_t, p_t)
    m_j = cam_j.sphere_in_frustum(jnp.asarray(pts), jnp.asarray(radii),
                                  n_j, p_j)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < int(m_t.sum()) < 500


@pytest.mark.parametrize("detach_depth", [True, False])
def test_project_gaussians_values_and_grads(detach_depth):
    rng = np.random.default_rng(5)
    n = 64
    mean = (rng.standard_normal((n, 3)) * 0.5).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32)
    c2w = _c2w(6)
    pj = proj_j.project_gaussians(jnp.asarray(mean), jnp.asarray(q),
                                  jnp.asarray(s), jnp.asarray(c2w),
                                  detach_depth=detach_depth)
    args = [t(x).requires_grad_(True) for x in (mean, q, s)]
    pt = proj_t.project_gaussians(*args, t(c2w), detach_depth=detach_depth)
    for f in ("mean2d", "cov2d", "depth"):
        np.testing.assert_allclose(getattr(pt, f).detach().numpy(),
                                   np.asarray(getattr(pj, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(pt.in_front.numpy(),
                                  np.asarray(pj.in_front))
    w1 = rng.standard_normal((n, 2)).astype(np.float32)
    w2 = rng.standard_normal((n, 2, 2)).astype(np.float32)
    w3 = rng.standard_normal(n).astype(np.float32)

    def loss_j(m, qq, ss):
        p = proj_j.project_gaussians(m, qq, ss, jnp.asarray(c2w),
                                     detach_depth=detach_depth)
        conic, _ = proj_j.conic_from_cov2d(p.cov2d)
        return (jnp.sum(p.mean2d * w1) + jnp.sum(p.cov2d * w2) * 100.0
                + jnp.sum(p.depth * w3) + 1e-4 * jnp.sum(conic)
                + jnp.sum(proj_j.screen_radii(p.cov2d)))

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(mean), jnp.asarray(q), jnp.asarray(s))
    conic_t, _ = proj_t.conic_from_cov2d(pt.cov2d)
    loss = ((pt.mean2d * t(w1)).sum() + (pt.cov2d * t(w2)).sum() * 100.0
            + (pt.depth * t(w3)).sum() + 1e-4 * conic_t.sum()
            + proj_t.screen_radii(pt.cov2d).sum())
    loss.backward()
    for name, a, b in zip(("mean", "qvec", "svec"), args, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_conic_guard_and_screen_radii():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((100, 2, 2)).astype(np.float32) * 0.01
    cov = A @ np.swapaxes(A, 1, 2)
    # near-degenerate: rank-one covariances where the relative guard acts
    v = rng.standard_normal((20, 2)).astype(np.float32) * 1e-3
    cov[:20] = v[:, :, None] * v[:, None, :]
    cov = cov.astype(np.float32)
    c_t, d_t = proj_t.conic_from_cov2d(t(cov))
    c_j, d_j = proj_j.conic_from_cov2d(jnp.asarray(cov))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **VAL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **VAL)
    np.testing.assert_allclose(proj_t.screen_radii(t(cov)).numpy(),
                               np.asarray(proj_j.screen_radii(cov)), **VAL)
