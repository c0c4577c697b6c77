"""gsgen_torch binning vs the JAX package: the plain versions of kernels
K3 (expansion rank) and K4 (gid repack) against ``expansion_gid`` /
``repack_gid`` (which run their Pallas kernels in interpret mode on the
CPU), and every ``BinnedTiles`` field of ``bin_gaussians`` — all exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.ops.binning import bin_gaussians as bin_jax
from gsgen_tpu.ops.expansion_rank import expansion_gid as gid_jax
from gsgen_tpu.ops.gid_repack import repack_gid as repack_jax
from gsgen_torch.ops import binning
from gsgen_torch.ops.expansion_rank import expansion_gid, expansion_gid_plain
from gsgen_torch.ops.gid_repack import repack_gid_plain
from torch_fixtures import CHUNK, FX, RES, TILE, scene2d, t


@pytest.mark.parametrize("cap", [4096, 6144])
@pytest.mark.parametrize("zeros", [0.0, 0.7])
def test_expansion_rank_plain_matches_jax(cap, zeros):
    """cap a multiple of 2048: the JAX side runs its rank kernel (with
    its scatter fallback for crowded windows); cum overshoots cap."""
    rng = np.random.default_rng(int(cap + 10 * zeros))
    counts = rng.integers(0, 30, 1600).astype(np.int32)
    counts[rng.random(1600) < zeros] = 0
    cum = np.cumsum(counts).astype(np.int32)
    assert cum[-1] > cap                     # mode="drop" is exercised
    want = np.asarray(gid_jax(jnp.asarray(cum), cap))
    got = expansion_gid(t(cum), cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(expansion_gid_plain(t(cum), cap).numpy(),
                                  want)


def _bin_inputs(n, seed, spread=0.6, cov_scale=0.02, degenerate=0):
    mean2d, cov2d, alpha, _, depth = scene2d(n, seed, spread=spread,
                                             cov_scale=cov_scale)
    if degenerate:
        # rank-one covariances: the conic guard yields huge, saturating
        # pixel bounds in tile_aabbs' float->int32 casts
        rng = np.random.default_rng(seed + 100)
        v = rng.standard_normal((degenerate, 2)).astype(np.float32) * 0.05
        cov2d[:degenerate] = v[:, :, None] * v[:, None, :]
    depth[::17] = depth[0]                   # depth ties keep index order
    active = np.arange(n) % 11 != 5
    return mean2d, cov2d, depth, active, alpha


CASES = {
    "generic": dict(n=120, seed=0, cap=4096, radius=6.0, alpha=True),
    "wide": dict(n=60, seed=1, cap=4096, radius=60.0, alpha=False),
    "overflow": dict(n=300, seed=2, cap=256, radius=6.0, alpha=True),
    "pad_overflow": dict(n=600, seed=3, cap=2048, radius=6.0, alpha=True,
                         pad_budget=2 * CHUNK),
    "degenerate": dict(n=80, seed=4, cap=4096, radius=6.0, alpha=True,
                       degenerate=12),
    "offscreen": dict(n=150, seed=5, cap=4096, radius=6.0, alpha=False,
                      spread=1.6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_gaussians_fields_exact(case):
    c = dict(CASES[case])
    mean2d, cov2d, depth, active, alpha = _bin_inputs(
        c["n"], c["seed"], spread=c.get("spread", 0.6),
        degenerate=c.get("degenerate", 0))
    args = (mean2d, cov2d, depth, active, FX, FX, RES / 2.0, RES / 2.0,
            RES, RES, TILE, c["cap"])
    kw = dict(chunk=CHUNK, tile_culling_radius=c["radius"],
              pad_budget=c.get("pad_budget"))
    bj = bin_jax(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x
                   for x in args],
                 alpha=jnp.asarray(alpha) if c["alpha"] else None, **kw)
    bt = binning.bin_gaussians(*[t(x) if isinstance(x, np.ndarray) else x
                                 for x in args],
                               alpha=t(alpha) if c["alpha"] else None, **kw)
    for f in bt._fields:
        if getattr(bt, f) is None:          # the compact layout's gid_s
            assert getattr(bj, f) is None, f
            continue
        a, b = np.asarray(getattr(bj, f)), getattr(bt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    if case == "overflow":
        assert int(bt.total) > c["cap"]
    if case == "pad_overflow":
        assert int(bt.padded_total) > bt.padded_gid.shape[0]


def test_repack_plain_matches_jax_on_binning_inputs(monkeypatch):
    """K4's plain version on the very inputs the binner hands it."""
    seen = {}

    def record(*args):
        seen["args"] = args
        return repack_gid_plain(*args)

    monkeypatch.setattr(binning, "repack_gid", record)
    mean2d, cov2d, depth, active, alpha = _bin_inputs(200, 8)
    binning.bin_gaussians(t(mean2d), t(cov2d), t(depth), t(active), FX, FX,
                          RES / 2.0, RES / 2.0, RES, RES, TILE, 4096,
                          chunk=CHUNK, alpha=t(alpha))
    gid_s, chunk_tile, offset_t, ends, cap_padded, K, sentinel = seen["args"]
    want = repack_jax(*(jnp.asarray(x.numpy()) for x in
                        (gid_s, chunk_tile, offset_t, ends)),
                      cap_padded, K, sentinel)
    got = repack_gid_plain(gid_s, chunk_tile, offset_t, ends, cap_padded, K,
                           sentinel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == sentinel).any() and (got < sentinel).any()


def test_float_to_int32_saturates_like_xla():
    x = np.array([0.0, -0.7, 2.9, 3e9, -3e9, np.inf, -np.inf, np.nan,
                  2147483520.0, -2147483648.0], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(binning._f32_to_i32(t(x)).numpy(), want)
