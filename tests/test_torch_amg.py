"""Port parity for ops.amg: the aligned DIA hierarchy (host, bit-equal)
and one application of the transposed V/W-cycle (f32, within 1e-4 of
max|z| — f32 summation order differs between the two packages, and the
cycle compounds a few dozen level operations)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padne_tpu.ops import amg as jamg
from padne_tpu_torch.ops import amg

from tests.test_amg_dia import grid_laplacian
from tests.test_dia_sharded import grid_system

torch.set_num_threads(1)


def _hierarchies(ell, coords, **kw):
    return (jamg.build_hierarchy_dia(ell, coords, **kw),
            amg.build_hierarchy_dia(ell, coords, **kw))


@pytest.mark.parametrize("case", ["laplacian", "grid_far"])
def test_hierarchy_equal(case):
    ell, coords = (grid_laplacian(64) if case == "laplacian"
                   else grid_system(80, 80, n_far=30))
    jh, th = _hierarchies(ell, coords, coarse_size=100, max_offsets=4)
    assert len(th.levels) == len(jh.levels) >= 2
    np.testing.assert_array_equal(th.posmap0, jh.posmap0)
    assert th.np0 == jh.np0
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.pack.meta == jl.pack.meta
        for name in ("widx_hi", "widx_lo", "wval", "rem_rows", "rem_cols",
                     "rem_vals", "diag"):
            np.testing.assert_array_equal(getattr(tl.pack, name),
                                          getattr(jl.pack, name))
        np.testing.assert_array_equal(tl.dinv, jl.dinv)
        np.testing.assert_array_equal(tl.child_perm, jl.child_perm)
        assert (tl.omega_p, tl.omega_s, tl.cap, tl.child_len, tl.lam) == (
            jl.omega_p, jl.omega_s, jl.cap, jl.child_len, jl.lam)
    np.testing.assert_array_equal(th.coarse_inv, jh.coarse_inv)


@pytest.mark.parametrize("w_levels", [0, 3])
def test_vcycle_matches_jax(w_levels, monkeypatch):
    monkeypatch.setenv("PADNE_TPU_WCYCLE", str(w_levels))
    ell, coords = grid_laplacian(64, seed=1)
    jh, th = _hierarchies(ell, coords, coarse_size=64, max_offsets=4)
    assert len(th.levels) >= 3   # the W-cycle doubles levels 2..3

    jop = jamg.make_dia_cg_operator(jh, slots=8)
    japply, jparams = jamg.make_vcycle_dia_t(jh, backend="xla",
                                             w0=jop["w"])
    op = amg.make_dia_cg_operator(th, "cpu", slots=8)
    apply_t, params = amg.make_vcycle_dia_t(th, "cpu", w0=op["w"],
                                            w_levels=w_levels)

    rng = np.random.default_rng(5)
    rt = rng.standard_normal((3, th.np0)).astype(np.float32)
    z_ref = np.asarray(japply(jparams, jnp.asarray(rt)))
    z = apply_t(params, torch.from_numpy(rt)).numpy()
    assert np.abs(z - z_ref).max() <= 1e-4 * np.abs(z_ref).max()
