"""The solver set-up's native loops on threads (padne_tpu_torch.native):
the Galerkin product, the DIA packing (CSR and COO), the symmetric
permutation and the strength filter give the bits of their serial run
at any thread count, and those of the JAX package's serial native
twins; a whole DIA hierarchy above the native cut equals the JAX
package's."""

import numpy as np
import pytest

from padne_tpu import native as jnative
from padne_tpu.ops import amg as jamg
from padne_tpu.ops import bell as jbell
from padne_tpu_torch import native
from padne_tpu_torch.ops import amg

from tests.test_amg_dia import grid_laplacian

THREADS = (1, 2, 7)


@pytest.fixture(scope="module")
def system():
    """A 90,000-row grid Laplacian (above the threads' row cut) in
    Hilbert order, its capped aggregation and its damping weights."""
    ell, coords = grid_laplacian(300)
    perm = jbell.hilbert_order(coords)
    a = jnative.csr_permute(ell.to_scipy().tocsr(), perm)
    assert a.shape[0] >= native.MIN_PARALLEL_ROWS and a.nnz >= 200_000
    agg, nc = jamg._aggregate_capped(a, 8)
    d = np.asarray(a.diagonal())
    dinv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    return a, agg, nc, dinv


def assert_csr_equal(got, want):
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.shape == want.shape


@pytest.mark.parametrize("omega_p, drop_tol",
                         [(0.0, 0.0), (0.0, 1e-4), (0.6, 0.0), (0.6, 1e-4),
                          (0.6, 3e-2)])
def test_galerkin(system, omega_p, drop_tol):
    a, agg, nc, dinv = system
    want = jnative.galerkin(a, agg, nc, dinv, omega_p, drop_tol)
    for t in THREADS:
        assert_csr_equal(
            native.galerkin(a, agg, nc, dinv, omega_p, drop_tol, threads=t),
            want)


@pytest.mark.parametrize("layout", ["aggregates", "scattered"])
def test_pack_dia_csr(system, layout):
    """Padded positions as the hierarchy lays them out (most entries on
    the offsets), and scattered ones (a large remainder to sort)."""
    a, agg, nc, _ = system
    n = a.shape[0]
    if layout == "aggregates":
        order = np.argsort(agg, kind="stable")
        starts = np.concatenate([[0], np.cumsum(np.bincount(agg))])
        slot = np.empty(n, dtype=np.int64)
        slot[order] = np.arange(n) - starts[agg[order]]
        pos = agg * 8 + slot
    else:
        pos = np.random.default_rng(3).permutation(2 * n)[:n]
    want = jnative.pack_dia_csr(a, pos, 128, 0.95, 4)
    for t in THREADS:
        got = native.pack_dia_csr(a, pos, 128, 0.95, 4, threads=t)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("preset", [False, True])
def test_pack_dia_coo(system, preset):
    a, _, _, _ = system
    coo = a.tocoo()
    off = coo.row != coo.col
    rows, cols, vals = coo.row[off], coo.col[off], coo.data[off]
    offs = (-3, -1, 0, 1, 3) if preset else None
    want = jnative.pack_dia(128, rows, cols, vals, 0.95, 8, offs=offs)
    for t in THREADS:
        got = native.pack_dia(128, rows, cols, vals, 0.95, 8, offs=offs,
                              threads=t)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)


def test_csr_permute(system):
    a, _, _, _ = system
    perm = np.random.default_rng(1).permutation(a.shape[0])
    want = jnative.csr_permute(a, perm)
    for t in THREADS:
        assert_csr_equal(native.csr_permute(a, perm, threads=t), want)


@pytest.mark.parametrize("theta", [0.0, 0.08, 0.3])
def test_strength_pattern(system, theta):
    a, _, _, _ = system
    want = jamg._strength_pattern(a, theta)
    for t in THREADS:
        got = amg._strength_pattern(a, theta, threads=t)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_more_threads_than_cores(system):
    """Four times the usable CPUs: the same bits."""
    a, agg, nc, dinv = system
    t = 4 * native.usable_cpus()
    assert_csr_equal(native.galerkin(a, agg, nc, dinv, 0.6, 1e-4, threads=t),
                     jnative.galerkin(a, agg, nc, dinv, 0.6, 1e-4))
    perm = np.random.default_rng(1).permutation(a.shape[0])
    assert_csr_equal(native.csr_permute(a, perm, threads=t),
                     jnative.csr_permute(a, perm))


def test_threads_come_from_the_size():
    """Below the row cut a loop runs serially; from it on every usable
    CPU; a test may force a count."""
    cpus = native.usable_cpus()
    assert cpus >= 1
    assert native.threads_for(native.MIN_PARALLEL_ROWS - 1) == 1
    assert native.threads_for(native.MIN_PARALLEL_ROWS) == cpus
    assert native.threads_for(10, threads=3) == 3
    assert native.threads_for(10**6, threads=0) == 1


def test_hierarchy_equal_above_the_native_cut(system):
    """The whole DIA build on the native, threaded routes against the
    JAX package's."""
    ell, coords = grid_laplacian(300)
    kw = dict(coarse_size=400, max_offsets=4)
    jh = jamg.build_hierarchy_dia(ell, coords, **kw)
    th = amg.build_hierarchy_dia(ell, coords, **kw)
    assert th.setup_threads == native.threads_for(len(ell.diag))
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
