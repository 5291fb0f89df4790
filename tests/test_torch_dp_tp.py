"""Port parity for the dp x tp standalone solvers of parallel.sharding:
`prepare_sharded_system`, `sharded_cg` and `batched_sharded_cg`.

The same seeded numpy inputs go through the JAX package on its virtual
CPU devices (tests/conftest.py) and through the port on `Mesh(["cpu"] *
n, dp=)`.  The systems are the small meshed planes of
`__graft_entry__._small_system`.  Gates:

* f64 solves: within 1e-9 of max|x| of the JAX function's x (the dots
  sum in another order; measured 1.2e-14 for the batch after 25
  iterations, 2.9e-14 to 1.1e-13 for one system after 40);
* the graft hook `entry()` (f32, 50 iterations, 4 right-hand sides)
  against `sharded_cg` on one CPU device: within 1e-4 of max|x|
  (measured 1.6e-5: f32 sums in another order);
* a column that meets `tol` stays frozen, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from padne_tpu.parallel import sharding as jsharding
from padne_tpu_torch.ops import assembly, spmv
from padne_tpu_torch.parallel import sharding

torch.set_num_threads(1)


def plane(max_size):
    """`__graft_entry__._small_system`'s plane as (JAX EllMatrix, the
    port's)."""
    _, jell = graft._small_system(max_size=max_size)
    return jell, assembly.EllMatrix(cols=np.asarray(jell.cols),
                                    vals=np.asarray(jell.vals),
                                    diag=np.asarray(jell.diag))


def pairs(n, shape, seed):
    """Balanced source/sink columns (a consistent right-hand side of the
    singular Laplacian), as `__graft_entry__.dryrun_multichip` makes
    them."""
    rng = np.random.default_rng(seed)
    b = np.zeros((*shape[:-1], n, shape[-1]))
    for col in np.ndindex(*shape):
        i, j = rng.integers(0, n, 2)
        b[col[:-1] + (i, col[-1])] += 1.0
        b[col[:-1] + (j, col[-1])] -= 1.0
    return b


def test_batched_sharded_cg_matches_jax():
    """`__graft_entry__.dryrun_multichip`'s batched solve (dp 2 x tp 4,
    B = 2 conductance scales, R = 2, 25 iterations, f64) through both
    packages."""
    jell, ell = plane(2.0)
    n = len(ell.diag)
    dp, tp, iters = 2, 4, 25
    n_pad = n + (-n) % tp
    scales = 1.0 + 0.5 * np.arange(dp)
    vals = np.stack([ell.vals * s for s in scales])
    diag = np.stack([ell.diag * s for s in scales])
    b = pairs(n, (dp, 2), seed=1)

    jmesh = jsharding.make_mesh(8, dp=dp)
    cols = jsharding.pad_rows(np.asarray(jell.cols), tp)
    cols[n:] = np.arange(n, n_pad)[:, None]
    want = np.asarray(jax.jit(
        lambda c, v, d, bb: jsharding.batched_sharded_cg(
            jmesh, c, v, d, bb, iters=iters))(
        jnp.asarray(cols), jnp.asarray(jsharding.pad_rows(vals, tp, 1)),
        jnp.asarray(jsharding.pad_rows(diag, tp, 1)),
        jnp.asarray(jsharding.pad_rows(b, tp, 1))))

    mesh = sharding.Mesh(["cpu"] * 8, dp=dp)
    batch = assembly.EllMatrix(cols=ell.cols, vals=vals, diag=diag)
    placed = sharding.prepare_sharded_system(batch, b, mesh)
    got = sharding.batched_sharded_cg(mesh, *placed, iters=iters)
    assert got.shape == want.shape == (dp, n_pad, 2)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-9 * np.abs(want).max(), rtol=0)
    # Each system on its dp row: the same as that system alone.
    alone = sharding.sharded_cg(
        sharding.Mesh(["cpu"] * tp),
        *sharding.prepare_sharded_system(assembly.EllMatrix(
            ell.cols, vals[1], diag[1]), b[1], sharding.Mesh(["cpu"] * tp)),
        iters=iters)
    np.testing.assert_allclose(got[1].numpy(), alone.numpy(),
                               atol=1e-12 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_cg_matches_jax_and_freezes(tp):
    """Column 1 (a source beside its sink) meets tol = 1e-2 by iteration
    25, column 0 (a pair far apart) does not: from there on column 1's x
    is frozen, in both packages."""
    jell, ell = plane(2.0)
    n = len(ell.diag)
    b = pairs(n, (1,), seed=1)
    i = int(np.flatnonzero(b[:, 0] > 0)[0])
    near = ell.cols[i][ell.vals[i] != 0][0]
    b = np.concatenate([b, np.zeros((n, 1))], axis=1)
    b[i, 1], b[near, 1] = 1.0, -1.0

    jmesh = jsharding.make_mesh(tp)
    want = np.asarray(jsharding.sharded_cg(
        jmesh, *jsharding.prepare_sharded_system(jell, b, jmesh), iters=40,
        tol=1e-2))
    mesh = sharding.Mesh(["cpu"] * tp)
    placed = sharding.prepare_sharded_system(ell, b, mesh)
    got = {k: sharding.sharded_cg(mesh, *placed, iters=k, tol=1e-2).numpy()
           for k in (25, 40)}
    assert got[40].shape == want.shape == (n + (-n) % tp, 2)
    np.testing.assert_allclose(got[40], want,
                               atol=1e-9 * np.abs(want).max(), rtol=0)
    a = ell.to_scipy()
    rel = (np.linalg.norm(b - a @ got[25][:n], axis=0)
           / np.linalg.norm(b, axis=0))
    assert rel[1] <= 1e-2 < rel[0]
    assert np.array_equal(got[25][:, 1], got[40][:, 1])
    assert not np.array_equal(got[25][:, 0], got[40][:, 0])


def test_graft_entry_matches_sharded_cg():
    """The graft hook's jittable solve step (f32 Jacobi-PCG, 50
    iterations, 4 right-hand sides, no mesh) and `sharded_cg` on one
    CPU device, on the same arrays."""
    fn, (vals, diag, rhs) = graft.entry()
    want, _ = jax.jit(fn)(vals, diag, rhs)
    want = np.asarray(want)
    _, jell = graft._small_system()
    ell = assembly.EllMatrix(cols=np.asarray(jell.cols),
                             vals=np.asarray(vals), diag=np.asarray(diag))
    mesh = sharding.Mesh(["cpu"])
    got = sharding.sharded_cg(
        mesh, *sharding.prepare_sharded_system(ell, np.asarray(rhs), mesh),
        iters=50)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_prepare_pads_and_places():
    """n = 281 rows over 4 shards: 3 inert padding rows; each shard's
    operator gives its rows of A x over the gathered x; a batch puts its
    systems in order on the dp rows."""
    _, ell = plane(2.0)
    n = len(ell.diag)
    assert n % 4
    b = pairs(n, (3,), seed=2)
    mesh = sharding.Mesh(["cpu"] * 4)
    cols, vals, diag, bs = sharding.prepare_sharded_system(ell, b, mesh)
    n_pad = n + (-n) % 4
    assert [op.n for op in cols] == [n_pad // 4] * 4
    assert all(op.nx == n_pad and op.diag is None for op in cols)
    assert all(v is op.val or v.data_ptr() == op.val.data_ptr()
               for op, v in zip(cols, vals))
    assert torch.equal(sharding.gather_to(diag, "cpu", 0),
                       torch.from_numpy(np.pad(ell.diag, (0, n_pad - n))))
    assert torch.equal(sharding.gather_to(bs, "cpu", 0),
                       torch.from_numpy(np.pad(b, ((0, n_pad - n), (0, 0)))))
    x = torch.randn(n_pad, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    y = torch.cat([spmv.ell_spmv(op, x) for op in cols])
    want = ell.to_scipy() @ x[:n].numpy()
    np.testing.assert_allclose(y[:n].numpy(), want, rtol=1e-13, atol=1e-13)
    assert not y[n:].any()

    mesh = sharding.Mesh(["cpu"] * 4, dp=2)
    scales = np.array([1.0, 2.0, 3.0, 4.0])
    batch = assembly.EllMatrix(
        cols=ell.cols, vals=ell.vals[None] * scales[:, None, None],
        diag=ell.diag[None] * scales[:, None])
    bb = np.stack([b] * 4)
    cols, vals, diag, bs = sharding.prepare_sharded_system(batch, bb, mesh)
    assert len(cols) == 4 and [tuple(v.shape) for v in vals] == [
        (2, cols[k].val.numel()) for k in range(4)]
    # Shards 0-1 hold systems 0-1, shards 2-3 systems 2-3.
    assert torch.equal(diag[3][1], 4.0 * diag[1][0])
    assert torch.equal(vals[2][0], 3.0 * vals[0][0])
    # One structure for the batch: index arrays shared with the row's
    # first system's operator.
    assert torch.equal(cols[0].col, cols[2].col)


def test_batch_must_split_over_dp():
    _, ell = plane(2.0)
    n = len(ell.diag)
    batch = assembly.EllMatrix(cols=ell.cols, vals=np.stack([ell.vals] * 3),
                               diag=np.stack([ell.diag] * 3))
    with pytest.raises(ValueError, match="does not split over dp=2"):
        sharding.prepare_sharded_system(batch, np.zeros((3, n, 1)),
                                        sharding.Mesh(["cpu"] * 4, dp=2))


def test_solvers_take_placed_systems():
    """The solvers run on what prepare_sharded_system placed: global
    arrays, or the lists of another mesh, raise."""
    _, ell = plane(2.0)
    n = len(ell.diag)
    b = pairs(n, (1,), seed=3)
    mesh = sharding.Mesh(["cpu"] * 2)
    with pytest.raises(TypeError, match="prepare_sharded_system"):
        sharding.sharded_cg(mesh, ell.cols, ell.vals, ell.diag, b)
    placed = sharding.prepare_sharded_system(ell, b, mesh)
    with pytest.raises(TypeError, match="expected 4 shard operators"):
        sharding.sharded_cg(sharding.Mesh(["cpu"] * 4), *placed)
    with pytest.raises(TypeError, match="expected 4 shard operators"):
        sharding.batched_sharded_cg(sharding.Mesh(["cpu"] * 4, dp=2),
                                    *placed)
