"""Port parity for ops.cg.

* make_pcg in (R, N) layout (dim=1, the DIA route), preconditioned by
  the DIA V-cycle, against the JAX `make_pcg_t` on the same hierarchy
  and right-hand sides.  Iteration counts match within one (f32
  reductions differ in order); the solutions agree to the CG tolerance.
* make_projector: the (R, N) layout gives the transpose of the (N, R)
  one in all three branches (mean, one-hot, segment sum).
* make_pcg: the generic route's (N, R) PCG over the ELL operator with
  the ELL AMG cycle, against the JAX `make_pcg` in f64 at 1, 5 and 80
  deflation components (the last takes the segment-sum projector).
  Iterations within one, x within 1e-9 of max|x|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padne_tpu.ops import amg as jamg
from padne_tpu.ops import assembly as jassembly
from padne_tpu.ops import cg as jcg
from padne_tpu.ops import dia as jdia
from padne_tpu_torch.ops import amg, assembly, cg, dia

from tests.test_amg_dia import grid_laplacian

torch.set_num_threads(1)


@pytest.mark.parametrize("tol", [1e-5, 3e-4])
def test_pcg_t_matches_jax(tol):
    ell, coords = grid_laplacian(64, seed=4)
    jh = jamg.build_hierarchy_dia(ell, coords, coarse_size=100,
                                  max_offsets=4)
    th = amg.build_hierarchy_dia(ell, coords, coarse_size=100,
                                 max_offsets=4)
    np0 = th.np0
    # Two components: the real rows and the dummy padding rows.
    comp = np.ones(np0, dtype=np.int64)
    comp[th.posmap0] = 0
    rng = np.random.default_rng(11)
    b = np.zeros((np0, 3), np.float32)
    b[th.posmap0] = rng.standard_normal((len(th.posmap0), 3))

    jop = jamg.make_dia_cg_operator(jh, slots=8)
    jvc = jamg.make_vcycle_dia_t(jh, backend="xla", w0=jop["w"])
    meta0 = jh.levels[0].pack.meta
    jsolve = jcg.make_pcg_t(
        operator=(lambda p, xt: jdia.dia_matvec_t(meta0, p, xt,
                                                  backend="xla"), jop),
        precond=jvc, comp_id=jnp.asarray(comp), num_components=2)
    jres = jsolve(jnp.asarray(b), tol, 300)

    op = amg.make_dia_cg_operator(th, "cpu")
    vc = amg.make_vcycle_dia_t(th, "cpu", w_levels=0)
    solve = cg.make_pcg(
        None, torch.from_numpy(comp), 2,
        operator=(lambda p, xt: dia.dia_matvec_t(meta0, p, xt), op),
        precond=vc, stall_window=30, dim=1)
    res = solve(torch.from_numpy(b), tol, 300)

    assert abs(res.iterations - int(jres.iterations)) <= 1
    assert res.iterations > 3
    x_ref = np.asarray(jres.x)
    x = res.x.numpy()
    assert x.shape == x_ref.shape == b.shape
    assert np.abs(x - x_ref).max() <= 20 * tol * np.abs(x_ref).max()
    # Each column converged to its relative tolerance.
    real = b[th.posmap0]
    bn = np.linalg.norm(real - real.mean(0), axis=0)
    assert (res.residual_norms.numpy() <= 2 * tol * bn).all()


@pytest.mark.parametrize("p", [1, 5, 80])
def test_projector_layouts(p):
    rng = np.random.default_rng(p)
    comp_id = torch.from_numpy(rng.integers(0, p, 500))
    x = torch.from_numpy(rng.standard_normal((500, 3)))
    y0 = cg.make_projector(comp_id, p)(x)
    y1 = cg.make_projector(comp_id, p, dim=1)(x.T.contiguous())
    np.testing.assert_allclose(y1.T.numpy(), y0.numpy(), rtol=0,
                               atol=1e-14)
    sums = torch.zeros(p, 3, dtype=x.dtype).index_add_(0, comp_id, y0)
    assert float(sums.abs().max()) <= 1e-12


def _grid_islands(p, side, seed):
    """p disjoint side x side triangulated grids (p components)."""
    idx = np.arange(side * side).reshape(side, side)
    e0 = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
        np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)])
    edges = np.concatenate([e0 + i * side * side for i in range(p)])
    w = 0.5 + np.random.default_rng(seed).random(len(edges))
    n = p * side * side
    comp_id, num = jassembly.connected_components(n, edges, w)
    assert num == p
    return jassembly.build_ell(n, edges, w), comp_id


@pytest.mark.parametrize("p,side", [(1, 72), (5, 30), (80, 8)])
def test_pcg_matches_jax(p, side):
    ell, comp_id = _grid_islands(p, side, seed=p)
    rng = np.random.default_rng(30 + p)
    b = rng.standard_normal((len(ell.diag), 3))
    tol = 1e-10

    jh = jamg.build_hierarchy(ell)
    jsolve = jcg.make_pcg(*ell.to_device(), jnp.asarray(comp_id), p,
                          precond=jamg.make_vcycle(jh))
    jres = jsolve(jnp.asarray(b), tol, 500)

    tell = assembly.EllMatrix(cols=ell.cols, vals=ell.vals, diag=ell.diag)
    th = amg.build_hierarchy(tell)
    solve = cg.make_pcg(tell.to_device("cpu"),
                        torch.from_numpy(comp_id), p,
                        precond=amg.make_vcycle(th, "cpu"))
    res = solve(torch.from_numpy(b), tol, 500)

    assert res.iterations > 3
    assert abs(res.iterations - int(jres.iterations)) <= 1
    x_ref = np.asarray(jres.x)
    x = res.x.numpy()
    assert x.shape == x_ref.shape == b.shape
    assert np.abs(x - x_ref).max() <= 1e-9 * np.abs(x_ref).max()
    # Deflated: every component's mean of x is zero.
    sums = np.zeros((p, 3))
    np.add.at(sums, comp_id, x)
    assert np.abs(sums).max() <= 1e-9 * np.abs(x).sum(0).max()


def test_pcg_jacobi_and_custom_operator():
    """Jacobi fallback over the ELL operator, and the same solve through
    a custom operator whose params carry the diagonal."""
    from padne_tpu_torch.ops import spmv

    ell, comp_id = _grid_islands(2, 20, seed=9)
    b = np.random.default_rng(8).standard_normal((len(ell.diag), 2))
    jres = jcg.make_pcg(*ell.to_device(), jnp.asarray(comp_id), 2)(
        jnp.asarray(b), 1e-10, 2000)
    tell = assembly.EllMatrix(cols=ell.cols, vals=ell.vals, diag=ell.diag)
    a = tell.to_device("cpu")
    cid = torch.from_numpy(comp_id)
    res = cg.make_pcg(a, cid, 2)(torch.from_numpy(b), 1e-10, 2000)
    op = (lambda prm, x: spmv.ell_spmv(prm["a"], x),
          {"a": a, "diag": a.diag})
    res_op = cg.make_pcg(None, cid, 2, operator=op)(
        torch.from_numpy(b), 1e-10, 2000)
    assert abs(res.iterations - int(jres.iterations)) <= 1
    x_ref = np.asarray(jres.x)
    assert np.abs(res.x.numpy() - x_ref).max() <= 1e-9 * np.abs(x_ref).max()
    np.testing.assert_array_equal(res_op.x.numpy(), res.x.numpy())
    with pytest.raises(ValueError):
        cg.make_pcg(None, cid, 2, operator=(op[0], {}))
    with pytest.raises(ValueError):
        cg.make_pcg(a, cid, 2, dim=1)
