"""Port parity for ops.cg: the deflated multi-RHS PCG in (R, N) layout,
preconditioned by the DIA V-cycle, against the JAX `make_pcg_t` on the
same hierarchy and right-hand sides.  Iteration counts match within one
(f32 reductions differ in order); the solutions agree to the CG
tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padne_tpu.ops import amg as jamg
from padne_tpu.ops import cg as jcg
from padne_tpu.ops import dia as jdia
from padne_tpu_torch.ops import amg, cg, dia

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

    op = amg.make_dia_cg_operator(th, "cpu", slots=8)
    vc = amg.make_vcycle_dia_t(th, "cpu", w0=op["w"], w_levels=0)
    solve = cg.make_pcg_t(
        operator=(lambda p, xt: dia.dia_matvec_t(meta0, p, xt), op),
        precond=vc, comp_id=torch.from_numpy(comp), num_components=2)
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
