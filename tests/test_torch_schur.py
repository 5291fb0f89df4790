"""Port parity for ops.schur: the DIA bordered solver against the JAX
DiaBorderedSolver on the same systems, with the JAX package's CPU
settings on the port side (f32 cycle slabs) and the W-cycle both off
and on (PADNE_TPU_WCYCLE on the JAX side).

Gates: both reach the 1e-10 residual target; max |dV| <= 1e-6 of the
potential scale; border currents agree likewise; total CG iterations
within 3 (f32 reduction order differs)."""

import numpy as np
import pytest
import torch

from padne_tpu.ops import schur as jschur
from padne_tpu_torch import convert
from padne_tpu_torch.ops import schur

from tests.test_schur_dia import make_system

torch.set_num_threads(1)

COARSE = 200   # small enough for a 3+ level hierarchy at g=64


@pytest.mark.parametrize("with_regulator,w_levels", [(False, 0), (True, 3)])
def test_matches_jax_solver(with_regulator, w_levels, monkeypatch):
    monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", str(COARSE))
    monkeypatch.setenv("PADNE_TPU_WCYCLE", str(w_levels))
    jsystem = make_system(g=64, with_regulator=with_regulator, seed=3)
    ref = jschur.DiaBorderedSolver(jsystem).solve(target_residual=1e-10)

    s = schur.DiaBorderedSolver(
        convert.core_system_from_numpy(jsystem), device="cpu",
        cycle_dtype=torch.float32, w_levels=w_levels, coarse_size=COARSE)
    assert len(s.hierarchy.levels) >= 3
    got = s.solve(target_residual=1e-10)

    assert ref.residual_norm < 1e-10
    assert got.residual_norm < 1e-10
    scale = max(np.abs(ref.v).max(), 1e-12)
    assert np.abs(got.v - ref.v).max() <= 1e-6 * scale
    assert np.abs(got.j - ref.j).max() <= 1e-6 * max(np.abs(ref.j).max(),
                                                     1e-12)
    assert abs(got.cg_iterations - ref.cg_iterations) <= 3
    assert np.isclose(got.ground_current, ref.ground_current, atol=1e-8)


def test_reported_residual_is_exact():
    """The reported norm is the host f64 residual of the returned (v, j),
    and a second solve of the same instance (cached A^+ C) agrees."""
    system = convert.core_system_from_numpy(make_system(g=64, seed=7))
    s = schur.DiaBorderedSolver(system, device="cpu",
                                cycle_dtype=torch.float32, w_levels=0)
    sol = s.solve(target_residual=1e-10)
    L, r, *_ = schur.bordered_scipy_system(system)
    z = np.concatenate([sol.v, sol.j])
    # L z = r in the [[-A, C], [B, 0]] layout: r - L z is the residual.
    true_norm = float(np.linalg.norm(r - L @ z))
    assert np.isclose(true_norm, sol.residual_norm, rtol=1e-6, atol=1e-13)
    again = s.solve(target_residual=1e-10)
    assert again.residual_norm < 1e-10
    assert np.abs(again.v - sol.v).max() < 1e-9


def test_unported_routes_raise():
    """A system too small for a DIA hierarchy raises the private
    _NoDiaHierarchy, on which solve_bordered(operator="dia") falls
    through to the ELL route, as the JAX package does; a DIA solve with
    more than 63 deflation components is not ported and raises."""
    system = convert.core_system_from_numpy(make_system(g=20))
    with pytest.raises(schur._NoDiaHierarchy):
        schur.DiaBorderedSolver(system, device="cpu")
    stats = {}
    sol = schur.solve_bordered(system, operator="dia", device="cpu",
                               stats=stats)
    assert stats["route"] == "ell" and sol.residual_norm < 1e-9

    fragmented = convert.core_system_from_numpy(make_system(g=64, seed=1))
    fragmented.comp_id = np.arange(fragmented.n) % 70
    fragmented.num_components = 70
    with pytest.raises(NotImplementedError):
        schur.DiaBorderedSolver(fragmented, device="cpu", coarse_size=COARSE)
