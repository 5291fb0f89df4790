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
    through to the ELL route, as the JAX package does."""
    system = convert.core_system_from_numpy(make_system(g=20))
    with pytest.raises(schur._NoDiaHierarchy):
        schur.DiaBorderedSolver(system, device="cpu")
    stats = {}
    sol = schur.solve_bordered(system, operator="dia", device="cpu",
                               stats=stats)
    assert stats["route"] == "ell" and sol.residual_norm < 1e-9


def make_fragmented_system(g, tiles, seed=0):
    """A g x g triangulated grid cut into tiles[0] x tiles[1] separate
    copper tiles (no edge crosses a tile's border), so every tile is its
    own component of the Laplacian.  Tile 0 is the rail: every other
    tile is held at its own voltage against the rail by a voltage source
    and loaded by a current source that returns through the rail; the
    ground pin sits on the rail.  Every component is touched by a border
    row, so the bordered system is nonsingular."""
    from padne_tpu.ops import assembly as jassembly

    tx, ty = tiles
    assert g % tx == 0 and g % ty == 0
    idx = np.arange(g * g).reshape(g, g)
    tile = ((np.arange(g) // (g // tx))[:, None] * ty
            + (np.arange(g) // (g // ty))[None, :])
    e = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
        np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)], 0)
    flat = tile.ravel()
    e = e[flat[e[:, 0]] == flat[e[:, 1]]].astype(np.int64)
    rng = np.random.default_rng(seed)
    w = 0.5 + rng.random(len(e))
    n, p = g * g, tx * ty
    ell = jassembly.build_ell(n, e, w)
    comp_id, num = jassembly.connected_components(n, e, w)
    assert num == p
    xs, ys = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel()], 1).astype(float)

    first = np.array([np.flatnonzero(flat == t)[0] for t in range(p)])
    last = np.array([np.flatnonzero(flat == t)[-1] for t in range(p)])
    rail = first[0]
    row, col, rhs = [], [], []
    r_core = np.zeros(n)
    for k, t in enumerate(range(1, p)):
        row += [(k, first[t], 1.0), (k, rail, -1.0)]
        col += [(k, first[t], 1.0), (k, rail, -1.0)]
        rhs.append(1.0 + 0.01 * t)
        load = 0.05 + 0.001 * t
        r_core[last[t]] -= load
        r_core[last[0]] += load
    k = p - 1
    row.append((k, rail, 1.0))
    col.append((k, rail, 1.0))
    rhs.append(0.0)
    border = jschur.BorderSpec(
        m=k + 1,
        row_idx=np.array([x[0] for x in row], dtype=np.int64),
        row_node=np.array([x[1] for x in row], dtype=np.int64),
        row_val=np.array([x[2] for x in row]),
        col_idx=np.array([x[0] for x in col], dtype=np.int64),
        col_node=np.array([x[1] for x in col], dtype=np.int64),
        col_val=np.array([x[2] for x in col]),
        rhs=np.array(rhs))
    return jschur.CoreSystem(
        n=n, ell=ell, comp_id=comp_id, num_components=p, border=border,
        r_core=r_core, ground_var=k, coords=coords)


@pytest.mark.parametrize("g,tiles", [(70, (7, 10)), (60, (10, 15))])
def test_fragmented_dia_solve_matches_jax(g, tiles, monkeypatch):
    """More than 63 copper components on the DIA route: the port keeps
    its (R, N) layout with the segment-sum projector, the JAX package
    leaves it for the normal layout with another cycle and ladder.  So
    the iteration counts differ (printed, not compared); the potentials
    agree within 1e-9 V and both residuals are below 1e-10."""
    monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", str(COARSE))
    jsystem = make_fragmented_system(g, tiles, seed=5)
    p = tiles[0] * tiles[1]
    assert p + 1 > 64
    ref = jschur.DiaBorderedSolver(jsystem).solve(target_residual=1e-10)

    s = schur.DiaBorderedSolver(
        convert.core_system_from_numpy(jsystem), device="cpu",
        coarse_size=COARSE)
    assert len(s.hierarchy.levels) >= 2
    got = s.solve(target_residual=1e-10)
    print(f"p={p}: port {got.cg_iterations} CG iterations / "
          f"{got.refinement_steps} passes, JAX {ref.cg_iterations} / "
          f"{ref.refinement_steps}")
    assert ref.residual_norm < 1e-10
    assert got.residual_norm < 1e-10
    assert np.abs(got.v - ref.v).max() <= 1e-9
    assert np.abs(got.j - ref.j).max() <= 1e-9
    L, r, *_ = schur.bordered_scipy_system(s.system)
    import scipy.sparse.linalg

    z = scipy.sparse.linalg.spsolve(L, r)
    assert np.abs(z[:s.system.n] - got.v).max() <= 1e-9


def test_fragmented_board_on_the_dia_route():
    """A generated board of 64 separate tiles and a rail (the smoke
    run's fragmented board at a small size), through the port's own host
    pipeline: 65 copper components on the DIA route, against scipy's
    direct solve of the same bordered system (1e-9 V) and against the
    auto route, which sends so small a system to the host direct
    solve."""
    import scipy.sparse.linalg

    import chip_smoke
    from padne_tpu_torch import solver

    prob, cfg = chip_smoke.fragmented_problem(8000, tiles=(8, 8),
                                              tile_mm=4.0)
    system = solver.build_system(prob, cfg)[0]
    assert system.num_components == 65 and system.border.m == 65
    s = schur.DiaBorderedSolver(system, device="cpu", coarse_size=300)
    got = s.solve()
    assert got.residual_norm < 1e-9
    L, r, *_ = schur.bordered_scipy_system(system)
    z = scipy.sparse.linalg.spsolve(L, r)
    assert np.abs(z[:system.n] - got.v).max() <= 1e-9
    assert np.abs(z[system.n:] - got.j).max() <= 1e-9 * np.abs(z).max()
    stats = {}
    auto = schur.solve_bordered(system, device="cpu", stats=stats)
    assert stats["route"] == "direct"
    assert np.abs(auto.v - got.v).max() <= 1e-9
    # Every tile sits at its own source voltage above the rail.
    feed = got.v[system.border.row_node[0:2 * 64:2]]
    rail = got.v[system.border.row_node[1:2 * 64:2]]
    np.testing.assert_allclose(feed - rail, 0.5 + 0.002 * np.arange(64),
                               rtol=0, atol=1e-9)
