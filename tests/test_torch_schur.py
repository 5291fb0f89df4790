"""Port parity for ops.schur: the DIA bordered solver against the JAX
DiaBorderedSolver on the same systems, with the JAX package's CPU
settings on the port side (f32 cycle slabs) and the W-cycle both off
and on (PADNE_TPU_WCYCLE on the JAX side).

Gates: both reach the 1e-10 residual target; max |dV| <= 1e-6 of the
potential scale; border currents agree likewise; total CG iterations
within 3 (f32 reduction order differs).  The small Schur block's one
factorization an instance is held against fresh instances, scipy's
direct solve, np.linalg.lstsq and np.linalg.pinv."""

import collections
import dataclasses
import time

import numpy as np
import pytest
import torch

from padne_tpu.ops import schur as jschur
from padne_tpu_torch import convert, spans
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


def _stall_ladder_at(s, k):
    """Make the compensated ladder of solver `s` stall at its k-th pass
    (its norm read as 1), so that the mop-up passes take over."""
    fused, calls = s._fused_pass, []

    def stalled(*args):
        out = fused(*args)
        calls.append(1)
        return out if len(calls) != k else (*out[:4],
                                            torch.ones_like(out[4]))

    s._fused_pass = stalled


def test_reported_residual_is_exact(monkeypatch):
    """The reported norm is the exact f64 residual of the returned
    (v, j), and a second solve of the same instance (cached A^+ C)
    agrees.  With the ladder stalled at its first pass the mop-up passes
    run on the exact residual: the norm is still exact, v agrees with
    the JAX solve, no sparse product runs on the host, and nothing
    n-sized crosses between host and device after the first Schur pass
    but v in the one download at the end."""
    import scipy.sparse

    jsystem = make_system(g=64, seed=7)
    system = convert.core_system_from_numpy(jsystem)
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

    s = schur.DiaBorderedSolver(system, device="cpu",
                                cycle_dtype=torch.float32, w_levels=0)
    _stall_ladder_at(s, 1)
    log = collections.deque(maxlen=spans.LOG.maxlen)
    crossings = []   # (elements, perf_counter, the open spans' names)

    def crossing(real, host_array):
        def call(*args, **kw):
            out = real(*args, **kw)
            crossings.append((host_array(args, out).size,
                              time.perf_counter(),
                              [sp.name for sp in spans._stack()]))
            return out
        return call

    def host_product(*args, **kw):
        raise AssertionError("a sparse product on the host")

    with monkeypatch.context() as mp:
        mp.setattr(spans, "LOG", log)
        mp.setattr(torch.Tensor, "numpy",
                   crossing(torch.Tensor.numpy, lambda args, out: out))
        mp.setattr(torch, "from_numpy",
                   crossing(torch.from_numpy, lambda args, out: args[0]))
        for cls in (scipy.sparse.csr_matrix, scipy.sparse.csc_matrix,
                    scipy.sparse.coo_matrix):
            mp.setattr(cls, "__matmul__", host_product)
            mp.setattr(cls, "dot", host_product)
        mop = s.solve(target_residual=1e-10)
    assert s.ladder_exit == "stall" and s.mopup_passes >= 1
    assert mop.residual_norm < 1e-10
    z = np.concatenate([mop.v, mop.j])
    true_norm = float(np.linalg.norm(r - L @ z))
    assert np.isclose(true_norm, mop.residual_norm, rtol=1e-6, atol=1e-13)
    ref = jschur.DiaBorderedSolver(jsystem).solve(target_residual=1e-10)
    assert np.abs(mop.v - ref.v).max() <= 1e-9

    # One download after the ladder: at the end, beside the small
    # block's own in each pass.
    passes = [rec for rec in log if rec.name == "schur.pass"]
    assert len(passes) == 1 + s.mopup_passes
    downloads = [rec for rec in log if rec.name == "schur.download"]
    assert [rec.depth for rec in downloads] == [2] * len(passes) + [1]
    first_end = passes[0].start + passes[0].seconds
    late = [(size, names) for size, at, names in crossings
            if size >= system.n and at > first_end]
    assert late == [(system.n, ["schur.solve", "schur.download"])]


def test_ladder_exit_and_mopup_passes():
    """ladder_exit says why the compensated ladder stopped and
    mopup_passes counts the passes on the exact residual after it; the
    DIA route's stats carry both."""
    system = convert.core_system_from_numpy(make_system(g=64, seed=7))

    def solver():
        return schur.DiaBorderedSolver(system, device="cpu",
                                       cycle_dtype=torch.float32,
                                       w_levels=0)

    s = solver()
    sol = s.solve(target_residual=1e-10)
    assert (s.ladder_exit, s.mopup_passes) == ("target", 0)
    capped = s.solve(target_residual=1e-10, max_refinements=1)
    assert (s.ladder_exit, s.mopup_passes) == ("cap", 0)
    assert capped.refinement_steps == 1
    assert capped.residual_norm > 1e-10
    s = solver()
    _stall_ladder_at(s, 2)
    stalled = s.solve(target_residual=1e-10)
    assert s.ladder_exit == "stall" and s.mopup_passes >= 1
    assert stalled.residual_norm < 1e-10
    assert np.abs(stalled.v - sol.v).max() < 1e-9
    # Below the compensated operator's floor the ladder ends at its own
    # target and the exact residual takes mop-up passes.
    for target, mopup in ((1e-10, 0), (1e-13, 1)):
        stats = {}
        deep = schur.solve_bordered(system, operator="dia", device="cpu",
                                    inner_dtype=torch.float32, stats=stats,
                                    target_residual=target)
        assert stats["route"] == "dia"
        assert stats["ladder_exit"] == "target"
        assert (stats["mopup_passes"] >= 1) == bool(mopup)
        assert deep.residual_norm < target


def test_repeat_solves_are_bit_equal():
    """A solve is a function of its inputs (the smoke run's phase repeat,
    on the CPU): two set-ups give the same first solve bit for bit, and
    the later solves of one instance, which reuse its cached A^+ C,
    equal each other."""
    system = convert.core_system_from_numpy(make_system(g=64, seed=7))

    def solver():
        return schur.DiaBorderedSolver(system, device="cpu",
                                       cycle_dtype=torch.float32,
                                       w_levels=0, coarse_size=COARSE)

    def same(a, b):
        return (a.cg_iterations == b.cg_iterations
                and a.refinement_steps == b.refinement_steps
                and a.residual_norm == b.residual_norm
                and np.array_equal(a.v, b.v) and np.array_equal(a.j, b.j))

    s = solver()
    first = s.solve(target_residual=1e-10)
    assert same(first, solver().solve(target_residual=1e-10))
    second = s.solve(target_residual=1e-10)
    assert same(second, s.solve(target_residual=1e-10))


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


def _excited(system, rng):
    """A copy of `system` with new source values: every border
    right-hand side and every core injection scaled by its own draw."""
    b = system.border
    return dataclasses.replace(
        system, r_core=system.r_core * rng.uniform(0.75, 1.25, system.n),
        border=dataclasses.replace(
            b, rhs=b.rhs * rng.uniform(0.9, 1.1, b.m)))


def test_the_small_block_is_factored_once_an_instance():
    """A warm DiaBorderedSolver takes one SVD of its small Schur block
    (with A^+ C, in its first solve) and none in its later requests:
    each set_excitation + solve equals a fresh instance's solve of the
    same excitation (1e-9 V, 1e-9 A), and scipy's direct solve, within
    one refinement pass."""
    import scipy.sparse.linalg

    base = convert.core_system_from_numpy(
        make_fragmented_system(48, (8, 12), seed=5))
    assert base.num_components + 1 > 64

    def solver(system):
        return schur.DiaBorderedSolver(system, device="cpu",
                                       coarse_size=COARSE)

    warm = solver(_excited(base, np.random.default_rng(0)))
    assert warm.counters()["small_factorizations"] == 0
    warm.solve(target_residual=1e-10)
    assert warm.counters()["projector"] == "segment"
    rng = np.random.default_rng(1)
    for _ in range(3):
        system = _excited(base, rng)
        warm.set_excitation(system.r_core, system.border.rhs)
        got = warm.solve(target_residual=1e-10)
        assert warm.counters()["small_factorizations"] == 1
        fresh = solver(system)
        ref = fresh.solve(target_residual=1e-10)
        assert fresh.counters()["small_factorizations"] == 1
        assert got.residual_norm < 1e-10
        assert np.abs(got.v - ref.v).max() <= 1e-9
        assert np.abs(got.j - ref.j).max() <= 1e-9
        assert abs(got.refinement_steps - ref.refinement_steps) <= 1
        L, r, *_ = schur.bordered_scipy_system(system)
        z = scipy.sparse.linalg.spsolve(L, r)
        assert np.abs(z[:system.n] - got.v).max() <= 1e-9
        assert np.abs(z[system.n:] - got.j).max() <= 1e-9


def _close(got, want):
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)


@pytest.mark.parametrize("board", ["fragmented", "one component"])
def test_the_cached_pseudo_inverses_answer_as_lstsq_and_pinv(board):
    """The passes' cached pseudo-inverse gives np.linalg.lstsq's answer
    on the small block, the ladder's np.linalg.pinv's (1e-12 relative):
    on the 192-wide block of 96 tiles and on the 4 x 4 block of one
    grid with a regulator (m = 3)."""
    jsystem = (make_fragmented_system(48, (8, 12), seed=5)
               if board == "fragmented"
               else make_system(g=64, with_regulator=True, seed=7))
    s = schur.DiaBorderedSolver(convert.core_system_from_numpy(jsystem),
                                device="cpu", coarse_size=COARSE)
    s.solve(target_residual=1e-10)
    M = s._small_block(s._border_apply(s._Xc).numpy())
    assert M.shape == (s.m + s.p,) * 2
    assert board == "fragmented" or M.shape == (4, 4)
    assert np.array_equal(schur.small_pinvs(M)[0], s._pinv)
    rhs = np.random.default_rng(2).standard_normal(len(M))
    _close(s._pinv @ rhs, np.linalg.lstsq(M, rhs, rcond=None)[0])
    _close(s._small64[0].numpy() @ rhs, np.linalg.pinv(M) @ rhs)


def test_the_cutoffs_part_where_a_singular_value_lies_between():
    """A block with one singular value between pinv's cutoff (1e-15 of
    the largest) and lstsq's (eps * 290 of it): the passes' matrix drops
    it as lstsq does, the ladder's keeps it as pinv does."""
    rng = np.random.default_rng(3)
    Q1, _ = np.linalg.qr(rng.standard_normal((290, 290)))
    Q2, _ = np.linalg.qr(rng.standard_normal((290, 290)))
    sv = np.logspace(0, -3, 290)
    sv[-1] = 1e-14
    M = (Q1 * sv) @ Q2.T
    passes, ladder = schur.small_pinvs(M)
    assert passes is not ladder
    rhs = rng.standard_normal(290)
    _close(passes @ rhs, np.linalg.lstsq(M, rhs, rcond=None)[0])
    _close(ladder @ rhs, np.linalg.pinv(M) @ rhs)
    assert np.linalg.norm(ladder @ rhs) > 1e3 * np.linalg.norm(passes @ rhs)
