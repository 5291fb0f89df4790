"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without a CUDA device (decided inside
the fixture, never at import).  On a GPU machine, which has no JAX, run
it without the suite's conftest (that one imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Covers what chip_smoke.py's fixed main-path shapes do not: K1' at
R in {1, 3, 4, 9} in f32 and bf16, on an odd operator (rows of very
different lengths, far columns, empty padding rows and row blocks, a
bf16 operator's f32 part), small and with entries beyond part A's int16
window (the int32-column part), and at R in {2, 3, 4, 9} on a level
wide enough for the 2- and 4-column chunks of K1'; K2' on the odd
operator; K3' at every lanes-per-row setting, f32 and f64, R in {1, 2,
4, 5}, each epilogue, square and rectangular with empty rows, rows off
the 16-byte grid; K1' and K2' over a window (x0 > 0, columns in the
halos and past them), and the sharded products of ops.dia_sharded on
four shards of the card against the one-device ones; the launch
counters; the DIA solve's exact f64 residual through K3' (against
SciPy's at the rounding of its terms); one SVD of the small Schur block
over a fragmented board's repeat solves; and a CG call as one CUDA graph
of its prologue, WHILE loop and epilogue (ops.cg, L1 in
csrc/graph_loop.cu): bit-equal to the plain loop run eagerly on the same
CUDA tensors in the ELL (N, R) layout, the DIA (R, N) layout with the
mean, one-hot and segment projectors, and make_pcg_sharded on four
shards of the card; calls with other b, tol and maxiter on one graph
equal fresh plain runs; an answer survives the next call and the
release of its graph; the launches counted are the parts' (prologue and
epilogue once a call, the iteration once an iteration); one launch, one
read and no eager launch a call; no iteration on a start that has
converged, k equal to the iterations L1 counted on the card, the
R = m + 1 graph released once A^+ C is cached, and a host read inside
an iteration raising at capture.  Tolerances: f32 sums in
another order (1e-5 of max|y|), f64 likewise (1e-12); K2' against the
f64 bound 2e-13 * max(|A| |x|).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from padne_tpu_torch.ops import comp, dia, spmv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operator(seed, np_=24 * 128, n=2900, max_len=40):
    """A random (np_, np_) operator in COO: rows 0..n-1 hold 0-max_len
    entries, mostly within +-300 columns, some anywhere (beyond part A's
    int16 window too when n > 2^15); rows n.. are padding (no entries,
    zero diagonal)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_len + 1, n)
    rows = np.repeat(np.arange(n), counts)
    near = rows + rng.integers(-300, 301, len(rows))
    far = rng.integers(0, n, len(rows))
    cols = np.where(rng.random(len(rows)) < 0.9, np.clip(near, 0, n - 1),
                    far)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(len(rows)) * 2081.0
    diag = np.zeros(np_)
    diag[:n] = 1e4 * (1.0 + rng.random(n))
    return np_, rows, cols, vals, diag


# Small, and wide enough for entries beyond part A's int16 window.
SIZES = {"small": (24 * 128, 2900), "far": (320 * 128, 39_900)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 3, 4, 9])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_dia_sell_matches_plain(cuda, dtype, r, size):
    np_, n = SIZES[size]
    np_, rows, cols, vals, diag = _operator(seed=r, np_=np_, n=n)
    # In bf16, a fifth of the entries keep f32 values (the remainder).
    keep_f32 = np.random.default_rng(r).random(len(rows)) < 0.2
    params = dia.build_sell(np_, rows, cols, vals, diag, cuda, dtype=dtype,
                            keep_f32=keep_f32)
    assert params["a_val"].dtype == dtype
    assert (params["b_val"].numel() > 0) == (dtype == torch.bfloat16
                                             or size == "far")
    xt = torch.randn(r, np_, device=cuda)
    before = dia.sell_matvec.launches
    y = dia.sell_matvec(params, xt)
    assert dia.sell_matvec.launches == before + 1
    ref = dia.sell_matvec_plain(params, xt)
    torch.cuda.synchronize()
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.all(y[:, n:] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [2, 3, 4, 9])
def test_dia_sell_wide_level(cuda, dtype, r):
    """A level of 18,432 slices: wide enough that K1' gives each lane a
    chunk of 2 (R = 2) or 4 RHS columns (ragged at R = 3 and 9)."""
    np_, rows, cols, vals, diag = _operator(seed=20 + r, np_=4608 * 128,
                                            n=589_000, max_len=8)
    keep_f32 = np.random.default_rng(r).random(len(rows)) < 0.1
    params = dia.build_sell(np_, rows, cols, vals, diag, cuda, dtype=dtype,
                            keep_f32=keep_f32)
    xt = torch.randn(r, np_, device=cuda)
    y = dia.sell_matvec(params, xt)
    ref = dia.sell_matvec_plain(params, xt)
    torch.cuda.synchronize()
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("size", sorted(SIZES))
def test_comp_sell_matches_f64(cuda, size):
    np_, n = SIZES[size]
    np_, rows, cols, vals, diag = _operator(seed=11, np_=np_, n=n)
    params = dia.build_sell(np_, rows, cols, vals, diag, cuda,
                            compensated=True)
    x = torch.linspace(0.0, 3.3, np_, device=cuda)
    before = comp.comp_sell.launches
    y = comp.comp_sell(params, x)
    assert comp.comp_sell.launches == before + 1
    ref = comp.comp_sell_plain(params, x)
    absp = dict(params, a_val=params["a_val"].abs(),
                a_lo=params["a_lo"].abs(), b_val=params["b_val"].abs(),
                b_lo=params["b_lo"].abs(), diag64=params["diag64"].abs())
    bound = comp.comp_sell_plain(absp, x.abs()).max()
    assert (y - ref).abs().max() <= 2e-13 * bound


def _windowed(seed, np_=24 * 128, n=2900, x0=384, extra=640):
    """_operator's rows over a window of x: row i's own column at x0 + i,
    each entry's column shifted by x0, and a fifth of them moved into
    the halos or past the rows (as a shard's near and far entries)."""
    np_, rows, cols, vals, diag = _operator(seed, np_=np_, n=n)
    nx = x0 + np_ + extra
    rng = np.random.default_rng(seed)
    moved = rng.random(len(rows)) < 0.2
    cols = np.where(moved, rng.integers(0, nx, len(rows)), cols + x0)
    return np_, rows, cols, vals, diag, nx, x0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 4])
def test_windowed_kernels_match_plain(cuda, dtype, r):
    np_, rows, cols, vals, diag, nx, x0 = _windowed(seed=30 + r)
    params = dia.build_sell(np_, rows, cols, vals, diag, cuda, dtype=dtype,
                            compensated=dtype == torch.float32, nx=nx, x0=x0)
    xt = torch.randn(r, nx, device=cuda)
    y = dia.sell_matvec(params, xt)
    ref = dia.sell_matvec_plain(params, xt)
    torch.cuda.synchronize()
    assert y.shape == (r, np_)
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()
    with pytest.raises(ValueError):
        dia.sell_matvec(params, xt[:, :np_].contiguous())
    if dtype == torch.float32:
        x = xt[0].contiguous()
        y = comp.comp_sell(params, x)
        ref = comp.comp_sell_plain(params, x)
        absp = dict(params, a_val=params["a_val"].abs(),
                    a_lo=params["a_lo"].abs(), b_val=params["b_val"].abs(),
                    b_lo=params["b_lo"].abs(), diag64=params["diag64"].abs())
        bound = comp.comp_sell_plain(absp, x.abs()).max()
        assert (y - ref).abs().max() <= 2e-13 * bound


def test_sharded_products_on_the_card(cuda):
    """K1' and K2' shard by shard (ops.dia_sharded) on four shards of the
    card against one launch over the whole operator."""
    from padne_tpu_torch.ops import dia_sharded
    from padne_tpu_torch.parallel import sharding

    np_, rows, cols, vals, diag = _operator(seed=40, np_=64 * 128, n=8000)
    pack = dia.pack_dia(np_, rows, cols, vals, diag=diag, np_override=np_)
    mesh = sharding.Mesh([cuda] * 4)
    op = dia_sharded.upload_sharded(pack, dia_sharded.plan_shards(pack, 4),
                                    mesh, compensated=True)
    whole = pack.to_device(cuda, compensated=True)
    xt = torch.randn(3, np_, device=cuda)
    before = dia.sell_matvec.launches
    y = torch.cat(dia_sharded.dia_matvec_t_sharded(
        op, sharding.split(mesh, xt, dim=1)), dim=1)
    assert dia.sell_matvec.launches == before + 4
    ref = dia.sell_matvec(whole, xt)
    x = xt[0].contiguous()
    c = torch.cat(dia_sharded.comp_sharded(op, sharding.split(mesh, x, 0)))
    c_ref = comp.comp_sell(whole, x)
    torch.cuda.synchronize()
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert (c - c_ref).abs().max() <= 1e-12 * c_ref.abs().max()


def _ell_operator(shape, dtype, cuda, seed, lanes):
    """A square (1037 rows, up to 24 entries a row) or rectangular
    (2001 x 263, up to 70) operator on the card with rows of 0..k
    entries, some empty, built at `lanes` lanes per row."""
    n, nx, k = (1037, 1037, 24) if shape == "square" else (2001, 263, 70)
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, k + 1, n)
    lens[::7] = 0
    live = np.arange(k)[None, :] < lens[:, None]
    cols = np.where(live, rng.integers(0, nx, (n, k)), 0).astype(np.int32)
    vals = np.where(live, rng.standard_normal((n, k)), 0.0)
    diag = rng.random(n) + 1.0 if shape == "square" else None
    return spmv.build_operator(cols, vals, diag, nx, cuda, dtype,
                               lanes=lanes)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 9])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("form", ["plain", "residual", "smooth", "add"])
@pytest.mark.parametrize("shape", ["square", "rect"])
def test_ell_spmv_matches_plain(cuda, shape, form, lanes, r, dtype, tol):
    """K3' at every lanes-per-row setting, both dtypes, the vector (R 2,
    4) and scalar (R 1; 3: one ragged chunk; 5: a ragged second chunk; 9:
    three chunks) row accesses, each epilogue, square and rectangular."""
    op = _ell_operator(shape, dtype, cuda, seed=r, lanes=lanes)
    g = torch.Generator(device=cuda).manual_seed(lanes)
    x = torch.randn(op.nx, r, generator=g, device=cuda, dtype=dtype)
    b, x0 = (torch.randn(op.n, r, generator=g, device=cuda, dtype=dtype)
             for _ in range(2))
    w = torch.rand(op.n, generator=g, device=cuda, dtype=dtype)
    kw = {"plain": {}, "residual": {"b": b}, "add": {"x0": x0},
          "smooth": {"b": b, "w": w, "x0": x0}}[form]
    before = spmv.ell_spmv.launches
    y = spmv.ell_spmv(op, x, **kw)
    assert spmv.ell_spmv.launches == before + 1
    ref = spmv.ell_spmv_plain(op, x, **kw)
    torch.cuda.synchronize()
    assert y.shape == (op.n, r) and y.dtype == dtype
    # The scale of the result and of the operands this form was given.
    scale = max(float(t.abs().max()) for t in (ref, *kw.values()))
    assert float((y - ref).abs().max()) <= tol * scale


def test_ell_spmv_unaligned_rows(cuda):
    """A view whose rows start off the 16-byte grid (R = 4 from an odd
    float offset) takes the scalar row accesses and still agrees."""
    op = _ell_operator("square", torch.float32, cuda, seed=3, lanes=4)
    flat = torch.randn(op.n * 4 + 1, device=cuda)
    x = flat[1:].view(op.n, 4)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y = spmv.ell_spmv(op, x, x0=x)
    ref = spmv.ell_spmv_plain(op, x, x0=x)
    torch.cuda.synchronize()
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_wrappers_reject_bad_operands(cuda):
    np_, rows, cols, vals, diag = _operator(seed=2)
    params = dia.build_sell(np_, rows, cols, vals, diag, cuda,
                            compensated=True)
    with pytest.raises(ValueError):    # f64 x
        dia.sell_matvec(params, torch.zeros(1, np_, device=cuda,
                                            dtype=torch.float64))
    with pytest.raises(ValueError):    # not contiguous
        dia.sell_matvec(params, torch.zeros(np_, 2, device=cuda).T)
    with pytest.raises(ValueError):    # wrong length
        comp.comp_sell(params, torch.zeros(np_ - 1, device=cuda))
    with pytest.raises(ValueError):    # index arrays on the host
        dia.sell_matvec(dict(params, a_idx=params["a_idx"].cpu()),
                        torch.zeros(1, np_, device=cuda))
    op = _ell_operator("square", torch.float32, cuda, seed=1, lanes=2)
    x = torch.zeros(op.n, 2, device=cuda)
    with pytest.raises(ValueError):    # f64 x against f32 values
        spmv.ell_spmv(op, x.double())
    with pytest.raises(ValueError):    # b on the host
        spmv.ell_spmv(op, x, b=x.cpu())
    with pytest.raises(ValueError):    # b not contiguous
        spmv.ell_spmv(op, x, b=torch.zeros(2, op.n, device=cuda).T)
    with pytest.raises(ValueError):    # int64 columns
        spmv.ell_spmv(dataclasses.replace(op, col=op.col.long()), x)


def test_ell_route_runs_through_k3(cuda):
    """A small ELL-route solve on the card (f32 inner, f64 residuals)
    reaches the gate through K3' and launches neither DIA kernel."""
    from padne_tpu_torch.ops import schur

    system = _grid_system(80)      # n = 6400: AMG-preconditioned
    before = (dia.sell_matvec.launches, comp.comp_sell.launches,
              spmv.ell_spmv.launches)
    stats = {}
    sol = schur.solve_bordered(system, inner_dtype=torch.float32,
                               device=cuda, stats=stats)
    assert stats["route"] == "ell" and len(stats["levels"]) >= 2
    assert sol.residual_norm < 1e-9
    assert (dia.sell_matvec.launches, comp.comp_sell.launches) == before[:2]
    assert spmv.ell_spmv.launches > before[2]


def _grid_system(g):
    from padne_tpu_torch.ops import assembly, schur

    idx = np.arange(g * g).reshape(g, g)
    e = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)])
    w = 0.5 + np.random.default_rng(0).random(len(e))
    ell = assembly.build_ell(g * g, e, w)
    n = g * g
    border = schur.BorderSpec(
        m=2, row_idx=np.array([0, 0, 1]), row_node=np.array([0, n - 1, n - 1]),
        row_val=np.array([1.0, -1.0, 1.0]), col_idx=np.array([0, 0, 1]),
        col_node=np.array([0, n - 1, n - 1]),
        col_val=np.array([1.0, -1.0, 1.0]), rhs=np.array([2.5, 0.0]))
    r_core = np.zeros(n)
    r_core[5], r_core[n - 6] = 0.1, -0.1
    coords = np.stack(np.meshgrid(np.arange(g), np.arange(g),
                                  indexing="ij"), -1).reshape(-1, 2)
    return schur.CoreSystem(
        n=n, ell=ell, comp_id=np.zeros(n, np.int32), num_components=1,
        border=border, r_core=r_core, ground_var=1,
        coords=coords.astype(float))


def test_solver_needs_no_cpu_fallback(cuda):
    """A small DIA solve on the card runs through both kernels."""
    from padne_tpu_torch.ops import schur

    k1, k2 = dia.sell_matvec.launches, comp.comp_sell.launches
    sol = schur.solve_bordered_dia(_grid_system(64), device=cuda,
                                   coarse_size=200)
    assert sol.residual_norm < 1e-10
    assert dia.sell_matvec.launches > k1 and comp.comp_sell.launches > k2


def test_dia_residual_runs_through_k3_in_f64(cuda):
    """The DIA solve's exact residual on the card, at 360,000 DoF: one
    K3' launch (square, f64, R 1, the b epilogue) after the ladder and
    one after each mop-up pass, and no other; the host SciPy residual of
    the returned (v, j) meets the target, and the reported norm is its
    to 1e-14 of the size of the residual's terms: the rounding of f64
    sums in another order, well under the gap (about 3e-10 here) between
    the compensated operator's residual and the exact one."""
    from padne_tpu_torch import kernels
    from padne_tpu_torch.ops import schur

    system = _grid_system(600)
    s = schur.DiaBorderedSolver(system, device=cuda)
    launched = []

    def hook(wrapper, *operands):
        if wrapper is spmv.ell_spmv:
            op, x, b, w, x0 = operands
            launched.append((op.n, op.nx, x.shape[1], x.dtype,
                             b is not None, w is None and x0 is None))

    kernels.HOOKS.append(hook)
    try:
        sol = s.solve(target_residual=1e-10)
    finally:
        kernels.HOOKS.remove(hook)
    n = system.n
    assert launched == [(n, n, 1, torch.float64, True, True)] * (
        1 + s.mopup_passes)
    assert sol.residual_norm < 1e-10
    L, r, *_ = schur.bordered_scipy_system(system)
    z = np.concatenate([sol.v, sol.j])
    host = float(np.linalg.norm(r - L @ z))
    terms = np.linalg.norm(np.abs(r) + abs(L) @ np.abs(z))
    assert host < 1e-10
    assert abs(sol.residual_norm - host) <= 1e-14 * terms


def test_a_fragmented_board_factors_its_small_block_once(cuda):
    """65 copper components (the smoke run's fragmented board at a small
    size) on the card: one SVD of the small Schur block, taken with A^+ C
    in the first solve, serves every later set_excitation + solve, and
    each answer's exact residual stays below 1e-10."""
    import chip_smoke
    from padne_tpu_torch import solver
    from padne_tpu_torch.ops import schur

    prob, cfg = chip_smoke.fragmented_problem(8000, tiles=(8, 8),
                                              tile_mm=4.0)
    system = solver.build_system(prob, cfg)[0]
    s = schur.DiaBorderedSolver(system, device=cuda, coarse_size=300)
    assert s.counters()["projector"] == "segment"
    r_core, rhs = system.r_core.copy(), system.border.rhs.copy()
    for scale in (1.0, 1.1, 0.9, 1.25):
        s.set_excitation(r_core * scale, rhs * scale)
        sol = s.solve(target_residual=1e-10)
        assert sol.residual_norm < 1e-10
        assert s.counters()["small_factorizations"] == 1


# -- the CG loop as CUDA WHILE graphs (ops.cg, csrc/graph_loop.cu) -----------


def _islands(side=24, p=2, seed=2):
    """p triangulated side x side grid islands: (EllMatrix, comp_id)."""
    from padne_tpu_torch.ops import assembly

    idx = np.arange(side * side).reshape(side, side)
    e0 = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
        np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)])
    edges = np.concatenate([e0 + i * side * side for i in range(p)])
    w = 0.5 + np.random.default_rng(seed).random(len(edges))
    comp_id = np.repeat(np.arange(p), side * side)
    return assembly.build_ell(p * side * side, edges, w), comp_id


def _loop_solver(cuda):
    from padne_tpu_torch.ops import amg, cg

    ell, comp_id = _islands()
    a = ell.to_device(cuda, torch.float64)
    vc = amg.make_vcycle(amg.build_hierarchy(ell), cuda, a0=a)
    return cg.make_pcg(a, torch.from_numpy(comp_id).to(cuda), 2,
                       precond=vc)


def _plain(monkeypatch):
    """Every CG call run by the plain loop (its prologue, cg._dispatch_plain
    and its epilogue), eagerly on the tensors the solve gives it (the
    card's included)."""
    from padne_tpu_torch.ops import cg

    monkeypatch.setattr(cg, "one_card", lambda devices: False)


def _rhs(n, r, seed, dtype=torch.float64, device="cuda"):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, r))).to(device=device, dtype=dtype)


def _same(got, want, graph=True):
    """got equals want bit for bit: x, iterations, residual norms."""
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.residual_norms, want.residual_norms)
    if graph:
        assert (got.host_reads, got.graph_calls) == (1, 1)


def test_graph_is_bit_equal_to_the_plain_loop(cuda, monkeypatch):
    """The ELL (N, R) layout: one launch of the CUDA graph that runs the
    captured prologue, the captured iteration while the device flag go
    holds and k < kmax, and the captured epilogue gives the bits and
    iterations of the plain loop run eagerly on the same CUDA tensors,
    with one host read a call; the second call launches the first's
    graph."""
    b = _rhs(2 * 24 * 24, 3, 5)
    with monkeypatch.context() as mp:
        _plain(mp)
        plain = _loop_solver(cuda)
        want = plain(b, 1e-10, 500)
    assert want.iterations > 10
    assert want.host_reads == want.iterations + 1
    assert want.graph_calls == 0
    assert not plain.loop.graphs
    solve = _loop_solver(cuda)
    for _ in range(2):
        _same(solve(b, 1e-10, 500), want)
    assert len(solve.loop.graphs) == 1


def _dia_solver(cuda, kind):
    """A DIA-route CG ((R, N) layout: K1' operator and cycle, f32, stall
    window 30) whose projector is `kind`, and a right-hand side (N, 3)
    with zeros on the padding rows: the CG of a DiaBorderedSolver (one
    copper component and the padding's: one-hot; the 65-component board
    of chip_smoke: segment), or, for the means, a make_pcg over the same
    operator and cycle with one component."""
    from padne_tpu_torch.ops import amg, cg, schur

    if kind == "segment":
        import chip_smoke
        from padne_tpu_torch import solver

        prob, cfg = chip_smoke.fragmented_problem(8000, tiles=(8, 8),
                                                  tile_mm=4.0)
        s = schur.DiaBorderedSolver(solver.build_system(prob, cfg)[0],
                                    device=cuda, coarse_size=300)
    else:
        s = schur.DiaBorderedSolver(_grid_system(64), device=cuda,
                                    coarse_size=200)
    h = s.hierarchy
    solve = s.cg_solver
    if kind == "mean":
        meta0 = h.levels[0].pack.meta
        solve = cg.make_pcg(
            None, torch.zeros(h.np0, dtype=torch.int64, device=cuda), 1,
            operator=(lambda prm, xt: dia.dia_matvec_t(meta0, prm, xt),
                      s.op_params),
            precond=amg.make_vcycle_dia_t(h, cuda), stall_window=30, dim=1)
    assert solve.projector == kind
    b = torch.zeros(h.np0, 3, dtype=torch.float32, device=cuda)
    b[torch.from_numpy(h.posmap0).to(cuda)] = _rhs(len(h.posmap0), 3, 13,
                                                   torch.float32, cuda)
    return solve, b


@pytest.mark.parametrize("kind", ["mean", "onehot", "segment"])
def test_dia_graph_is_bit_equal_to_the_plain_loop(cuda, monkeypatch, kind):
    """The DIA (R, N) layout with each projector: the graph's calls give
    the plain loop's bits on the same solver, its cycle in the prologue
    included."""
    solve, b = _dia_solver(cuda, kind)
    with monkeypatch.context() as mp:
        _plain(mp)
        want = solve(b, 1e-5, 500)
    assert want.iterations > 3 and not solve.loop.graphs
    for _ in range(2):
        _same(solve(b, 1e-5, 500), want)
    assert len(solve.loop.graphs) == 1


def _sharded_solver(cuda, dim):
    """make_pcg_sharded on four shards of the card: the two-island ELL
    system's K3' shard operators over an all-gathered x, Jacobi."""
    from padne_tpu_torch.ops import amg, cg
    from padne_tpu_torch.parallel import sharding

    ell, comp_id = _islands()
    n = len(ell.diag)
    mesh = sharding.Mesh([cuda] * 4)
    ops = amg.shard_ell_rows(ell.cols, ell.vals, ell.diag, n, n, mesh,
                             torch.float64)

    def matvec(prm, xs):
        full = sharding.all_gather(mesh, [x if dim == 0 else x.T
                                          for x in xs], dim=0)
        ys = [spmv.ell_spmv(op, xf) for op, xf in zip(prm, full)]
        return ys if dim == 0 else [y.T.contiguous() for y in ys]

    diag = torch.from_numpy(ell.diag).to(cuda)
    return cg.make_pcg_sharded(
        mesh, (matvec, ops), torch.from_numpy(comp_id), 2,
        cg.jacobi_sharded(sharding.split(mesh, diag, 0), dim=dim), dim=dim)


@pytest.mark.parametrize("dim", [0, 1])
def test_sharded_graph_is_bit_equal_to_the_plain_loop(cuda, monkeypatch,
                                                      dim):
    """make_pcg_sharded on a mesh of one card takes the graph: its calls
    give the plain loop's bits on the same solver."""
    solve = _sharded_solver(cuda, dim)
    b = _rhs(2 * 24 * 24, 3, 17)
    with monkeypatch.context() as mp:
        _plain(mp)
        want = solve(b, 1e-10, 500)
    assert want.iterations > 10 and not solve.loop.graphs
    for _ in range(2):
        _same(solve(b, 1e-10, 500), want)
    assert len(solve.loop.graphs) == 1


def test_calls_on_one_graph_take_their_own_inputs(cuda, monkeypatch):
    """Calls on one graph with another b, tol and maxiter each equal a
    fresh plain run of the same call: nothing of a call is baked into
    the capture (tol and maxiter are device scalars the host writes, b
    is copied in)."""
    solve = _loop_solver(cuda)
    b1, b2 = _rhs(2 * 24 * 24, 3, 21), _rhs(2 * 24 * 24, 3, 22)
    calls = [(b1, 1e-10, 500), (b2, 1e-7, 500), (b2, 1e-10, 5),
             (b1, 1e-10, 500)]
    got = [solve(*call) for call in calls]
    assert len(solve.loop.graphs) == 1
    assert got[2].iterations == 5
    assert got[1].iterations < got[0].iterations
    with monkeypatch.context() as mp:
        _plain(mp)
        for call, g in zip(calls, got):
            _same(g, _loop_solver(cuda)(*call))


def test_answers_survive_the_next_call_and_the_release(cuda, monkeypatch):
    """The x a call returns is its own, not the graph's buffer: the next
    call on the graph leaves it as it was; and DiaBorderedSolver's A^+ C,
    the answer of the R = m + 1 graph it releases, keeps the plain
    loop's bits after the pool's memory went back to the device and was
    written over, and after later solves."""
    from padne_tpu_torch.ops import schur

    solve = _loop_solver(cuda)
    first = solve(_rhs(2 * 24 * 24, 3, 31), 1e-10, 500)
    kept = (first.x.clone(), first.residual_norms.clone())
    solve(_rhs(2 * 24 * 24, 3, 32), 1e-10, 500)
    assert torch.equal(first.x, kept[0])
    assert torch.equal(first.residual_norms, kept[1])
    with monkeypatch.context() as mp:
        _plain(mp)
        plain = schur.DiaBorderedSolver(_grid_system(64), device=cuda,
                                        coarse_size=200)
        plain.solve(target_residual=1e-10)
    s = schur.DiaBorderedSolver(_grid_system(64), device=cuda,
                                coarse_size=200)
    s.solve(target_residual=1e-10)
    torch.cuda.empty_cache()
    junk = torch.full((1 << 24,), float("nan"), device=cuda)
    s.solve(target_residual=1e-10)
    del junk
    assert s.m > 0 and torch.equal(s._Xc, plain._Xc)
    assert s.counters()["graph_calls"] == s.host_reads > 0


def _tape_count(tape, wrapper):
    return sum(1 for w, _ in tape if w is wrapper)


def test_graph_launches_count_their_parts(cuda, monkeypatch):
    """The launches counted after n calls on a captured graph are n times
    the prologue's and the epilogue's plus the iterations ran times the
    iteration's (K3': the cycle in the prologue and each iteration, the
    fused true residual in the epilogue), as many as the plain loop
    counts for the same calls."""
    solve = _loop_solver(cuda)
    solve(_rhs(2 * 24 * 24, 3, 41), 1e-10, 500)
    (g,) = solve.loop.graphs.values()
    pro, it, epi = (_tape_count(t, spmv.ell_spmv) for t in g.tapes)
    assert pro > 0 and it > 0 and epi > 0
    calls = [(_rhs(2 * 24 * 24, 3, 42 + i), 1e-10, 500) for i in range(3)]
    before = spmv.ell_spmv.launches
    iters = [solve(*call).iterations for call in calls]
    counted = spmv.ell_spmv.launches - before
    assert counted == len(calls) * (pro + epi) + sum(iters) * it
    with monkeypatch.context() as mp:
        _plain(mp)
        plain = _loop_solver(cuda)
        before = spmv.ell_spmv.launches
        assert [plain(*call).iterations for call in calls] == iters
        assert spmv.ell_spmv.launches - before == counted


def test_one_launch_and_one_read_a_call(cuda, monkeypatch):
    """A call on a captured graph: one launch of L1's graph, one
    synchronising read (the flag), and no kernel counted outside the
    recount of the graph's tapes, so no part of the call, its
    preconditioner application included, runs eagerly."""
    from padne_tpu_torch import kernels

    solve = _loop_solver(cuda)
    solve(_rhs(2 * 24 * 24, 3, 51), 1e-10, 500)
    lib = kernels.load()
    launched, eager, recounting = [], [], [False]

    class Counting:
        def __getattr__(self, name):
            return getattr(lib, name)

        def pg_loop_launch(self, loop, stream):
            launched.append(loop)
            return lib.pg_loop_launch(loop, stream)

    real_recount = kernels.recount

    def recount(tape, times=1):
        recounting[0] = True
        try:
            real_recount(tape, times)
        finally:
            recounting[0] = False

    def hook(wrapper, *operands):
        if not recounting[0]:
            eager.append(wrapper)

    monkeypatch.setattr(kernels, "load", lambda: Counting())
    monkeypatch.setattr(kernels, "recount", recount)
    b = _rhs(2 * 24 * 24, 3, 52)
    torch.cuda.synchronize()
    kernels.HOOKS.append(hook)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = solve(b, 1e-9, 500)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        kernels.HOOKS.remove(hook)
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    assert res.iterations > 0 and (res.host_reads, res.graph_calls) == (1, 1)
    assert len(launched) == 1
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert not eager


def test_graph_replays_count_their_launches(cuda, monkeypatch):
    """K3''s count is the launches the card ran: a capture counts none,
    each launch of the graph counts the prologue's and the epilogue's
    once and the iteration's once per iteration it ran.  A solve that
    launches a graph runs what the plain loop runs, launch for
    launch."""
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2 * 24 * 24, 3))).to(cuda)
    graph = _loop_solver(cuda)
    counts = []
    for plain in (True, False, False):
        with monkeypatch.context() as mp:
            if plain:
                _plain(mp)
            solve = _loop_solver(cuda) if plain else graph
            before = spmv.ell_spmv.launches
            res = solve(b, 1e-10, 500)
            counts.append(spmv.ell_spmv.launches - before)
    assert res.host_reads == 1
    # The first graph solve adds the warm-up of the three parts before
    # the capture.
    assert counts[2] == counts[0] < counts[1]
    assert len(graph.loop.graphs) == 1


def _toy(x0, kmax, target=1e9):
    """chip_smoke's toy graph, its inputs written: (graph, its state)."""
    import chip_smoke

    g = chip_smoke._toy_graph(float(x0), kmax, target)
    return g, g.state


def test_a_converged_start_runs_no_iteration(cuda):
    """A launch whose go is false on entry (x from b already at the
    target) runs no iteration: the state and the answer are what the
    prologue wrote; the next, with another b, runs to the target; a
    solve whose right-hand side is zero (converged at its prologue)
    reads once and runs none."""
    from padne_tpu_torch.ops import cg

    g, s = _toy(9.0, 100, target=8.0)
    launches = cg.loop_launch.launches
    (x,), k = g.dispatch()
    assert k == 0 and float(x) == 9.0
    assert (float(s.x), int(s.k), bool(s.go)) == (9.0, 0, False)
    assert g.flag.tolist() == [0, 0, 0]
    assert cg.loop_launch.launches == launches + 1
    g.write(torch.tensor(0.0, device=cuda), 8.0, 100)
    (x,), k = g.dispatch()
    assert k == 8 and float(x) == 8.0
    assert g.flag.tolist() == [0, 8, 8] and float(s.x) == 8.0
    solve = _loop_solver(cuda)
    b = _rhs(2 * 24 * 24, 2, 8)
    assert solve(b, 1e-10, 500).iterations > 0
    res = solve(torch.zeros_like(b), 1e-10, 500)
    assert (res.iterations, res.host_reads) == (0, 1)
    assert not res.x.any()


def test_k_equals_the_iterations_l1_counted(cuda):
    """The iterations the card ran, counted by L1's cond kernel on the
    device, equal k after each launch: where go turns false, at kmax and
    for whole solves, the count running on across the solves that launch
    one graph; L1's launch count is one begin a launch and one cond an
    iteration."""
    from padne_tpu_torch.ops import cg

    g, s = _toy(0.0, 100, target=12.0)
    launches = cg.loop_launch.launches
    (x,), k = g.dispatch()
    assert k == 12 and float(x) == 12.0
    assert g.flag.tolist() == [0, 12, 12] and float(s.x) == 12.0
    assert cg.loop_launch.launches == launches + 1 + 12
    g, s = _toy(0.0, 7)
    assert g.dispatch()[1] == 7 and g.flag.tolist() == [0, 7, 7]
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2 * 24 * 24, 3))).to(cuda)
    solve = _loop_solver(cuda)
    for times in (1, 2):
        before = cg.loop_launch.launches
        res = solve(b, 1e-10, 500)
        (graph,) = solve.loop.graphs.values()
        assert graph.flag.tolist() == [0, res.iterations,
                                       times * res.iterations]
        assert (cg.loop_launch.launches - before
                == res.iterations + res.host_reads)


def test_the_border_columns_graph_is_released(cuda):
    """A DiaBorderedSolver's first CG runs at R = m + 1 (A^+ C with the
    residual column); once A^+ C is cached no pass runs that width
    again, and the solver holds no graph of it; its R = 1 graph stays
    for the next solve."""
    from padne_tpu_torch.ops import schur

    s = schur.DiaBorderedSolver(_grid_system(64), device=cuda,
                                coarse_size=200)
    assert s.m > 0
    for _ in range(2):
        sol = s.solve(target_residual=1e-10)
        assert sol.residual_norm < 1e-10
        widths = {key[0][0][0] for key in s.cg_solver.loop.graphs}
        assert widths == {1}, widths


def test_a_host_read_in_the_body_raises(cuda):
    """A CUDA solve whose iteration reads a value on the host fails its
    capture and raises: it does not run the plain loop."""
    from padne_tpu_torch.ops import cg

    ell, comp_id = _islands(side=16, p=1)
    a = ell.to_device(cuda, torch.float64)

    def reading(prm, x):
        y = spmv.ell_spmv(prm["a"], x)
        float(y.sum())
        return y

    solve = cg.make_pcg(None, torch.from_numpy(comp_id).to(cuda), 1,
                        operator=(reading, {"a": a, "diag": a.diag}))
    b = torch.ones(len(ell.diag), 2, dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError):
        solve(b, 1e-10, 100)
    torch.cuda.synchronize()
