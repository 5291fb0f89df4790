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
four shards of the card against the one-device ones; and the launch
counters.  Tolerances: f32 sums in another order
(1e-5 of max|y|), f64 likewise (1e-12); K2' against the f64 bound
2e-13 * max(|A| |x|).
"""

import dataclasses

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
