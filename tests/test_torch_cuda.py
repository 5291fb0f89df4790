"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without a CUDA device (decided inside
the fixture, never at import).  On a GPU machine, which has no JAX, run
it without the suite's conftest (that one imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Covers what chip_smoke.py's fixed main-path shapes do not: ragged RHS
chunks (R not a multiple of the kernel's chunk), offsets that run off
both ends of the block range, bf16 slabs with slots, odd ELL shapes
(R in {1, 3, 9}, f32 and f64, rectangular, padding that points at row
0) and the launch counters.  Tolerances: f32 sums in another order
(1e-5 of max|y|), f64 likewise (1e-12); K2 against the f64 bound
2e-13 * max(|A| |x|).
"""

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


def _slab(nb, offs, dtype, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(nb, len(offs), 128, 128, generator=g, device=cuda)
    return w.to(dtype).reshape(nb // 2, 2, len(offs), 128, 128)


def _slots(nb, e, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    tgt = torch.randint(0, nb, (nb * e,), generator=g, device=cuda,
                        dtype=torch.int32)
    ci = torch.randint(0, 128, (nb, e, 128), generator=g, device=cuda,
                       dtype=torch.int32)
    we = torch.randn(nb, e, 128, generator=g, device=cuda)
    return tgt, ci, we


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 3, 4, 9])
@pytest.mark.parametrize("e", [0, 8])
def test_dia_slab_matches_plain(cuda, dtype, r, e):
    nb = 24
    offs = (-30, -2, -1, 0, 1, 5, 31)
    meta = (nb * 128, 128, 2, nb // 2, offs)
    w = _slab(nb, offs, dtype, cuda, seed=r)
    slots = _slots(nb, e, cuda, seed=e) if e else None
    xt = torch.randn(r, nb * 128, device=cuda)
    before = dia.slab_matvec.launches
    y = dia.slab_matvec(meta, w, xt, slots)
    assert dia.slab_matvec.launches == before + 1
    ref = dia.slab_matvec_plain(meta, w, xt, slots)
    torch.cuda.synchronize()
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_comp_slab_matches_f64(cuda):
    nb = 16
    offs = (-3, -1, 0, 1, 2)
    meta = (nb * 128, 128, 2, nb // 2, offs)
    w64 = torch.randn(nb, len(offs), 128, 128, device=cuda,
                      dtype=torch.float64) * 2081.0
    w = w64.float()
    w_lo = (w64 - w.double()).float()
    x = torch.linspace(0.0, 3.3, nb * 128, device=cuda)
    before = comp.comp_slab.launches
    y = comp.comp_slab(meta, w, w_lo, x)
    assert comp.comp_slab.launches == before + 1
    ref = comp.comp_slab_plain(meta, w, w_lo, x)
    bound = comp.comp_slab_plain(meta, w.abs(), w_lo.abs(), x.abs()).max()
    assert (y - ref).abs().max() <= 2e-13 * bound


def _ell(n, nx, k, dtype, cuda, seed, pad_to=None):
    """K-major (K, n) ELL arrays: random columns in [0, nx), and the last
    slot of every third row padding (value 0) pointing at `pad_to` (the
    row itself when None)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cols = torch.randint(0, nx, (k, n), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(k, n, generator=g, device=cuda, dtype=dtype)
    pad = torch.arange(0, n, 3, device=cuda)
    cols[-1, pad] = (pad.to(torch.int32) if pad_to is None
                     else torch.full_like(pad, pad_to, dtype=torch.int32))
    vals[-1, pad] = 0.0
    return cols, vals


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("r", [1, 3, 9])
def test_ell_spmv_matches_plain(cuda, dtype, tol, r):
    n, k = 1037, 7
    cols, vals = _ell(n, n, k, dtype, cuda, seed=r)
    diag = torch.rand(n, device=cuda, dtype=dtype) + 1.0
    x = torch.randn(n, r, device=cuda, dtype=dtype)
    before = spmv.ell_spmv.launches
    y = spmv.ell_spmv(cols, vals, diag, x)
    assert spmv.ell_spmv.launches == before + 1
    ref = spmv.ell_spmv_plain(cols, vals, diag, x)
    torch.cuda.synchronize()
    assert y.shape == (n, r) and y.dtype == dtype
    assert (y - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("r", [1, 3, 9])
def test_ell_rect_spmv_matches_plain(cuda, dtype, tol, r):
    """The prolongation shape: more rows than x, padding at column 0."""
    n, nx, k = 2001, 263, 5
    cols, vals = _ell(n, nx, k, dtype, cuda, seed=10 + r, pad_to=0)
    x = torch.randn(nx, r, device=cuda, dtype=dtype)
    before = spmv.ell_rect_spmv.launches
    y = spmv.ell_rect_spmv(cols, vals, x)
    assert spmv.ell_rect_spmv.launches == before + 1
    ref = spmv.ell_rect_spmv_plain(cols, vals, x)
    torch.cuda.synchronize()
    assert y.shape == (n, r)
    assert (y - ref).abs().max() <= tol * ref.abs().max()


def test_wrappers_reject_bad_operands(cuda):
    meta = (256, 128, 2, 1, (0,))
    w = torch.zeros(1, 2, 1, 128, 128, device=cuda)
    with pytest.raises(ValueError):
        dia.slab_matvec(meta, w, torch.zeros(1, 256, device=cuda,
                                             dtype=torch.float64))
    with pytest.raises(ValueError):
        dia.slab_matvec(meta, w, torch.zeros(256, 2, device=cuda).T)
    with pytest.raises(ValueError):
        comp.comp_slab(meta, w, w, torch.zeros(255, device=cuda))
    cols = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    vals = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):    # int64 columns
        spmv.ell_spmv(cols.long(), vals, vals[0], torch.zeros(8, 1,
                                                              device=cuda))
    with pytest.raises(ValueError):    # f64 x against f32 vals
        spmv.ell_spmv(cols, vals, vals[0], torch.zeros(
            8, 1, device=cuda, dtype=torch.float64))


def test_ell_route_runs_through_k3(cuda):
    """A small ELL-route solve on the card (f32 inner, f64 residuals)
    reaches the gate through K3 and launches neither DIA kernel."""
    from padne_tpu_torch.ops import schur

    system = _grid_system(80)      # n = 6400: AMG-preconditioned
    before = (dia.slab_matvec.launches, comp.comp_slab.launches,
              spmv.ell_spmv.launches, spmv.ell_rect_spmv.launches)
    stats = {}
    sol = schur.solve_bordered(system, inner_dtype=torch.float32,
                               device=cuda, stats=stats)
    assert stats["route"] == "ell" and len(stats["levels"]) >= 2
    assert sol.residual_norm < 1e-9
    assert (dia.slab_matvec.launches, comp.comp_slab.launches) == before[:2]
    assert spmv.ell_spmv.launches > before[2]
    assert spmv.ell_rect_spmv.launches > before[3]


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

    k1, k2 = dia.slab_matvec.launches, comp.comp_slab.launches
    sol = schur.solve_bordered_dia(_grid_system(64), device=cuda,
                                   coarse_size=200)
    assert sol.residual_norm < 1e-10
    assert dia.slab_matvec.launches > k1 and comp.comp_slab.launches > k2
