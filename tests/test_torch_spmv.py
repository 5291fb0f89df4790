"""Port parity for ops.spmv: the sliced-ELL device format of kernel K3'
(the ELL SpMV of the generic route) and its plain version, against what
they replace in the JAX package, on seeded numpy inputs given to both.

* the stored image (every stored entry put back at its row and column)
  equals the ELL operator entry for entry: square and rectangular, rows
  of very unequal length, an empty row, a row count that fills no whole
  slice, every lanes-per-row setting;
* the square form against padne_tpu.ops.spmv.ell_matvec (the XLA gather
  of the production path), f32 and f64, R in {1, 4}, rows with ELL
  padding: within 1e-6 (f32, summation order) and 1e-13 (f64) of
  max|y|;
* the square form against the two Pallas kernels it replaces,
  spmv_pallas.make_banded_spmv (K3a) and make_vmem_spmv (K3b), run in
  interpret mode on the banded inputs of tests/test_pallas_interpret.py,
  at that test's 2e-4 (the TPU kernels' own tolerance);
* the rectangular form (AMG prolongation/restriction, padding pointing
  at column 0) against the einsum of padne_tpu/ops/amg.py make_vcycle;
* each fused form (residual, damped-Jacobi step, prolongation and
  correction) against the unfused expression over the plain product:
  1e-6 (f32) and 1e-14 (f64) of the largest operand, rounding only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padne_tpu.ops import spmv as jspmv
from padne_tpu.ops import spmv_pallas
from padne_tpu_torch.ops import assembly, spmv

from tests.test_pallas_interpret import banded_system, coo_to_ell

torch.set_num_threads(1)

LANES = (1, 2, 4, 8, 16, 32)


def _padded_ell(n, k, seed):
    """Random ELL with every third row one entry short (padding at the
    row itself with value 0, as assembly.build_ell pads)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, (n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k))
    pad = np.arange(0, n, 3)
    cols[pad, -1] = pad
    vals[pad, -1] = 0.0
    diag = rng.random(n) + 1.0
    return assembly.EllMatrix(cols=cols, vals=vals, diag=diag)


def _ragged_ell(n, nx, k, seed, pad_self):
    """ELL arrays whose rows hold 0..k entries (row 5 none, row 7 all k),
    padded as the host packing pads: value 0 at the row itself (square)
    or at column 0 (rectangular)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, k + 1, n)
    lens[5], lens[7] = 0, k
    live = np.arange(k)[None, :] < lens[:, None]
    cols = np.where(live, rng.integers(0, nx, (n, k)),
                    np.arange(n)[:, None] if pad_self else 0)
    vals = np.where(live, rng.standard_normal((n, k)), 0.0)
    return cols.astype(np.int32), vals


def _dense(n, nx, rows, cols, vals):
    out = np.zeros((n, nx))
    np.add.at(out, (rows, cols), vals)
    return out


SHAPES = {"square": (333, 333, 12, True),      # the level operator
          "tall": (1201, 150, 5, False),       # a prolongation
          "wide": (93, 1201, 70, False)}       # a restriction: long rows


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stored_image_equals_ell(shape, lanes):
    n, nx, k, square = SHAPES[shape]
    cols, vals = _ragged_ell(n, nx, k, seed=lanes, pad_self=square)
    diag = np.random.default_rng(3).random(n) + 1.0 if square else None
    op = spmv.build_operator(cols, vals, diag, nx, "cpu", torch.float64,
                             lanes=lanes)
    assert (op.n, op.nx, op.lanes) == (n, nx, lanes)
    assert op.perm.dtype == op.col.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(op.perm.numpy()), np.arange(n))
    ptr = op.ptr.numpy()
    assert len(ptr) == -(-n * lanes // 32) + 1 and ptr[0] == 0
    assert (np.diff(ptr) % 32 == 0).all() and ptr[-1] == op.col.numel()
    # Every nonzero is stored once, the rest is padding (0 at column 0).
    stored = op.val.numpy() != 0
    assert stored.sum() == (vals != 0).sum()
    assert (op.col.numpy()[~stored] == 0).all()
    # No slice is longer than its longest lane needs.
    lens = (vals != 0).sum(1)[op.perm.numpy()]
    lane_len = -(-(np.pad(lens, (0, -n % (32 // lanes)))[:, None]
                   - np.arange(lanes)).clip(0) // lanes)
    np.testing.assert_array_equal(
        np.diff(ptr), 32 * lane_len.reshape(-1, 32).max(1))
    # The image: entry for entry the ELL operator.
    pos = op.entry_pos.numpy()
    assert (pos[stored] < n).all()
    rows = op.perm.numpy()[np.minimum(pos, n - 1)]
    image = _dense(n, nx, rows[stored], op.col.numpy()[stored],
                   op.val.numpy()[stored])
    np.testing.assert_array_equal(
        image, _dense(n, nx, np.repeat(np.arange(n), k), cols.ravel(),
                      vals.ravel()))
    if square:
        np.testing.assert_array_equal(op.diag.numpy(), diag)
    # f32 values share the index arrays.
    op32 = op.to(torch.float32)
    assert op32.col is op.col and op32.ptr is op.ptr and op32.perm is op.perm
    assert op32.val.dtype == torch.float32 and op.to(torch.float64) is op
    assert op32.to(torch.float32) is op32
    np.testing.assert_array_equal(op32.val.numpy(),
                                  op.val.numpy().astype(np.float32))


# The products of a 154,257-row board's hierarchy (rows, mean nonzeros a
# row) and the lanes a row gets: one lane walks a short row of a large
# level, a whole warp the 97-entry rows of the deepest restriction.
@pytest.mark.parametrize("n,mean_len,lanes", [
    (154_257, 5.96, 2), (154_257, 2.8, 1), (19_100, 22.0, 8),
    (19_100, 13.7, 4), (19_100, 4.1, 4), (1_873, 42.0, 32),
    (1_873, 34.5, 32), (1_873, 11.5, 16), (223, 97.0, 32),
    (1_000_000, 6.0, 2), (50, 0.0, 1)])
def test_choose_lanes(n, mean_len, lanes):
    assert spmv.choose_lanes(mean_len, n) == lanes


def test_build_and_product_reject_bad_operands():
    cols, vals = _ragged_ell(40, 30, 4, seed=1, pad_self=False)
    bad = cols.copy()
    bad[0, 0] = 30
    with pytest.raises(ValueError, match="out of range"):
        spmv.build_operator(bad, vals, None, 30, "cpu", torch.float64)
    with pytest.raises(ValueError, match="power of two"):
        spmv.build_operator(cols, vals, None, 30, "cpu", torch.float64,
                            lanes=3)
    op = spmv.build_operator(cols, vals, None, 30, "cpu", torch.float64)
    x = torch.zeros(30, 2, dtype=torch.float64)
    with pytest.raises(ValueError):    # x of the wrong row count
        spmv.ell_spmv(op, x[:29])
    with pytest.raises(ValueError):    # f32 x against f64 values
        spmv.ell_spmv(op, x.float())
    with pytest.raises(ValueError):    # b of the wrong shape
        spmv.ell_spmv(op, x, b=torch.zeros(40, 1, dtype=torch.float64))
    with pytest.raises(ValueError):    # w without b
        spmv.ell_spmv(op, x, w=torch.zeros(40, dtype=torch.float64))


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-13)])
@pytest.mark.parametrize("r", [1, 4])
def test_square_matches_ell_matvec(dtype, rtol, r):
    n, k = 777, 9
    ell = _padded_ell(n, k, seed=r)
    x = np.random.default_rng(50 + r).standard_normal((n, r)).astype(dtype)
    ref = np.asarray(jspmv.ell_matvec(
        jnp.asarray(ell.cols), jnp.asarray(ell.vals.astype(dtype)),
        jnp.asarray(ell.diag.astype(dtype)), jnp.asarray(x)))
    op = ell.to_device("cpu", torch.from_numpy(x).dtype)
    assert isinstance(op, spmv.EllOperator) and op.n == op.nx == n
    y = spmv.ell_spmv(op, torch.from_numpy(x)).numpy()
    assert y.dtype == dtype and y.shape == (n, r)
    assert np.abs(y - ref).max() <= rtol * np.abs(ref).max()


def _padded_inputs(n, n_pad, ell, x):
    k, r = ell.cols.shape[1], x.shape[1]
    cols_p = np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, k))
    cols_p[:n] = ell.cols
    vals_p = np.zeros((n_pad, k), np.float32)
    vals_p[:n] = ell.vals
    diag_p = np.zeros(n_pad, np.float32)
    diag_p[:n] = ell.diag
    xpad = np.zeros((n_pad, r), np.float32)
    xpad[:n] = x
    return cols_p, vals_p, diag_p, xpad


def _port(cols_p, vals_p, diag_p, xpad):
    ell = assembly.EllMatrix(cols=cols_p, vals=vals_p, diag=diag_p)
    op = ell.to_device("cpu", torch.float32)
    return spmv.ell_spmv(op, torch.from_numpy(xpad)).numpy()


@pytest.mark.parametrize("variant", ["banded", "vmem"])
def test_square_matches_pallas_kernels(variant):
    if variant == "banded":    # K3a, as TestSpmvPallasInterpret runs it
        n, spread, r, seed = 1500, 40, 4, 11
    else:                      # K3b
        n, spread, r, seed = 900, 200, 2, 13
    _, rows, cols, vals, diag = banded_system(n, seed=seed, spread=spread)
    ell = coo_to_ell(n, rows, cols, vals, diag)
    k = ell.cols.shape[1]
    x = np.random.default_rng(seed + 1).standard_normal((n, r)).astype(
        np.float32)
    if variant == "banded":
        made = spmv_pallas.make_banded_spmv(
            n, k, r, jnp.float32, ell.cols, block_rows=512, interpret=True)
        apply_fn, n_pad, local = made
        cols_p, vals_p, diag_p, xpad = _padded_inputs(n, n_pad, ell, x)
        ref = apply_fn(jnp.asarray(local), jnp.asarray(vals_p),
                       jnp.asarray(diag_p), jnp.asarray(xpad))
    else:
        made = spmv_pallas.make_vmem_spmv(
            n, k, r, jnp.float32, block_rows=256, interpret=True)
        apply_fn, n_pad = made
        cols_p, vals_p, diag_p, xpad = _padded_inputs(n, n_pad, ell, x)
        ref = apply_fn(jnp.asarray(cols_p), jnp.asarray(vals_p),
                       jnp.asarray(diag_p), jnp.asarray(xpad))
    ref = np.asarray(ref)[:n]
    y = _port(cols_p, vals_p, diag_p, xpad)[:n]
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-13)])
def test_rect_matches_vcycle_einsum(dtype, rtol):
    """P-shaped: 1200 fine rows over 150 coarse columns, one row in
    three padded at column 0 with value 0."""
    n, nx, k, r = 1200, 150, 4, 3
    rng = np.random.default_rng(21)
    cols = rng.integers(0, nx, (n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(dtype)
    cols[::3, -1], vals[::3, -1] = 0, 0.0
    x = rng.standard_normal((nx, r)).astype(dtype)
    ref = np.asarray(jnp.einsum("nk,nkr->nr", jnp.asarray(vals),
                                jnp.asarray(x)[jnp.asarray(cols)]))
    op = spmv.build_operator(cols, vals, None, nx, "cpu",
                             torch.from_numpy(x).dtype)
    y = spmv.ell_spmv(op, torch.from_numpy(x)).numpy()
    assert y.shape == (n, r) and y.dtype == dtype
    assert np.abs(y - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-14)])
@pytest.mark.parametrize("form", ["residual", "smooth", "add"])
@pytest.mark.parametrize("shape", ["square", "tall"])
def test_fused_forms_match_unfused(shape, form, dtype, rtol):
    n, nx, k, square = SHAPES[shape]
    cols, vals = _ragged_ell(n, nx, k, seed=8, pad_self=square)
    rng = np.random.default_rng(9)
    diag = rng.random(n) + 1.0 if square else None
    op = spmv.build_operator(cols, vals, diag, nx, "cpu", dtype)
    x, b, x0 = (torch.from_numpy(rng.standard_normal((rows, 3))).to(dtype)
                for rows in (nx, n, n))
    w = torch.from_numpy(rng.random(n)).to(dtype)
    ax = spmv.ell_spmv(op, x)
    if form == "residual":
        got, want = spmv.ell_spmv(op, x, b=b), b - ax
    elif form == "smooth":
        got = spmv.ell_spmv(op, x, b=b, w=w, x0=x0)
        want = x0 + w[:, None] * (b - ax)
    else:
        got, want = spmv.ell_spmv(op, x, x0=x0), x0 + ax
    assert got.dtype == dtype and got.shape == (n, 3)
    scale = max(float(ax.abs().max()), float(b.abs().max()))
    assert float((got - want).abs().max()) <= rtol * scale
