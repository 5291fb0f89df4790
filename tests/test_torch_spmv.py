"""Port parity for ops.spmv: the plain version of kernel K3 (the ELL SpMV
of the generic route) against what it replaces in the JAX package, on
seeded numpy inputs given to both.

* the square form against padne_tpu.ops.spmv.ell_matvec (the XLA gather
  of the production path), f32 and f64, R in {1, 4}, rows with ELL
  padding: within 1e-6 (f32, summation order) and 1e-13 (f64) of
  max|y|;
* the square form against the two Pallas kernels it replaces,
  spmv_pallas.make_banded_spmv (K3a) and make_vmem_spmv (K3b), run in
  interpret mode on the banded inputs of tests/test_pallas_interpret.py,
  at that test's 2e-4 (the TPU kernels' own tolerance);
* the rectangular form (AMG prolongation/restriction, padding pointing
  at column 0) against the einsum of padne_tpu/ops/amg.py make_vcycle.

The device layout is K-major: assembly.EllMatrix.to_device is checked
to transpose exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padne_tpu.ops import spmv as jspmv
from padne_tpu.ops import spmv_pallas
from padne_tpu_torch.ops import assembly, spmv

from tests.test_pallas_interpret import banded_system, coo_to_ell

torch.set_num_threads(1)


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
    cols, vals, diag = ell.to_device("cpu", torch.from_numpy(x).dtype)
    assert cols.shape == (k, n) and cols.dtype == torch.int32
    np.testing.assert_array_equal(cols.numpy(), ell.cols.T)
    y = spmv.ell_spmv(cols, vals, diag, torch.from_numpy(x)).numpy()
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
    cols, vals, diag = ell.to_device("cpu", torch.float32)
    return spmv.ell_spmv(cols, vals, diag, torch.from_numpy(xpad)).numpy()


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
    y = spmv.ell_rect_spmv(torch.from_numpy(np.ascontiguousarray(cols.T)),
                           torch.from_numpy(np.ascontiguousarray(vals.T)),
                           torch.from_numpy(x)).numpy()
    assert y.shape == (n, r) and y.dtype == dtype
    assert np.abs(y - ref).max() <= rtol * np.abs(ref).max()
