"""Port parity for ops.dia: host packing and the plain version of K1'.

The same seeded inputs go through padne_tpu.ops.dia (the reference) and
padne_tpu_torch.ops.dia.  Host packing must be bit-identical; the
sliced-ELL operator's image must equal the JAX pack's operator entry for
entry, and its matvec is held against the JAX `dia_matvec_t` with the
`xla` backend and the Pallas kernel in interpret mode.

Tolerances (relative to max|y|):
* f32 operators: 1e-5 against both — only the f32 summation order
  differs;
* bf16 operators: 1e-5 against `xla` fed f32 x (the JAX slab widened
  to f32: the same widen-W-to-f32 contraction; with a bf16 slab the
  `xla` backend rounds x to bf16 too), 1e-2 against `interpret`,
  because the Pallas kernel also rounds x to bf16 (an MXU input format,
  not part of the math).
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

from padne_tpu.ops import bell as jbell
from padne_tpu.ops import dia as jdia
from padne_tpu_torch import convert
from padne_tpu_torch.ops import bell, dia

from tests.test_amg_dia import grid_laplacian
from tests.test_dia_sharded import grid_system

torch.set_num_threads(1)


def _packs(ell, coords, **kw):
    perm = jbell.hilbert_order(coords)
    np.testing.assert_array_equal(bell.hilbert_order(coords), perm)
    return (jdia.pack_ell_as_dia(ell, perm=perm, **kw),
            dia.pack_ell_as_dia(ell, perm=perm, **kw))


def _assert_pack_equal(jp, tp):
    assert tp.meta == jp.meta and tp.n == jp.n
    for name in ("widx_hi", "widx_lo", "wval", "rem_rows", "rem_cols",
                 "rem_vals", "diag"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _image(params):
    """The operator a sliced-ELL params dict holds, as an f64 CSR."""
    (pos_a, col_a), (pos_b, col_b) = dia.sell_entries(params)
    perm = params["perm"].long()
    np_ = len(perm)
    rows = torch.cat([perm[pos_a], perm[pos_b], torch.arange(np_)])
    cols = torch.cat([col_a, col_b, torch.arange(np_)])
    vals = torch.cat([params["a_val"].double(), params["b_val"].double(),
                      params["diag"].double()])
    a = scipy.sparse.coo_matrix((vals.numpy(), (rows.numpy(), cols.numpy())),
                                shape=(np_, np_)).tocsr()
    a.eliminate_zeros()
    return a


def _jax_image(jp, slab_dtype=np.float32):
    """The JAX pack's operator (offset entries decoded by the JAX
    package's coo_from_widx, values rounded as its slab stores them,
    remainder and diagonal in f32), as an f64 CSR."""
    rows, cols = jdia.coo_from_widx(jp.meta, jnp.asarray(jp.widx_hi),
                                    jnp.asarray(jp.widx_lo))
    main = np.asarray(jnp.asarray(jp.wval.astype(np.float32),
                                  dtype=slab_dtype).astype(jnp.float32))
    n = jp.np_
    a = scipy.sparse.coo_matrix(
        (np.concatenate([main, jp.rem_vals.astype(np.float32),
                         jp.diag.astype(np.float32)]).astype(np.float64),
         (np.concatenate([np.asarray(rows), jp.rem_rows, np.arange(n)]),
          np.concatenate([np.asarray(cols), jp.rem_cols, np.arange(n)]))),
        shape=(n, n)).tocsr()
    a.eliminate_zeros()
    return a


def _assert_same_operator(a, b):
    assert a.shape == b.shape
    assert abs(a - b).max() == 0.0


CASES = {
    "grid_far": lambda: grid_system(96, 96, n_far=40),
    "laplacian": lambda: grid_laplacian(64, seed=2),
}


class TestHostPacking:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("max_offsets", [2, 4])
    def test_pack_equal(self, case, max_offsets):
        ell, coords = CASES[case]()
        jp, tp = _packs(ell, coords, max_offsets=max_offsets, coverage=0.9)
        _assert_pack_equal(jp, tp)
        assert len(tp.rem_rows) > 0

    @pytest.mark.parametrize("coverage,max_offsets", [(0.95, 8), (0.5, 2)])
    def test_choose_offsets_equal(self, coverage, max_offsets):
        rng = np.random.default_rng(max_offsets)
        rows = rng.integers(0, 5000, 20000)
        cols = np.clip(rows + rng.integers(-900, 900, 20000), 0, 4999)
        assert dia.choose_offsets(rows, cols, coverage=coverage,
                                  max_offsets=max_offsets) == \
            jdia.choose_offsets(rows, cols, coverage=coverage,
                                max_offsets=max_offsets)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_sell_image_equals_jax_operator(self, dtype):
        """Every nonzero of the JAX pack (offset entries in the slab's
        dtype, remainder and diagonal in f32) sits in the sliced-ELL
        operator once, built from the port's pack and from the JAX
        package's device params alike."""
        ell, coords = grid_system(64, 64, n_far=20)
        jp, tp = _packs(ell, coords, max_offsets=4)
        tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                    else (torch.bfloat16, jnp.bfloat16))
        ref = _jax_image(jp, jdt)
        own = tp.to_device("cpu", dtype=tdt)
        assert own["a_val"].dtype == tdt
        assert (own["b_val"].numel() > 0) == (dtype == "bf16")
        _assert_same_operator(_image(own), ref)
        jparams = jp.to_device(slab_dtype=jdt, slots=8)
        _assert_same_operator(
            _image(convert.dia_params_from_numpy(jp.meta, jparams, "cpu")),
            ref)


def _inputs(r, np_, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((r, np_)).astype(np.float32)


class TestSellMatvec:
    @pytest.mark.parametrize("slots", [0, 8])
    @pytest.mark.parametrize("r", [1, 4])
    def test_f32_matches_jax(self, slots, r):
        ell, coords = grid_system(64, 64, n_far=30)
        jp, tp = _packs(ell, coords, max_offsets=4)
        xt = _inputs(r, jp.np_, seed=r + slots)
        jparams = jp.to_device(slots=slots)
        refs = [np.asarray(jdia.dia_matvec_t(jp.meta, jparams,
                                             jnp.asarray(xt), backend=be))
                for be in ("xla", "interpret")]
        own = tp.to_device("cpu")
        conv = convert.dia_params_from_numpy(jp.meta, jparams, "cpu")
        for params in (own, conv):
            y = dia.dia_matvec_t(tp.meta, params, torch.from_numpy(xt))
            for ref in refs:
                scale = np.abs(ref).max()
                assert np.abs(y.numpy() - ref).max() <= 1e-5 * scale

    @pytest.mark.parametrize("r", [1, 4])
    def test_bf16_matches_jax(self, r):
        ell, coords = grid_laplacian(64, seed=2)
        jp, tp = _packs(ell, coords, max_offsets=4)
        assert len(tp.rem_rows) > 0
        jparams = jp.to_device(slab_dtype=jnp.bfloat16)
        assert jparams["w"].dtype == jnp.bfloat16
        xt = _inputs(r, jp.np_, seed=7)
        ref_xla = np.asarray(jdia.dia_matvec_t(
            jp.meta, dict(jparams, w=jparams["w"].astype(jnp.float32)),
            jnp.asarray(xt), backend="xla"))
        ref_int = np.asarray(jdia.dia_matvec_t(
            jp.meta, jparams, jnp.asarray(xt), backend="interpret"))
        own = tp.to_device("cpu", dtype=torch.bfloat16)
        conv = convert.dia_params_from_numpy(jp.meta, jparams, "cpu")
        assert own["a_val"].dtype == conv["a_val"].dtype == torch.bfloat16
        scale = np.abs(ref_xla).max()
        for params in (own, conv):
            y = dia.dia_matvec_t(tp.meta, params, torch.from_numpy(xt))
            assert np.abs(y.numpy() - ref_xla).max() <= 1e-5 * scale
            assert np.abs(y.numpy() - ref_int).max() <= 1e-2 * scale

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_entries_outside_the_window(self, dtype):
        """Entries beyond part A's int16 window (farther than 2^15
        columns from their row block's first row) go to the int32-column
        part: every entry is stored once, with its value as the dtype
        keeps it (f32 there), and the product matches the operator in
        f64 (1e-5: f32 sums)."""
        rng = np.random.default_rng(5)
        np_ = 600 * dia.ROW_BLOCK
        rows = rng.integers(0, np_, 20000)
        near = np.clip(rows + rng.integers(-300, 301, len(rows)), 0, np_ - 1)
        far = (rows + np_ // 2) % np_
        cols = np.where(rng.random(len(rows)) < 0.1, far, near)
        _, first = np.unique(rows * np_ + cols, return_index=True)
        rows, cols = rows[first], cols[first]
        rows, cols = rows[rows != cols], cols[rows != cols]
        vals = rng.standard_normal(len(rows))
        diag = 4.0 + rng.random(np_)
        params = dia.build_sell(np_, rows, cols, vals, diag, "cpu",
                                dtype=dtype)
        delta = cols - rows // dia.ROW_BLOCK * dia.ROW_BLOCK
        outside = (delta < -2**15) | (delta >= 2**15)
        assert 0 < outside.sum() == int((params["b_val"] != 0).sum())
        v32 = torch.from_numpy(vals).float()
        stored = torch.where(torch.from_numpy(outside), v32,
                             v32.to(dtype).float()).double().numpy()
        a = (scipy.sparse.coo_matrix((stored, (rows, cols)),
                                     shape=(np_, np_))
             + scipy.sparse.diags(diag.astype(np.float32).astype(
                 np.float64))).tocsr()
        _assert_same_operator(_image(params), a)
        xt = _inputs(3, np_, seed=6)
        y = dia.sell_matvec(params, torch.from_numpy(xt)).numpy()
        ref = (a @ xt.T.astype(np.float64)).T
        assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()

    def test_empty_padding_rows(self):
        """Padding rows (no entries, zero diagonal) and whole empty row
        blocks: y is zero there, and the rows with entries match a
        scipy product in f64 (1e-5: f32 sums)."""
        rng = np.random.default_rng(3)
        n, np_ = 300, 640              # rows 300..639 are padding
        rows = rng.integers(0, n, 2000)
        cols = rng.integers(0, n, 2000)
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
        vals = rng.standard_normal(len(rows))
        diag = np.zeros(np_)
        diag[:n] = 4.0 + rng.random(n)
        params = dia.build_sell(np_, rows, cols, vals, diag, "cpu")
        assert int(params["a_ptr"][-1]) % dia.SLICE == 0
        xt = torch.from_numpy(_inputs(2, np_, seed=4))
        y = dia.sell_matvec(params, xt).numpy()
        a = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(np_, np_))
        ref = (a + scipy.sparse.diags(diag)) @ xt.numpy().T.astype(
            np.float64)
        assert np.all(y[:, n:] == 0.0)
        assert np.abs(y - ref.T).max() <= 1e-5 * np.abs(ref).max()

    def test_wrapper_uses_plain_version_on_cpu(self):
        ell, coords = grid_laplacian(48)
        _, tp = _packs(ell, coords)
        params = tp.to_device("cpu")
        xt = torch.from_numpy(_inputs(2, tp.np_, seed=1))
        before = dia.sell_matvec.launches
        y = dia.sell_matvec(params, xt)
        ref = dia.sell_matvec_plain(params, xt)
        assert torch.equal(y, ref)
        assert dia.sell_matvec.launches == before
