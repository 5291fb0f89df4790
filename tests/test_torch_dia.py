"""Port parity for ops.dia: host packing and kernel K1's plain version.

The same seeded inputs go through padne_tpu.ops.dia (the reference) and
padne_tpu_torch.ops.dia.  Host packing must be bit-identical; the slab
SpMV is held against the JAX `xla` backend and the Pallas kernel in
interpret mode.

Tolerances (relative to max|y|):
* f32 slabs: 1e-5 against both — only the f32 summation order differs;
* bf16 slabs: 1e-5 against `xla` fed f32 x (the same widen-W-to-f32
  contraction), 1e-2 against `interpret`, because the Pallas kernel
  also rounds x to bf16 (an MXU input format, not part of the math).
"""

import numpy as np
import pytest
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


CASES = {
    "grid_far": lambda: grid_system(96, 96, n_far=40),
    "laplacian": lambda: grid_laplacian(64, seed=2),
}


class TestHostPacking:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("max_offsets", [2, 4])
    def test_pack_and_slots_equal(self, case, max_offsets):
        ell, coords = CASES[case]()
        jp, tp = _packs(ell, coords, max_offsets=max_offsets, coverage=0.9)
        _assert_pack_equal(jp, tp)
        assert len(tp.rem_rows) > 0
        je = jdia.pack_extra_slots(jp, e_max=4)
        te = dia.pack_extra_slots(tp, e_max=4)
        for name in ("tgt", "idx", "cls", "vals", "tail_rows", "tail_cols",
                     "tail_vals"):
            np.testing.assert_array_equal(getattr(je, name),
                                          getattr(te, name), err_msg=name)
        # The host slot tables equal the JAX device-built ones.
        wslot, cslot = dia._build_slot_tables(te)
        jw, jc = jdia._build_slot_tables(je.idx, je.vals, je.cls,
                                         nb=je.nb, e=je.e, b=je.b)
        np.testing.assert_array_equal(np.asarray(jw), wslot)
        np.testing.assert_array_equal(np.asarray(jc), cslot)

    @pytest.mark.parametrize("coverage,max_offsets", [(0.95, 8), (0.5, 2)])
    def test_choose_offsets_equal(self, coverage, max_offsets):
        rng = np.random.default_rng(max_offsets)
        rows = rng.integers(0, 5000, 20000)
        cols = np.clip(rows + rng.integers(-900, 900, 20000), 0, 4999)
        assert dia.choose_offsets(rows, cols, coverage=coverage,
                                  max_offsets=max_offsets) == \
            jdia.choose_offsets(rows, cols, coverage=coverage,
                                max_offsets=max_offsets)

    def test_slab_scatter_equals_jax(self):
        ell, coords = grid_system(64, 64, n_far=20)
        jp, tp = _packs(ell, coords, max_offsets=4)
        w_j = np.asarray(jp.to_device()["w"])
        w_t = dia.build_slab(tp, torch.float32, "cpu").numpy()
        np.testing.assert_array_equal(w_j, w_t)


def _inputs(r, np_, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((r, np_)).astype(np.float32)


class TestSlabMatvec:
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
        own = tp.to_device("cpu", slots=slots)
        conv = convert.dia_params_from_numpy(jparams, "cpu")
        assert ("xs_tgt" in own) == bool(slots) == ("xs_tgt" in conv)
        for params in (own, conv):
            y = dia.dia_matvec_t(tp.meta, params, torch.from_numpy(xt))
            for ref in refs:
                scale = np.abs(ref).max()
                assert np.abs(y.numpy() - ref).max() <= 1e-5 * scale

    @pytest.mark.parametrize("r", [1, 4])
    def test_bf16_slab_matches_jax(self, r):
        ell, coords = grid_laplacian(64, seed=2)
        jp, tp = _packs(ell, coords, max_offsets=4)
        jparams = jp.to_device(slab_dtype=jnp.bfloat16)
        jw = jparams["w"]
        assert jw.dtype == jnp.bfloat16
        xt = _inputs(r, jp.np_, seed=7)
        dmax = jdia._dmax(jp.offs)
        xt_pad = jnp.pad(jnp.asarray(xt), ((0, 0), (dmax * 128,) * 2))
        ref_xla = np.asarray(jdia._run_main("xla", jp.meta, jw, xt_pad))
        ref_int = np.asarray(jdia._run_main("interpret", jp.meta, jw, xt_pad))
        w = convert.dia_params_from_numpy(jparams, "cpu")["w"]
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            w.float().numpy(),
            dia.build_slab(tp, torch.bfloat16, "cpu").float().numpy())
        y = dia.slab_matvec(tp.meta, w, torch.from_numpy(xt)).numpy()
        scale = np.abs(ref_xla).max()
        assert np.abs(y - ref_xla).max() <= 1e-5 * scale
        assert np.abs(y - ref_int).max() <= 1e-2 * scale

    def test_wrapper_uses_plain_version_on_cpu(self):
        ell, coords = grid_laplacian(48)
        _, tp = _packs(ell, coords)
        params = tp.to_device("cpu", slots=4)
        xt = torch.from_numpy(_inputs(2, tp.np_, seed=1))
        before = dia.slab_matvec.launches
        y = dia.slab_matvec(tp.meta, params["w"], xt, dia._slots(params))
        ref = dia.slab_matvec_plain(tp.meta, params["w"], xt,
                                    dia._slots(params))
        assert torch.equal(y, ref)
        assert dia.slab_matvec.launches == before
