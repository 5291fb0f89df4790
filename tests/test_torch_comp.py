"""Port parity for ops.comp: the compensated residual (the plain
version of K2' over the sliced-ELL operator's hi and lo values and its
f64 diagonal).

Held against scipy in f64 and against the JAX slab mode run through the
Pallas interpreter, at both conductance scales of the JAX package's own
test (1 and the production ~2e3 S, where row sums cancel), with the
bound 2e-13 * max(|A| |x|) — the f64-class accuracy the refinement
ladder relies on.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padne_tpu.ops import comp as jcomp
from padne_tpu.ops import dia as jdia
from padne_tpu_torch.ops import comp, dia

from tests.test_dia_sharded import grid_system

torch.set_num_threads(1)


@pytest.mark.parametrize("scale", [1.0, 2081.0 * np.pi / 3.0])
def test_matvec_slab_matches_f64(scale):
    ell, _ = grid_system(64, 64, n_far=30)
    a = ell.to_scipy() * scale
    jp = jdia.pack_csr_as_dia(a, coverage=0.9, max_offsets=4)
    tp = dia.pack_csr_as_dia(a, coverage=0.9, max_offsets=4)
    assert len(tp.rem_rows) > 0
    n = a.shape[0]
    rng = np.random.default_rng(2)
    x32 = (rng.standard_normal(n).astype(np.float32)
           + np.linspace(0, 3.3, n).astype(np.float32))
    x_pad = np.zeros(tp.np_, np.float32)
    x_pad[:n] = x32

    params = tp.to_device("cpu", compensated=True)
    y = comp.comp_sell(params, torch.from_numpy(x_pad)).numpy()

    jparams = jp.to_device(keep_widx=True)
    jop = jcomp.build_slab_mode(jp.meta, jparams, jp, interpret=True)
    y_jax = np.asarray(jcomp.matvec_slab(jop, jop.params,
                                         jnp.asarray(x_pad), jp.meta))
    ref = a @ x32.astype(np.float64)
    bound = 2e-13 * (abs(a) @ np.abs(x32.astype(np.float64))).max()
    assert np.abs(y[:n] - ref).max() < bound
    assert np.abs(y[:n] - y_jax[:n]).max() < bound


def test_beats_plain_f32():
    """The compensated result must be orders of magnitude closer to f64
    than a plain f32 matvec of the same operator."""
    ell, _ = grid_system(48, 48, n_far=10)
    a = ell.to_scipy() * (2081.0 * np.pi / 3.0)
    tp = dia.pack_csr_as_dia(a, max_offsets=4)
    params = tp.to_device("cpu", compensated=True)
    n = a.shape[0]
    x_pad = np.zeros(tp.np_, np.float32)
    x_pad[:n] = np.linspace(0.0, 3.3, n).astype(np.float32)
    xt = torch.from_numpy(x_pad)
    y = comp.comp_sell(params, xt).numpy()[:n]
    y32 = dia.dia_matvec_t(tp.meta, params, xt[None])[0].numpy()[:n]
    ref = a @ x_pad[:n].astype(np.float64)
    assert np.abs(y - ref).max() < np.abs(y32 - ref).max() / 100.0


def test_wrapper_uses_plain_version_on_cpu():
    ell, _ = grid_system(32, 32)
    tp = dia.pack_csr_as_dia(ell.to_scipy())
    prm = tp.to_device("cpu", compensated=True)
    x = torch.linspace(0, 1, tp.np_, dtype=torch.float32)
    before = comp.comp_sell.launches
    assert torch.equal(comp.comp_sell(prm, x), comp.comp_sell_plain(prm, x))
    assert comp.comp_sell.launches == before


def test_needs_the_compensated_build():
    ell, _ = grid_system(32, 32)
    tp = dia.pack_csr_as_dia(ell.to_scipy())
    x = torch.zeros(tp.np_, dtype=torch.float32)
    with pytest.raises(ValueError):
        comp.comp_sell(tp.to_device("cpu"), x)
    with pytest.raises(ValueError):
        tp.to_device("cpu", dtype=torch.bfloat16, compensated=True)
