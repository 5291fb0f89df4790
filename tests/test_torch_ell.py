"""Port parity for the generic ELL route: the ELL AMG hierarchy (host,
bit-equal), one V-cycle application, and ops.schur.solve_bordered
against the JAX package's on the same systems.

Gates: the hierarchy's arrays equal; the V-cycle within 1e-12 (f64) and
1e-5 (f32, summation order compounded over a few levels) of max|z|;
bordered solves reach the 1e-9 residual gate with max |dV| <= 1e-6 of
the potential scale, in f64 and with f32 inner solves (the JAX
package's device_dtype=float32), including the f64 escalation, the
thin-block branch for more than 256 islands and the host direct route
for wide borders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padne_tpu import kicad as jkicad
from padne_tpu import solver as jsolver
from padne_tpu.ops import amg as jamg
from padne_tpu.ops import assembly as jassembly
from padne_tpu.ops import schur as jschur
from padne_tpu_torch import convert
from padne_tpu_torch.ops import amg, assembly, schur

from tests.test_amg_dia import grid_laplacian
from tests.test_schur_dia import make_system
from tests.test_torch_host import board_project

torch.set_num_threads(1)


def _port_ell(ell):
    return assembly.EllMatrix(cols=ell.cols, vals=ell.vals, diag=ell.diag)


def test_hierarchy_equal():
    ell, _ = grid_laplacian(64, seed=2)
    jh = jamg.build_hierarchy(ell)
    th = amg.build_hierarchy(_port_ell(ell))
    assert th.num_levels == jh.num_levels >= 3
    for jl, tl in zip(jh.levels, th.levels):
        for name in ("a_cols", "a_vals", "a_diag", "p_cols", "p_vals",
                     "r_cols", "r_vals"):
            a, b = getattr(tl, name), getattr(jl, name)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
        assert tl.omega == jl.omega
    np.testing.assert_array_equal(th.coarse_inv, jh.coarse_inv)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
def test_vcycle_matches_jax(dtype, rtol):
    ell, _ = grid_laplacian(64, seed=3)
    h = amg.build_hierarchy(_port_ell(ell))
    japply, jparams = jamg.make_vcycle(
        jamg.build_hierarchy(ell),
        dtype=None if dtype == np.float64 else jnp.float32)
    apply, params = amg.vcycle_as(
        amg.make_vcycle(h, "cpu"), torch.from_numpy(np.zeros(1, dtype)).dtype)
    r = np.random.default_rng(4).standard_normal((len(ell.diag), 3)).astype(
        dtype)
    z_ref = np.asarray(japply(jparams, jnp.asarray(r)))
    z = apply(params, torch.from_numpy(r)).numpy()
    assert z.dtype == dtype
    assert np.abs(z - z_ref).max() <= rtol * np.abs(z_ref).max()


def test_vcycle_shares_level0_and_checks_transfers():
    """make_vcycle reuses the level-0 operator passed as a0 (same result
    as its own upload) and refuses transfer columns past the level they
    read, which K3' would gather unchecked on the card."""
    import dataclasses

    ell, _ = grid_laplacian(32, seed=5)
    tell = _port_ell(ell)
    h = amg.build_hierarchy(tell)
    a0 = tell.to_device("cpu")
    apply, own = amg.make_vcycle(h, "cpu")
    _, shared = amg.make_vcycle(h, "cpu", a0=a0)
    assert shared[0]["a"] is a0 and own[0]["a"] is not a0
    r = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (len(ell.diag), 2)))
    np.testing.assert_array_equal(apply(shared, r).numpy(),
                                  apply(own, r).numpy())
    # vcycle_as: the f32 cycle reads the f64 cycle's index arrays, and
    # the f64 "cast" is the cycle itself.
    _, cast = amg.vcycle_as((apply, own), torch.float32)
    assert cast[0]["p"].col is own[0]["p"].col
    assert cast[0]["a"].val.dtype == cast[0]["w"].dtype \
        == cast[-1]["coarse_inv"].dtype == torch.float32
    assert amg.vcycle_as((apply, own), torch.float64)[1][0]["a"] is own[0]["a"]
    bad = h.levels[0].p_cols.copy()
    bad[0, 0] = len(h.levels[1].a_diag)
    h.levels[0] = dataclasses.replace(h.levels[0], p_cols=bad)
    with pytest.raises(ValueError, match="out of range"):
        amg.make_vcycle(h, "cpu")


def _compare(jsystem, inner, stats_route="ell", **kw):
    """Port vs JAX solve_bordered on one system; returns the port's
    stats."""
    ref = jschur.solve_bordered(
        jsystem, device_dtype=None if inner is None else jnp.float32, **kw)
    stats = {}
    got = schur.solve_bordered(
        convert.core_system_from_numpy(jsystem), inner_dtype=inner,
        device="cpu", stats=stats, **kw)
    assert stats["route"] == stats_route
    assert ref.residual_norm < 1e-9 and got.residual_norm < 1e-9
    scale = max(np.abs(ref.v).max(), 1e-12)
    assert np.abs(got.v - ref.v).max() <= 1e-6 * scale
    assert np.abs(got.j - ref.j).max() <= 1e-6 * max(np.abs(ref.j).max(),
                                                     1e-12)
    return stats


@pytest.mark.parametrize("inner", [None, torch.float32])
@pytest.mark.parametrize("with_regulator", [False, True])
def test_solve_bordered_matches_jax(with_regulator, inner):
    """g = 80: n = 6400, AMG-preconditioned (a 3-level hierarchy)."""
    jsystem = make_system(g=80, with_regulator=with_regulator, seed=3)
    stats = _compare(jsystem, inner, operator="ell")
    assert len(stats["levels"]) >= 3 and not stats["escalated"]


def test_escalation_to_f64(tmp_path):
    """gen_resistor_divider's 100 R lump next to thin-trace cotan weights
    stalls the f32 inner solve: both packages escalate to f64."""
    pro = board_project(tmp_path, "gen_resistor_divider")
    jsystem, *_ = jsolver.build_system(jkicad.load_kicad_project(pro))
    stats = _compare(jsystem, torch.float32)
    assert stats["escalated"]


def _islands(num, side=3, seed=0):
    """`num` disjoint side x side grid islands.  A 0.2 A source drives
    current from island 1 into island 0, a 1 V source returns it from
    island 0 to island 1, the ground sits on island 1; the rest float.
    Every border current is fixed by per-island current balance, which
    the thin-block branch solves first."""
    rng = np.random.default_rng(seed)
    per = side * side
    idx = np.arange(per).reshape(side, side)
    e0 = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)])
    edges = np.concatenate([e0 + i * per for i in range(num)])
    w = 0.5 + rng.random(len(edges))
    n = num * per
    ell = jassembly.build_ell(n, edges, w)
    comp_id, p = jassembly.connected_components(n, edges, w)
    a, b = 0, 2 * per - 1
    border = jschur.BorderSpec(
        m=2, row_idx=np.array([0, 0, 1]), row_node=np.array([a, b, b]),
        row_val=np.array([1.0, -1.0, 1.0]), col_idx=np.array([0, 0, 1]),
        col_node=np.array([a, b, b]), col_val=np.array([1.0, -1.0, 1.0]),
        rhs=np.array([1.0, 0.0]))
    r_core = np.zeros(n)
    r_core[per - 1], r_core[per] = 0.2, -0.2
    return jschur.CoreSystem(n=n, ell=ell, comp_id=comp_id,
                             num_components=p, border=border,
                             r_core=r_core, ground_var=1)


def test_many_islands_thin_block():
    """300 islands: p > 256 takes the thin-block lstsq branch and the
    segment-sum projector."""
    jsystem = _islands(300)
    assert jsystem.num_components == 300
    _compare(jsystem, None)


def test_wide_border_direct_route():
    """n <= 50k with m > 16 border variables touching every component
    goes to the host direct solve in both packages."""
    jsystem = make_system(g=30, seed=5)
    b = jsystem.border
    rng = np.random.default_rng(6)
    m, extra = b.m, 16                  # 16 more sources: m = 18
    ks = np.repeat(np.arange(m, m + extra), 2)
    nodes = np.concatenate([rng.choice(jsystem.n, 2, replace=False)
                            for _ in range(extra)])
    signs = np.tile([1.0, -1.0], extra)
    jsystem.border = jschur.BorderSpec(
        m=m + extra, row_idx=np.concatenate([b.row_idx, ks]),
        row_node=np.concatenate([b.row_node, nodes]),
        row_val=np.concatenate([b.row_val, signs]),
        col_idx=np.concatenate([b.col_idx, ks]),
        col_node=np.concatenate([b.col_node, nodes]),
        col_val=np.concatenate([b.col_val, signs]),
        rhs=np.concatenate([b.rhs, rng.uniform(0.1, 1.0, extra)]))
    stats = _compare(jsystem, torch.float32, stats_route="direct")
    assert stats["levels"] == []
