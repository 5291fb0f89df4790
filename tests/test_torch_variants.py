"""Port parity for the solver options the JAX package selects by its
PADNE_TPU_* knobs and solve_bordered's arguments: each is an argument of
the port with the JAX default, held here against the JAX function run
with the knob set (monkeypatch.setenv) or the argument passed.

Gates:

* cycle variants (cheb, cheb_deep, smooth_steps, cycle_lumped,
  lump_smoothing) x w_levels in {0, 3}: one f32 application within
  1e-4 of max|z| (as tests/test_torch_amg.py: f32 sums in another
  order) on a grid whose lumping folds entries, and y^T M z = z^T M y
  within 1e-5 relative (CG needs an SPD preconditioner) on a grid whose
  lumping folds none: where it folds, the lumped level-0 operator is
  itself not symmetric (weak entries at an offset outside the chosen
  set fold, their transposes at the mirrored offset inside it stay), in
  the JAX package as in the port, and no variant can repair that;
* hierarchy knobs and coarse_eigh: the kwargs that reach
  build_hierarchy_dia equal the JAX package's, the hierarchies
  bit-equal;
* the coarse inverse built on the device: as an operator on deflated
  residuals within 5e-3 of the scale of the JAX package's, padding rows
  exactly 0, the same validation verdict;
* solve_bordered's precond, amg_threshold, dia_threshold, dia_shard_min
  and direct_small: the same route, potentials within 1e-9 V;
* one DiaBorderedSolver solve per variant: residual below 1e-10 and
  potentials within 1e-6 V of scipy's spsolve, and (marked slow: the
  JAX solver compiles for ~12 s per variant) within 1e-6 V of the JAX
  solver with the same knob.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from jax.sharding import Mesh as JMesh

from padne_tpu.ops import amg as jamg, assembly as jassembly
from padne_tpu.ops import schur as jschur
from padne_tpu_torch import convert
from padne_tpu_torch.ops import amg, schur
from padne_tpu_torch.parallel import sharding

from tests.test_amg_dia import grid_laplacian
from tests.test_schur_dia import make_system

torch.set_num_threads(1)

COARSE = 200   # coarse_size of the hierarchy-knob and TF32 checks


def weak_grid(g, seed=0):
    """A triangulated g x g grid whose edge weights spread over three
    decades, so that level 0's remainder holds weak entries that the
    cycle's lumping folds (a board's thin slivers do the same): (JAX
    EllMatrix, coordinates)."""
    idx = np.arange(g * g).reshape(g, g)
    e = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
        np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)])
    w = 10.0 ** np.random.default_rng(seed).uniform(-3.0, 0.0, len(e))
    xs, ys = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel()], 1).astype(float)
    return jassembly.build_ell(g * g, e.astype(np.int64), w), coords


def weak_system(g=64, m_sources=1, seed=0):
    """weak_grid with `m_sources` voltage sources of 1 V and up between
    node pairs across the grid, a current load and the ground pin, two
    mesh groups (the halves), as a JAX CoreSystem."""
    ell, coords = weak_grid(g, seed)
    n = g * g
    rng = np.random.default_rng(seed + 1)
    pairs = [(0, n - 1)] + [tuple(rng.choice(n, 2, replace=False))
                            for _ in range(m_sources - 1)]
    row, col = [], []
    for k, (a, b) in enumerate(pairs):
        row += [(k, a, 1.0), (k, b, -1.0)]
        col += [(k, a, 1.0), (k, b, -1.0)]
    k = len(pairs)
    row.append((k, n - 1, 1.0))
    col.append((k, n - 1, 1.0))
    border = jschur.BorderSpec(
        m=k + 1,
        row_idx=np.array([r[0] for r in row], dtype=np.int64),
        row_node=np.array([r[1] for r in row], dtype=np.int64),
        row_val=np.array([r[2] for r in row]),
        col_idx=np.array([c[0] for c in col], dtype=np.int64),
        col_node=np.array([c[1] for c in col], dtype=np.int64),
        col_val=np.array([c[2] for c in col]),
        rhs=np.concatenate([1.0 + np.arange(len(pairs)), [0.0]]))
    r_core = np.zeros(n)
    r_core[5], r_core[n - 6] = 0.1, -0.1
    return jschur.CoreSystem(
        n=n, ell=ell, comp_id=np.zeros(n, dtype=np.int64),
        num_components=1, border=border, r_core=r_core, ground_var=k,
        coords=coords, group=(coords[:, 0] >= g // 2).astype(np.int32))


def assert_same_hierarchy(jh, th):
    assert len(th.levels) == len(jh.levels) >= 2
    np.testing.assert_array_equal(th.posmap0, jh.posmap0)
    assert th.np0 == jh.np0
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.pack.meta == jl.pack.meta
        for name in ("widx_hi", "widx_lo", "wval", "rem_rows", "rem_cols",
                     "rem_vals", "diag"):
            np.testing.assert_array_equal(getattr(tl.pack, name),
                                          getattr(jl.pack, name))
        np.testing.assert_array_equal(tl.dinv, jl.dinv)
        np.testing.assert_array_equal(tl.child_perm, jl.child_perm)
        assert (tl.omega_p, tl.omega_s, tl.cap, tl.child_len, tl.lam) == (
            jl.omega_p, jl.omega_s, jl.cap, jl.child_len, jl.lam)
    np.testing.assert_array_equal(th.coarse_inv, jh.coarse_inv)


# -- rows 5-8: the cycle's variants -----------------------------------------

# (port arguments, JAX environment, JAX make_vcycle_dia_t arguments)
CYCLES = {
    "cheb3": ({"cheb": 3}, {"PADNE_TPU_CHEB": "3"}, {}),
    "cheb_deep3": ({"cheb_deep": 3}, {"PADNE_TPU_CHEB_DEEP": "3"}, {}),
    "steps2": ({"smooth_steps": 2}, {"PADNE_TPU_SMOOTH_STEPS": "2"}, {}),
    "exact_l0": ({"cycle_lumped": False},
                 {"PADNE_TPU_CYCLE_LUMPED": "0"}, {}),
    "no_lumping": ({"lump_smoothing": False}, {},
                   {"lump_smoothing": False}),
    "mixed": ({"cycle_lumped": False, "smooth_steps": 3, "cheb_deep": 2},
              {"PADNE_TPU_CYCLE_LUMPED": "0", "PADNE_TPU_SMOOTH_STEPS": "3",
               "PADNE_TPU_CHEB_DEEP": "2"}, {}),
}


@pytest.fixture(scope="module")
def cycle_hierarchies():
    """The weak grid's hierarchy from both packages, its JAX CG operator
    (whose weights the JAX cycle's level 0 shares), and the port's
    hierarchy of a grid whose lumping folds nothing."""
    kw = dict(coarse_size=64, max_offsets=4)
    ell, coords = weak_grid(64, seed=1)
    jh = jamg.build_hierarchy_dia(ell, coords, **kw)
    th = amg.build_hierarchy_dia(ell, coords, **kw)
    plain = amg.build_hierarchy_dia(*grid_laplacian(64, seed=1), **kw)
    for h in (th, plain):
        assert len(h.levels) >= 3   # the W-cycle doubles levels 2..3
    folds = [amg._lumped_level0(h.levels[0].pack, 0.05)[0]
             is not h.levels[0].pack for h in (th, plain)]
    assert folds == [True, False]
    return jh, th, jamg.make_dia_cg_operator(jh, slots=8), plain


@pytest.mark.parametrize("w_levels", [0, 3])
@pytest.mark.parametrize("variant", list(CYCLES))
def test_cycle_variant_matches_jax(variant, w_levels, cycle_hierarchies,
                                   monkeypatch):
    port_kw, env, jax_kw = CYCLES[variant]
    monkeypatch.setenv("PADNE_TPU_WCYCLE", str(w_levels))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jh, th, jop, plain = cycle_hierarchies
    japply, jparams = jamg.make_vcycle_dia_t(jh, backend="xla",
                                             w0=jop["w"], **jax_kw)
    apply_t, params = amg.make_vcycle_dia_t(th, "cpu", w_levels=w_levels,
                                            **port_kw)
    assert ("sm" in params[0]) == (variant in ("exact_l0", "mixed"))

    rng = np.random.default_rng(5)
    rt = rng.standard_normal((3, th.np0)).astype(np.float32)
    z_ref = np.asarray(japply(jparams, jnp.asarray(rt)))
    z = apply_t(params, torch.from_numpy(rt)).numpy()
    assert np.abs(z - z_ref).max() <= 1e-4 * np.abs(z_ref).max()
    # Symmetric: y^T M z = z^T M y (the padding rows carry zeros).
    apply_t, params = amg.make_vcycle_dia_t(plain, "cpu", w_levels=w_levels,
                                            **port_kw)
    yz = rng.standard_normal((2, plain.np0)).astype(np.float32)
    yz[:, np.setdiff1d(np.arange(plain.np0), plain.posmap0)] = 0.0
    m = apply_t(params, torch.from_numpy(yz)).double().numpy()
    a, b = yz[0] @ m[1], yz[1] @ m[0]
    assert abs(a - b) <= 1e-5 * abs(a)


def test_cycle_arguments_are_checked(cycle_hierarchies):
    th = cycle_hierarchies[1]
    for kw in ({"smooth_steps": 0}, {"cheb": -1}, {"coarse": "gpu"}):
        with pytest.raises(ValueError):
            amg.make_vcycle_dia_t(th, "cpu", **kw)


# -- rows 3-4: the hierarchy's knobs ----------------------------------------

# (port argument, JAX environment, the build_hierarchy_dia kwarg it sets)
KNOBS = {
    "defaults": ({}, {}),
    "no_group": ({"group": False}, {"PADNE_TPU_NO_GROUP": "1"}),
    "deep_offsets": ({"deep_max_offsets": 8},
                     {"PADNE_TPU_DEEP_OFFSETS": "8"}),
    "deep_coverage": ({"deep_coverage": 0.9},
                      {"PADNE_TPU_DEEP_COVERAGE": "0.9"}),
    "drop_tol": ({"drop_tol": 0.01}, {"PADNE_TPU_DROP_TOL": "0.01"}),
    "l0_coverage": ({"coverage": 0.9}, {"PADNE_TPU_L0_COVERAGE": "0.9"}),
    "cap": ({"cap": 4}, {"PADNE_TPU_CAP": "4"}),
    "theta": ({"theta": 0.2}, {"PADNE_TPU_THETA": "0.2"}),
    "smooth_levels": ({"smooth_levels": 1},
                      {"PADNE_TPU_SMOOTH_LEVELS": "1"}),
    "coarse_eigh": ({"coarse_eigh": True}, {"PADNE_TPU_COARSE_EIGH": "1"}),
}
HIERARCHY_KW = ("coverage", "deep_max_offsets", "deep_coverage", "drop_tol",
                "cap", "theta", "smooth_levels", "max_offsets",
                "coarse_size")


class _Built(Exception):
    pass


def _build_call(module, monkeypatch, make):
    """The (args, kwargs) with which `make()` (a DiaBorderedSolver of
    either package) calls module.build_hierarchy_dia; stops it there."""
    seen = []

    def stop(*args, **kwargs):
        seen.append((args, kwargs))
        raise _Built

    with monkeypatch.context() as mp:
        mp.setattr(module, "build_hierarchy_dia", stop)
        with pytest.raises(_Built):
            make()
    return seen[0]


@pytest.fixture(scope="module")
def knob_systems():
    jsys = weak_system(48, seed=2)
    return jsys, convert.core_system_from_numpy(jsys)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_hierarchy_knob_matches_jax(knob, knob_systems, monkeypatch):
    port_kw, env = KNOBS[knob]
    jsys, system = knob_systems
    monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", str(COARSE))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jargs, jkw = _build_call(jamg, monkeypatch,
                             lambda: jschur.DiaBorderedSolver(jsys))
    targs, tkw = _build_call(amg, monkeypatch, lambda: schur.
                             DiaBorderedSolver(system, device="cpu",
                                               coarse_size=COARSE, **port_kw))
    # Unset knobs reach neither build: its own defaults hold.
    assert ({k: v for k, v in jkw.items() if k in HIERARCHY_KW}
            == {k: v for k, v in tkw.items() if k in HIERARCHY_KW})
    assert (jkw["group"] is None) == (tkw["group"] is None) == (
        knob == "no_group")
    assert tkw["coarse_eigh"] == (knob == "coarse_eigh")
    jh = jamg.build_hierarchy_dia(*jargs, **jkw)
    th = amg.build_hierarchy_dia(*targs, **tkw)
    jh.coarse_inv   # computed while the knob is set  # noqa: B018
    assert_same_hierarchy(jh, th)


# -- row 9: the coarse inverse built on the device ---------------------------


def _two_paths():
    """Two path Laplacians joined by a 1e-9 coupling: one component with
    a near-null mode that is not structural (test_amg_dia's junk case)."""
    def path(k):
        main = np.full(k, 2.0)
        main[[0, -1]] = 1.0
        return scipy.sparse.diags([main, -np.ones(k - 1), -np.ones(k - 1)],
                                  [0, 1, -1])

    a = scipy.sparse.block_diag([path(80), path(80)]).tolil()
    a[79, 80] = a[80, 79] = -1e-9
    a[79, 79] += 1e-9
    a[80, 80] += 1e-9
    return a.tocsr()


def _bottoms(case):
    """(JAX hierarchy, port hierarchy) with the same bottom operator."""
    if case == "junk":
        a = _two_paths()
        nl, npl = a.shape[0], 256

        def host():
            ci = np.zeros((npl, npl), np.float32)
            ci[:nl, :nl] = amg._coarse_inv_dense(a, a.toarray())
            return ci

        kw = dict(levels=[], posmap0=np.arange(nl), np0=npl, coarse_sp=a,
                  coarse_nL=nl, coarse_npL=npl)
        return (jamg.AlignedHierarchy(**kw),
                amg.AlignedHierarchy(_coarse=host, **kw))
    g, seed, coarse = {"g40": (40, 3, 120), "g32": (32, 1, 80)}[case]
    ell, coords = grid_laplacian(g, seed=seed)
    return (jamg.build_hierarchy_dia(ell, coords, coarse_size=coarse),
            amg.build_hierarchy_dia(ell, coords, coarse_size=coarse))


@pytest.mark.parametrize("case", ["g40", "g32", "junk"])
def test_device_coarse_inverse_matches_jax(case, caplog):
    import scipy.sparse.csgraph as csgraph

    jh, th = _bottoms(case)
    assert th.coarse_nL == jh.coarse_nL and th.coarse_npL == jh.coarse_npL
    ref = jamg._device_coarse_inv(jh)
    inv, why = amg._coarse_inv_on_device(th, "cpu")
    assert (inv is None) == (ref is None) == (case == "junk")
    if case == "junk":
        assert "junk" in why or "Newton-Schulz" in why
        with caplog.at_level(logging.INFO, logger=amg.__name__):
            got, route = amg._coarse_inv_device(th, "cpu", "device")
        assert route == "host (validation)" and why in caplog.text
        host = torch.from_numpy(th.coarse_inv).to(torch.bfloat16).float()
        assert torch.equal(got, host)
        return
    nl = th.coarse_nL
    _, labels = csgraph.connected_components(th.coarse_sp, directed=False)
    r = np.zeros(th.coarse_npL, np.float32)
    r[:nl] = np.random.default_rng(0).normal(size=nl)
    for c in np.unique(labels):
        r[:nl][labels == c] -= r[:nl][labels == c].mean()
    y_ref = np.asarray(ref @ jnp.asarray(r))
    y = (inv @ torch.from_numpy(r)).numpy()
    assert np.abs(y - y_ref).max() < 5e-3 * np.abs(y_ref).max()
    assert np.abs(inv.numpy()[nl:]).max() == 0.0
    assert np.abs(inv.numpy()[:, nl:]).max() == 0.0
    got, route = amg._coarse_inv_device(th, "cpu", "device")
    assert route == "device" and torch.equal(got, inv)
    assert callable(th._coarse)   # the host inverse was never computed


def test_device_coarse_inverse_needs_true_f32(cycle_hierarchies):
    th = cycle_hierarchies[1]
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            amg._coarse_inv_on_device(th, "cpu")
        # The solver's set-up resolves its device, which turns TF32 off.
        s = schur.DiaBorderedSolver(
            convert.core_system_from_numpy(weak_system(32)), device="cpu",
            coarse_size=COARSE, coarse="device")
        assert s.coarse == "device"
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# -- rows 1-2: solve_bordered's routing arguments ---------------------------

# (makes the system, port arguments, JAX arguments, JAX environment, route)
ROUTES = {
    "jacobi_above_threshold": (
        lambda: make_system(g=72, seed=3), {"precond": "jacobi"},
        {"precond": "jacobi"}, {}, "ell"),
    "amg_below_threshold": (
        lambda: weak_system(40, seed=4), {"precond": "amg"},
        {"precond": "amg"}, {}, "ell"),
    "amg_threshold": (
        lambda: weak_system(40, seed=4), {"amg_threshold": 1000},
        {"amg_threshold": 1000}, {}, "ell"),
    "dia_threshold": (
        lambda: weak_system(64, seed=5),
        {"dia_threshold": 4000, "inner_dtype": torch.float32},
        {"dia_threshold": 4000, "device_dtype": jnp.float32}, {}, "dia"),
    "direct_small_off": (
        lambda: weak_system(40, m_sources=18, seed=6),
        {"direct_small": False}, {}, {"PADNE_TPU_DIRECT_SMALL": "0"}, "ell"),
    "direct_small_on": (
        lambda: weak_system(40, m_sources=18, seed=6), {}, {}, {},
        "direct"),
}


@pytest.mark.parametrize("case", [
    pytest.param(case, marks=[pytest.mark.slow] if case == "dia_threshold"
                 else []) for case in ROUTES])
def test_solve_bordered_arguments_match_jax(case, monkeypatch):
    make, port_kw, jax_kw, env, route = ROUTES[case]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jsys = make()
    want = jschur.solve_bordered(jsys, **jax_kw)
    stats = {}
    got = schur.solve_bordered(convert.core_system_from_numpy(jsys),
                               device="cpu", stats=stats, **port_kw)
    assert stats["route"] == route
    if route == "ell":
        assert bool(stats["levels"]) == (case != "jacobi_above_threshold"
                                         and case != "direct_small_off")
    assert got.residual_norm < 1e-9 and want.residual_norm < 1e-9
    assert np.abs(got.v - want.v).max() < 1e-9
    # Not equal: the f64 CG's stopping test reads a norm summed in
    # another order, which may land on the other side of the tolerance
    # (800 against 799 Jacobi iterations); the DIA route's f32 sums
    # differ more (within 3, as tests/test_torch_schur.py).
    slack = 3 if route == "dia" else 1
    assert abs(got.cg_iterations - want.cg_iterations) <= slack


def test_dia_routing_arguments():
    """dia_threshold sends a 4,096-unknown mixed-precision solve to the
    DIA route; dia_shard_min=512 shards its level of 4,096 rows over 4
    devices, which the default 32,768 leaves on one, and the sharded
    solve matches the one-device one; a cycle variant that the sharded
    cycle has not raises there.  (Against the JAX package: the slow
    tests below.)"""
    system = convert.core_system_from_numpy(weak_system(64, seed=7))
    kw = dict(inner_dtype=torch.float32, device="cpu")
    stats = {}
    serial = schur.solve_bordered(system, dia_threshold=4000, stats=stats,
                                  **kw)
    assert stats["route"] == "dia" and stats["coarse"] == "host"
    schur.solve_bordered(system, stats=stats, **kw)
    assert stats["route"] == "ell"
    mesh = sharding.Mesh(["cpu"] * 4)
    for shard_min, sharded in ((32768, False), (512, True)):
        got = schur.solve_bordered(system, operator="dia", mesh=mesh,
                                   dia_shard_min=shard_min, stats=stats,
                                   **kw)
        assert stats["route"] == "dia" and stats["sharded"] == sharded
        assert got.residual_norm < 1e-9
        assert np.abs(got.v - serial.v).max() < 1e-9
    with pytest.raises(ValueError, match="sharded cycle"):
        schur.DiaBorderedSolver(system, mesh=mesh, shard_min=512, cheb=3,
                                device="cpu")


@pytest.mark.slow
def test_dia_shard_min_matches_jax():
    """dia_shard_min=512 shards a level of 4,096 rows over 4 devices,
    which the default 32,768 leaves on one; the potentials against the
    JAX function on its virtual CPU devices.  The iterations are held
    against the port's own one-device solve (as in
    tests/test_torch_sharded.py), not the JAX package's: its sharded
    cycle runs level 0 on the exact operator, the port's on the lumped
    one as its one-device cycle does, and on this grid, whose lumping
    folds entries, the JAX solve takes 36 iterations and 2 passes, the
    port's 52 and 3."""
    jsys = weak_system(64, seed=7)
    jmesh = JMesh(np.asarray(jax.devices()[:4]), axis_names=("tp",))
    want = jschur.solve_bordered(jsys, operator="dia",
                                 device_dtype=jnp.float32, mesh=jmesh,
                                 dia_shard_min=512)
    system = convert.core_system_from_numpy(jsys)
    mesh = sharding.Mesh(["cpu"] * 4)
    kw = dict(operator="dia", inner_dtype=torch.float32, device="cpu",
              mesh=mesh)
    stats = {}
    got = schur.solve_bordered(system, dia_shard_min=512, stats=stats, **kw)
    assert stats["route"] == "dia" and stats["sharded"]
    default = {}
    serial = schur.solve_bordered(system, stats=default, **kw)
    assert not default["sharded"]
    assert got.residual_norm < 1e-9
    assert np.abs(got.v - want.v).max() < 1e-9
    assert abs(got.cg_iterations - serial.cg_iterations) <= max(
        1, 0.1 * serial.cg_iterations)


# -- one DiaBorderedSolver solve per variant ---------------------------------

# (port arguments, JAX environment, coarse_size, where the coarse
# inverse is built).  coarse_size 64 gives 4 levels on the 64 x 64 weak
# grid, whose 41-row bottom the device inverse's validation rejects
# (|I - XM|max 6.7e-2, the JAX build's verdict too); at 200 (2 levels)
# it passes.
SOLVES = {
    "cheb3": ({"cheb": 3}, {"PADNE_TPU_CHEB": "3"}, 64, "host"),
    "cheb_deep3": ({"cheb_deep": 3}, {"PADNE_TPU_CHEB_DEEP": "3"}, 64,
                   "host"),
    "steps2": ({"smooth_steps": 2}, {"PADNE_TPU_SMOOTH_STEPS": "2"}, 64,
               "host"),
    "exact_l0": ({"cycle_lumped": False}, {"PADNE_TPU_CYCLE_LUMPED": "0"},
                 64, "host"),
    "w_cycle": ({"w_levels": 3}, {"PADNE_TPU_WCYCLE": "3"}, 64, "host"),
    "coarse_device": ({"coarse": "device"}, {"PADNE_TPU_DEVICE_COARSE": "1"},
                      200, "device"),
    "coarse_device_rejected": ({"coarse": "device"},
                               {"PADNE_TPU_DEVICE_COARSE": "1"}, 64,
                               "host (validation)"),
}


@pytest.fixture(scope="module")
def solve_systems():
    """The weak 64 x 64 system (JAX, port) and its potentials by scipy's
    spsolve."""
    import scipy.sparse.linalg

    jsys = weak_system(64, seed=8)
    system = convert.core_system_from_numpy(jsys)
    L, r, *_ = schur.bordered_scipy_system(system)
    return jsys, system, scipy.sparse.linalg.spsolve(L, r)[:system.n]


def _variant_solve(system, variant):
    port_kw, _, coarse_size, route = SOLVES[variant]
    s = schur.DiaBorderedSolver(system, device="cpu",
                                coarse_size=coarse_size, **port_kw)
    # W doubles levels 2..3.
    assert len(s.hierarchy.levels) >= (3 if coarse_size == 64 else 2)
    assert s.coarse == route
    return s.solve(target_residual=1e-10)


@pytest.mark.parametrize("variant", list(SOLVES))
def test_solver_variant_solves(variant, solve_systems):
    _, system, v_ref = solve_systems
    got = _variant_solve(system, variant)
    assert got.residual_norm < 1e-10
    assert np.abs(got.v - v_ref).max() <= 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("variant", list(SOLVES))
def test_solver_variant_matches_jax(variant, solve_systems, monkeypatch):
    """Potentials within 1e-6 V of the JAX solver with the same knob.
    The CG iterations and passes are held within 3 and 1, not equal:
    the two packages sum the f32 CG and cycle in another order, and the
    f32 CG's stall exit turns that into a different count (the port
    took 28 against 29 iterations with cheb=3 on a 48 x 48 weak grid,
    and the same elsewhere)."""
    _, env, coarse_size, _ = SOLVES[variant]
    monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", str(coarse_size))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jsys, system, _ = solve_systems
    ref = jschur.DiaBorderedSolver(jsys).solve(target_residual=1e-10)
    got = _variant_solve(system, variant)
    assert got.residual_norm < 1e-10 and ref.residual_norm < 1e-10
    assert np.abs(got.v - ref.v).max() <= 1e-6
    assert abs(got.cg_iterations - ref.cg_iterations) <= 3
    assert abs(got.refinement_steps - ref.refinement_steps) <= 1
