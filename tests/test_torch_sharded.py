"""Port parity for the sharded solve: parallel.sharding, ops.dia_sharded,
the windowed K1' and K2' plain versions, the sharded hierarchy, cycle and
PCG, DiaBorderedSolver(mesh=) and solve_bordered(mesh=) on the ELL route.

The same seeded numpy inputs go through the JAX package on its virtual
CPU devices (tests/conftest.py; backend "xla") and through the port on
`Mesh(["cpu"] * tp)`.  Gates, with the JAX package's own where it has
one (tests/test_dia_sharded.py, tests/test_parallel_solve.py):

* plans: bit-equal arrays;
* windowed plain K1'/K2' at nx = np, x0 = 0: bit-equal to the plain
  versions before the window (kept here);
* sharded matvec: rtol 2e-5, atol 1e-5 (f32 sums in another order);
* sharded K2': 2e-13 of max |A| |x| (exact products, f64 sums);
* sharded V-cycle: rtol 5e-4, atol 5e-5 of the output scale;
* sharded projector: 1e-12 (f64) / 1e-5 (f32) of max |x|;
* bordered DIA solves: v within 1e-7 of max(span, 1), j rtol 1e-6 (two
  independently converged solutions at the 1e-10 target);
* ELL route: |dV| < 1e-8 V.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from padne_tpu import kicad as jkicad, solver as jsolver
from padne_tpu.ops import amg as jamg, cg as jcg, dia as jdia
from padne_tpu.ops import dia_sharded as jdia_sharded, schur as jschur
from padne_tpu.ops.spmv import shard_map_unchecked
from padne_tpu_torch import convert, kicad, solver
from padne_tpu_torch.ops import amg, assembly, bell, cg, comp, dia
from padne_tpu_torch.ops import dia_sharded, schur, spmv
from padne_tpu_torch.parallel import sharding

from tests.test_dia_sharded import _volt_border, grid_system

torch.set_num_threads(1)


def cpu_mesh(tp):
    return sharding.Mesh(["cpu"] * tp)


def jax_mesh(tp):
    return JMesh(np.asarray(jax.devices()[:tp]), axis_names=("tp",))


def port_ell(jell):
    return assembly.EllMatrix(cols=np.asarray(jell.cols),
                              vals=np.asarray(jell.vals),
                              diag=np.asarray(jell.diag))


@functools.lru_cache(maxsize=None)
def far_grid():
    """A 96 x 96 grid with 40 long edges, Hilbert-ordered and packed at
    16384 rows: (JAX pack, port pack)."""
    jell, coords = grid_system(96, 96, n_far=40)
    perm = bell.hilbert_order(coords)
    return (jdia.pack_ell_as_dia(jell, perm=perm, np_override=16384),
            dia.pack_ell_as_dia(port_ell(jell), perm=perm,
                                np_override=16384))


# -- parallel.sharding ------------------------------------------------------


def test_mesh_and_collectives():
    mesh = sharding.Mesh(["cpu"] * 8, dp=2)
    assert (mesh.dp, mesh.tp, mesh.size) == (2, 4, 8)
    assert [len(row) for row in mesh.grid] == [4, 4]
    with pytest.raises(ValueError):
        sharding.Mesh(["cpu"] * 3, dp=2)
    mesh = cpu_mesh(3)
    x = torch.arange(24.0).reshape(2, 12)
    xs = sharding.split(mesh, x, dim=1)
    left, right = sharding.halo_exchange(mesh, xs, 2)
    # No source beyond the edges: zeros, as a ppermute leaves them.
    assert torch.equal(left[0], torch.zeros(2, 2))
    assert torch.equal(right[2], torch.zeros(2, 2))
    assert torch.equal(left[1], x[:, 2:4]) and torch.equal(right[1],
                                                          x[:, 8:10])
    assert all(torch.equal(g, x) for g in sharding.all_gather(mesh, xs, 1))
    assert torch.equal(sharding.psum(mesh, [t.sum(1) for t in xs]),
                       x.sum(1))
    assert np.array_equal(sharding.pad_rows(np.ones((5, 2)), 4),
                          np.pad(np.ones((5, 2)), ((0, 3), (0, 0))))


def test_make_mesh_wants_cuda_devices():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="0 CUDA device"):
        sharding.make_mesh(2)


# -- ops.dia_sharded: the host plan -----------------------------------------


@pytest.mark.parametrize("tp", [4, 8])
def test_plan_matches_jax(tp):
    jpack, pack = far_grid()
    assert dia_sharded.shardable(pack, tp) == jdia_sharded.shardable(
        jpack, tp) is True
    want = jdia_sharded.plan_shards(jpack, tp)
    got = dia_sharded.plan_shards(pack, tp)
    assert got.meta_local == want.meta_local
    assert got.far_row.shape[1] > 0, "the long edges must be far entries"
    for name in ("near_row", "near_win", "near_val", "far_row", "far_pos",
                 "far_val", "src_idx"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_shardable_matches_jax():
    jpack, pack = far_grid()
    for tp in (1, 2, 3, 16, 32):
        assert dia_sharded.shardable(pack, tp) == jdia_sharded.shardable(
            jpack, tp), tp
    with pytest.raises(ValueError):
        dia_sharded.plan_shards(pack, 3)


# -- the windowed plain versions of K1' and K2' -----------------------------


def unwindowed_sell_plain(params, xt):
    """ops.dia.sell_matvec_plain as it was before the window."""
    (pos_a, _), (pos_b, col_b) = dia.sell_entries(params)
    col_a = pos_a // dia.ROW_BLOCK * dia.ROW_BLOCK + params["a_idx"].long()
    acc = torch.zeros_like(xt)
    acc.index_add_(1, pos_a, params["a_val"].float() * xt[:, col_a])
    acc.index_add_(1, pos_b, params["b_val"] * xt[:, col_b])
    y = torch.empty_like(acc)
    y[:, params["perm"].long()] = acc
    return y.addcmul_(params["diag"], xt)


def unwindowed_comp_plain(params, x32):
    """ops.comp.comp_sell_plain as it was before the window."""
    (pos_a, _), (pos_b, col_b) = dia.sell_entries(params)
    col_a = pos_a // dia.ROW_BLOCK * dia.ROW_BLOCK + params["a_idx"].long()
    x64 = x32.double()
    acc = torch.zeros_like(x64)
    acc.index_add_(0, pos_a, params["a_val"].double() * x64[col_a]
                   + params["a_lo"].double() * x64[col_a])
    acc.index_add_(0, pos_b, params["b_val"].double() * x64[col_b]
                   + params["b_lo"].double() * x64[col_b])
    y = torch.empty_like(acc)
    y[params["perm"].long()] = acc
    return y.addcmul_(params["diag64"], x64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_unchanged_without_a_window(dtype):
    _, pack = far_grid()
    params = pack.to_device("cpu", dtype=dtype,
                            compensated=dtype == torch.float32)
    assert (params["nx"], params["x0"]) == (pack.np_, 0)
    rng = np.random.default_rng(4)
    xt = torch.from_numpy(rng.standard_normal((3, pack.np_)).astype(
        np.float32))
    assert torch.equal(dia.sell_matvec_plain(params, xt),
                       unwindowed_sell_plain(params, xt))
    if dtype == torch.float32:
        assert torch.equal(comp.comp_sell_plain(params, xt[0]),
                           unwindowed_comp_plain(params, xt[0]))


def test_window_arguments_are_checked():
    _, pack = far_grid()
    rows, cols, vals, _ = pack.coo("cpu")
    with pytest.raises(ValueError, match="outside the window"):
        dia.build_sell(pack.np_, rows, cols, vals, pack.diag, "cpu",
                       nx=pack.np_, x0=128)
    with pytest.raises(ValueError, match="out of range"):
        dia.build_sell(pack.np_, rows, cols + pack.np_, vals, pack.diag,
                       "cpu", nx=pack.np_ + 128, x0=0)
    params = dia.build_sell(pack.np_, rows, cols + 128, vals, pack.diag,
                            "cpu", nx=pack.np_ + 256, x0=128)
    x = torch.randn(2, pack.np_ + 256)
    with pytest.raises(ValueError, match="window"):
        dia.sell_args(params, x[:, :-1], {})
    # A window around an operator of its own computes the same product.
    ref = dia.sell_matvec_plain(pack.to_device("cpu"), x[:, 128:-128])
    got = dia.sell_matvec_plain(params, x)
    assert torch.allclose(got, ref, rtol=1e-6, atol=1e-5)


# -- ops.dia_sharded: the sharded products -----------------------------------


@pytest.mark.parametrize("tp", [4, 8])
def test_sharded_matvec_matches_jax_and_serial(tp):
    jpack, pack = far_grid()
    rng = np.random.default_rng(1)
    xt = rng.standard_normal((3, pack.np_)).astype(np.float32)

    jmesh = jax_mesh(tp)
    jplan = jdia_sharded.plan_shards(jpack, tp)
    jparams = jdia_sharded.upload_sharded(jpack, jplan, jmesh, "tp")

    def local(prm, x):
        return jdia_sharded.dia_matvec_t_local(
            jpack.meta, jplan.meta_local, prm, x, "tp", "xla")

    f = jax.jit(shard_map_unchecked(
        local, jmesh, in_specs=(jdia_sharded.param_specs("tp"),
                                P(None, "tp")),
        out_specs=P(None, "tp")))
    want = np.asarray(f(jparams, jnp.asarray(xt)))

    mesh = cpu_mesh(tp)
    op = dia_sharded.upload_sharded(pack, dia_sharded.plan_shards(pack, tp),
                                    mesh)
    assert op.nx == op.np_local + 2 * op.halo + tp * op.ms
    got = torch.cat(dia_sharded.dia_matvec_t_sharded(
        op, sharding.split(mesh, torch.from_numpy(xt), dim=1)), dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    serial = dia.dia_matvec_t(pack.meta, pack.to_device("cpu"),
                              torch.from_numpy(xt))
    np.testing.assert_allclose(got.numpy(), serial.numpy(), rtol=2e-5,
                               atol=1e-5)


def test_sharded_comp_matches_serial_and_scipy():
    _, pack = far_grid()
    tp = 4
    mesh = cpu_mesh(tp)
    op = dia_sharded.upload_sharded(pack, dia_sharded.plan_shards(pack, tp),
                                    mesh, compensated=True)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(pack.np_).astype(np.float32))
    got = torch.cat(dia_sharded.comp_sharded(op, sharding.split(mesh, x, 0)))
    serial = comp.comp_sell(pack.to_device("cpu", compensated=True), x)
    rows, cols, vals, _ = pack.coo("cpu")
    a = scipy.sparse.coo_matrix(
        (vals.numpy(), (rows.numpy(), cols.numpy())),
        shape=(pack.np_, pack.np_)).tocsr() + scipy.sparse.diags(pack.diag)
    x64 = x.double().numpy()
    bound = 2e-13 * np.abs(abs(a) @ np.abs(x64)).max()
    assert np.abs(got.numpy() - serial.numpy()).max() <= bound
    assert np.abs(got.numpy() - a @ x64).max() <= bound


# -- amg: the sharded hierarchy and cycle -----------------------------------


@functools.lru_cache(maxsize=None)
def deep_grid():
    """A 224 x 224 grid with 20 long edges and its hierarchies at tp 4,
    shard_min 1024, coarse size 200: (JAX hierarchy, port hierarchy)."""
    jell, coords = grid_system(224, 224, n_far=20)
    kw = dict(tp=4, shard_min=1024, coarse_size=200)
    return (jamg.build_hierarchy_dia(jell, coords, **kw),
            amg.build_hierarchy_dia(port_ell(jell), coords, **kw))


def test_sharded_hierarchy_matches_jax():
    jh, h = deep_grid()
    assert [lv.pack.np_ for lv in h.levels] == [lv.pack.np_
                                                for lv in jh.levels]
    assert [lv.shard for lv in h.levels] == [lv.shard for lv in jh.levels]
    assert sum(lv.shard for lv in h.levels) >= 2
    for lv, jlv in zip(h.levels, jh.levels):
        assert lv.pack.offs == jlv.pack.offs and lv.cap == jlv.cap
        for name in ("widx_hi", "widx_lo", "wval", "rem_rows", "rem_cols",
                     "rem_vals", "diag"):
            assert np.array_equal(getattr(lv.pack, name),
                                  getattr(jlv.pack, name)), name
        assert np.array_equal(lv.dinv, jlv.dinv)
        assert np.array_equal(lv.child_perm, jlv.child_perm)
    assert np.array_equal(h.posmap0, jh.posmap0)


def test_sharded_vcycle_matches_jax_and_serial():
    jh, h = deep_grid()
    rng = np.random.default_rng(2)
    rt = rng.standard_normal((2, h.np0)).astype(np.float32)
    jmesh = jax_mesh(4)
    apply_l, jparams, specs, jn_sh, _ = jamg.make_vcycle_dia_sharded(
        jh, jmesh, backend="xla")
    f = jax.jit(shard_map_unchecked(apply_l, jmesh,
                                    in_specs=(specs, P(None, "tp")),
                                    out_specs=P(None, "tp")))
    want = np.asarray(f(jparams, jnp.asarray(rt)))

    # The JAX sharded cycle runs level 0 unlumped and, on the CPU, as a
    # V-cycle; the port's default lumps and takes a W-shape on the card.
    mesh = cpu_mesh(4)
    apply, params, n_sh = amg.make_vcycle_dia_sharded(
        h, mesh, w_levels=0, lump_strength=0.0)
    assert n_sh == jn_sh >= 2
    got = torch.cat(apply(params, sharding.split(
        mesh, torch.from_numpy(rt), dim=1)), dim=1).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5 * scale)
    for w_levels, lump in ((0, 0.0), (3, 0.05)):
        apply_t, params_t = amg.make_vcycle_dia_t(
            h, "cpu", w_levels=w_levels, lump_strength=lump)
        serial = apply_t(params_t, torch.from_numpy(rt)).numpy()
        apply, params, _ = amg.make_vcycle_dia_sharded(
            h, mesh, w_levels=w_levels, lump_strength=lump)
        got = torch.cat(apply(params, sharding.split(
            mesh, torch.from_numpy(rt), dim=1)), dim=1).numpy()
        np.testing.assert_allclose(got, serial, rtol=5e-4,
                                   atol=5e-5 * np.abs(serial).max())


def test_sharded_pcg_matches_serial():
    """cg.make_pcg_sharded in both layouts against make_pcg on one
    device: a chain Laplacian of two components, Jacobi."""
    rng = np.random.default_rng(0)
    n, tp = 64, 4
    edges = np.array([(i, i + 1) for i in range(n - 1) if i != n // 2 - 1])
    ell = assembly.build_ell(n, edges, rng.uniform(0.5, 2.0, len(edges)))
    comp_id = torch.from_numpy((np.arange(n) >= n // 2).astype(np.int64))
    b = torch.from_numpy(rng.standard_normal((n, 3)))
    a = ell.to_device("cpu", torch.float64)
    want = cg.make_pcg(a, comp_id, 2)(b, 1e-10, 500)
    mesh = cpu_mesh(tp)
    diag = torch.from_numpy(ell.diag)
    for dim in (0, 1):
        ops = amg.shard_ell_rows(ell.cols, ell.vals, ell.diag, n, n, mesh,
                                 torch.float64)

        def matvec(prm, xs, dim=dim):
            full = sharding.all_gather(mesh, [x if dim == 0 else x.T
                                              for x in xs], dim=0)
            ys = [spmv.ell_spmv(op, xf) for op, xf in zip(prm, full)]
            return ys if dim == 0 else [y.T.contiguous() for y in ys]

        got = cg.make_pcg_sharded(
            mesh, (matvec, ops), comp_id, 2,
            cg.jacobi_sharded(sharding.split(mesh, diag, 0), dim=dim),
            dim=dim)(b, 1e-10, 500)
        assert got.iterations == want.iterations
        assert torch.allclose(got.x, want.x, rtol=1e-8, atol=1e-10)
        assert torch.allclose(got.residual_norms, want.residual_norms,
                              rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("p", [1, 5, 70])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_projector_matches_jax(p, dtype, monkeypatch):
    """cg.make_projector_sharded on Mesh(["cpu"] * 4) against the JAX
    package's make_projector(comp_id, p, gsum=psum) under shard_map, in
    both layouts: one-hot products up to 64 components (one component
    included, as the JAX function takes them with gsum), fixed-order
    segment sums beyond.  Per entry 1e-12 (f64) / 1e-5 (f32) of the
    largest |x|; the projected columns have zero component sums; two
    calls bit-equal."""
    tp, n, r = 4, 512, 3
    rng = np.random.default_rng(p)
    comp_id = rng.integers(0, p, n)
    comp_id[:n // 2] = 0          # one component holds most rows
    x = rng.standard_normal((n, r)).astype(dtype)

    def local(c, xl):
        return jcg.make_projector(
            c, p, gsum=lambda v: jax.lax.psum(v, "tp"))(xl)

    f = jax.jit(shard_map_unchecked(local, jax_mesh(tp),
                                    in_specs=(P("tp"), P("tp", None)),
                                    out_specs=P("tp", None)))
    want = np.asarray(f(jnp.asarray(comp_id), jnp.asarray(x)))

    segments = []
    real = cg.segment.SegmentSum

    def recording(*args, **kw):
        segments.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(cg.segment, "SegmentSum", recording)
    mesh = cpu_mesh(tp)
    tol = (1e-12 if dtype == np.float64 else 1e-5) * np.abs(x).max()
    for dim in (0, 1):
        project = cg.make_projector_sharded(mesh, comp_id, p, dim)
        xt = torch.from_numpy(x if dim == 0 else x.T.copy())
        got = project(sharding.split(mesh, xt, dim))
        again = project(sharding.split(mesh, xt, dim))
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        got = torch.cat(got, dim).numpy()
        got = got if dim == 0 else got.T
        assert got.dtype == dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        sums = np.zeros((p, r))
        np.add.at(sums, comp_id, got.astype(np.float64))
        assert np.abs(sums).max() <= n * tol
    # The JAX rule: the segment sum only beyond 64 components, one
    # layout a shard.
    assert len(segments) == (0 if p <= 64 else 2 * tp)


# -- ops.schur: the sharded DIA route ---------------------------------------

COARSE = 200


def volt_grid(g):
    """test_dia_sharded's g x g grid with a 1 V source corner to corner,
    as a JAX CoreSystem."""
    jell, coords = grid_system(g, g)
    n = g * g
    return jschur.CoreSystem(
        n=n, ell=jell, comp_id=np.zeros(n, dtype=np.int32),
        num_components=1, border=_volt_border(n), r_core=np.zeros(n),
        ground_var=0, coords=coords)


def test_dia_solver_matches_jax_and_serial(monkeypatch):
    monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", str(COARSE))
    jsystem = volt_grid(128)
    jsolver_ = jschur.DiaBorderedSolver(jsystem, mesh=jax_mesh(4),
                                        shard_min=4096)
    assert jsolver_._sharded
    want = jsolver_.solve(target_residual=1e-10)

    system = convert.core_system_from_numpy(jsystem)
    kw = dict(device="cpu", cycle_dtype=torch.float32, w_levels=0,
              coarse_size=COARSE)
    s = schur.DiaBorderedSolver(system, mesh=cpu_mesh(4), shard_min=4096,
                                **kw)
    assert s.sharded and s.tp == 4 and s.n_sharded >= 1
    got = s.solve(target_residual=1e-10)
    serial = schur.DiaBorderedSolver(system, **kw).solve(
        target_residual=1e-10)
    for ref in (want, serial):
        assert got.residual_norm < 1e-10 and ref.residual_norm < 1e-10
        span = ref.v.max() - ref.v.min()
        np.testing.assert_allclose(got.v, ref.v, atol=1e-7 * max(span, 1.0),
                                   rtol=0)
        np.testing.assert_allclose(got.j, ref.j, rtol=1e-6)
    assert abs(got.cg_iterations - serial.cg_iterations) <= max(
        1, 0.1 * serial.cg_iterations)
    assert abs(got.refinement_steps - serial.refinement_steps) <= max(
        1, 0.1 * serial.refinement_steps)


def fragmented_system(comps=70, gx=24, gy=16):
    """`comps` separate grid islands side by side, a 1 V source across
    the first: (JAX CoreSystem, port CoreSystem)."""
    n1 = gx * gy
    n = comps * n1
    parts, coords = [], []
    ii, jj = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
    for c in range(comps):
        idx = (ii * gy + jj) + c * n1
        parts += [np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
                  np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)]
        coords.append(np.stack([ii.ravel() + (c % 9) * (gx + 3),
                                jj.ravel() + (c // 9) * (gy + 3)], 1))
    edges = np.concatenate(parts).astype(np.int64)
    from padne_tpu.ops import assembly as jassembly

    jell = jassembly.build_ell(n, edges, np.ones(len(edges)))
    border = _volt_border(n1)
    jsystem = jschur.CoreSystem(
        n=n, ell=jell, comp_id=np.repeat(np.arange(comps, dtype=np.int32),
                                         n1),
        num_components=comps, border=border, r_core=np.zeros(n),
        ground_var=0, coords=np.concatenate(coords).astype(np.float64))
    return jsystem, convert.core_system_from_numpy(jsystem)


def test_many_components_decline_as_in_jax(monkeypatch):
    monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", str(COARSE))
    jsystem, system = fragmented_system()
    jsol = jschur.DiaBorderedSolver(jsystem, mesh=jax_mesh(4),
                                    shard_min=4096)
    assert not jsol._sharded
    want = jsol.solve(target_residual=1e-8)
    s = schur.DiaBorderedSolver(system, device="cpu", mesh=cpu_mesh(4),
                                shard_min=4096, cycle_dtype=torch.float32,
                                w_levels=0, coarse_size=COARSE)
    assert s.hierarchy.levels[0].shard and not s.sharded
    got = s.solve(target_residual=1e-8)
    assert got.residual_norm < 1e-8
    span = want.v.max() - want.v.min()
    assert span > 0.5
    np.testing.assert_allclose(got.v, want.v, atol=1e-7 * max(span, 1.0),
                               rtol=0)
    np.testing.assert_allclose(got.j, want.j, rtol=1e-6)


# -- ops.schur: the sharded ELL route ---------------------------------------


@pytest.fixture(scope="module")
def strip(boards_dir):
    """gen_strip (387 core unknowns, not a multiple of 4): (JAX system,
    port system)."""
    pro = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    jsys = jsolver.build_system(jkicad.load_kicad_project(pro))[0]
    sys_ = solver.build_system(kicad.load_kicad_project(pro))[0]
    assert sys_.n % 4 and sys_.n == jsys.n
    return jsys, sys_


@pytest.mark.parametrize("precond", ["jacobi", "amg"])
def test_ell_route_matches_jax_and_serial(strip, precond):
    jsys, system = strip
    want = jschur.solve_bordered(jsys, precond=precond, mesh=jax_mesh(4))
    serial = schur.solve_bordered(system, device="cpu", precond=precond)
    stats = {}
    got = schur.solve_bordered(system, device="cpu", mesh=cpu_mesh(4),
                               stats=stats, precond=precond)
    assert stats["route"] == "ell" and stats["sharded"] and stats["tp"] == 4
    assert bool(stats["levels"]) == (precond == "amg")
    assert got.residual_norm < 1e-9
    for ref in (want, serial):
        assert np.abs(got.v - ref.v).max() < 1e-8
        assert np.abs(got.j - ref.j).max() < 1e-8


@pytest.mark.parametrize("inner_dtype", [None, torch.float32])
def test_ell_route_sharded_levels(strip, inner_dtype, monkeypatch):
    """A hierarchy of three levels, none a multiple of 4 rows, row-sharded
    (restriction, prolongation and the coarse solve across shards), in
    f64 and mixed precision."""
    _, system = strip
    monkeypatch.setattr(schur.amg, "build_hierarchy", functools.partial(
        amg.build_hierarchy, coarse_size=40))
    serial = schur.solve_bordered(system, device="cpu",
                                  inner_dtype=inner_dtype, precond="amg")
    stats = {}
    got = schur.solve_bordered(system, device="cpu", mesh=cpu_mesh(4),
                               inner_dtype=inner_dtype, stats=stats,
                               precond="amg")
    assert len(stats["levels"]) == 3
    assert all(n % 4 for n in stats["levels"])
    assert got.residual_norm < 1e-9
    assert np.abs(got.v - serial.v).max() < 1e-8


def test_one_device_mesh_is_serial(strip):
    _, system = strip
    stats = {}
    got = schur.solve_bordered(system, device="cpu", mesh=cpu_mesh(1),
                               stats=stats)
    assert stats["tp"] == 1 and not stats["sharded"]
    assert got.residual_norm < 1e-9


def test_solver_solve_with_a_mesh(boards_dir, monkeypatch):
    """solver.solve(device_mesh=) shards the solve and skips the
    resident-server dispatch, as the JAX package's does; its potentials
    match the one-device solve's."""
    import warnings

    prob = kicad.load_kicad_project(
        boards_dir / "gen_two_layer_via" / "gen_two_layer_via.kicad_pro")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        serial = solver.solve(prob, device="cpu")

        def no_server(*args):
            raise AssertionError("a mesh solve asked the server")

        monkeypatch.setattr(solver, "_served", no_server)
        stats = {}
        got = solver.solve(prob, device="cpu", device_mesh=cpu_mesh(4),
                           stats=stats)
    assert stats["sharded"] and stats["served_by"] is None
    assert got.solver_info.residual_norm < 1e-9
    for ls_s, ls_t in zip(serial.layer_solutions, got.layer_solutions,
                          strict=True):
        for pot_s, pot_t in zip(ls_s.potentials, ls_t.potentials,
                                strict=True):
            assert np.abs(pot_s.values - pot_t.values).max() < 1e-8


def test_dp_x_tp_dia_replicas():
    """dp x tp of the DIA production path (JAX tests/test_dia_sharded.py
    test_dp_x_tp_production_replicas): a dp 2 x tp 4 mesh split into two
    replicas, each solving a scaled copy of the system row-sharded over
    its own row of 4 devices.  The forced volt is scale-invariant, the
    border current doubles with the conductance."""
    mesh = sharding.Mesh(["cpu"] * 8, dp=2)
    system = convert.core_system_from_numpy(volt_grid(128))
    results = []
    for d, row in enumerate(mesh.grid):
        scale = 1.0 + d
        ell = assembly.EllMatrix(cols=system.ell.cols,
                                 vals=system.ell.vals * scale,
                                 diag=system.ell.diag * scale)
        s = schur.DiaBorderedSolver(
            dataclasses.replace(system, ell=ell), device="cpu",
            mesh=sharding.Mesh(row), shard_min=4096, coarse_size=COARSE)
        assert s.sharded and s.tp == 4 and s.n_sharded >= 1
        sol = s.solve(target_residual=1e-9)
        assert sol.residual_norm < 1e-9
        results.append(sol)
    for sol in results:
        assert abs(float(sol.v.max() - sol.v.min()) - 1.0) < 1e-6
    np.testing.assert_allclose(results[1].v, results[0].v, atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(results[1].j, 2.0 * results[0].j, rtol=1e-6)
