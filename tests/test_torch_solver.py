"""The port end to end on the CPU: padne_tpu_torch.solver.solve against
padne_tpu.solver.solve, each package loading the project with its own
kicad module.

* The generated 4-layer bench board cut to ~40k DoF, forced through the
  port's DIA route by schur.solve_bordered(operator="dia") (a two-level
  DIA hierarchy; the CPU's auto route is ELL, as in the JAX package).
* The small generated boards through the auto route (ELL, or the host
  direct route for gen_zone_plane's wide border).

Per-layer potentials agree within 1e-6 V and power densities within
1e-6 of each layer's maximum; both reach the repo's 1e-9 residual
gate."""

import numpy as np
import pytest
import torch

from padne_tpu import kicad as jkicad
from padne_tpu import mesh as jmesh
from padne_tpu import solver as jsolver
from padne_tpu_torch import kicad, mesh, solver
from padne_tpu_torch.ops import schur
from padne_tpu_torch.solver import Solution

from tests import boardgen
from tests.test_torch_host import BOARDS, board_project

torch.set_num_threads(1)


def _bench_config(mesh_module, prob):
    # Mesh density for the DoF target, as bench.py sizes it.
    area = sum(layer.shape.area for layer in prob.layers)
    size = (area / (0.43 * 25_000)) ** 0.5
    return mesh_module.Mesher.Config(maximum_size=size,
                                     variable_size_maximum_factor=1.0)


@pytest.fixture(scope="module")
def bench_project(tmp_path_factory):
    return boardgen.gen_bench_4layer(tmp_path_factory.mktemp("bench4"))


def _assert_fields_match(got, ref):
    assert got.solver_info.residual_norm < 1e-9
    assert ref.solver_info.residual_norm < 1e-9
    assert got.solver_info.system_size == ref.solver_info.system_size
    assert len(got.layer_solutions) == len(ref.layer_solutions)
    for lg, lr in zip(got.layer_solutions, ref.layer_solutions):
        assert len(lg.potentials) == len(lr.potentials)
        assert len(lg.disconnected_meshes) == len(lr.disconnected_meshes)
        for pg, pr in zip(lg.potentials, lr.potentials):
            assert np.abs(pg.values - pr.values).max() <= 1e-6
        if not lr.power_densities:
            continue
        pmax = max(np.abs(p.values).max() for p in lr.power_densities)
        for pg, pr in zip(lg.power_densities, lr.power_densities):
            assert np.abs(pg.values - pr.values).max() <= 1e-6 * pmax


def test_slice_matches_jax(bench_project):
    """The DIA route, forced through the port's solve_bordered, then the
    port's own field post-processing."""
    prob = kicad.load_kicad_project(bench_project)
    system, meshes, mesh_to_layer, vindex, disconnected = solver.build_system(
        prob, _bench_config(mesh, prob))
    stats = {}
    res = schur.solve_bordered(system, operator="dia", device="cpu",
                               stats=stats)
    layers = solver.produce_layer_solutions(
        prob.layers, vindex, meshes, mesh_to_layer, res.v, disconnected,
        torch.device("cpu"))
    info = solver.SolverInfo(ground_node_current=res.ground_current,
                             residual_norm=res.residual_norm,
                             system_size=system.n + system.border.m)
    got = Solution(problem=prob, layer_solutions=layers, solver_info=info)
    jprob = jkicad.load_kicad_project(bench_project)
    ref = jsolver.solve(jprob, mesher_config=_bench_config(jmesh, jprob))
    assert stats["route"] == "dia"
    assert 30_000 < system.n < 60_000 and len(stats["levels"]) >= 2
    assert len(got.layer_solutions) == 4
    _assert_fields_match(got, ref)


@pytest.mark.parametrize("name", BOARDS)
def test_boards_match_jax(tmp_path, name):
    """The auto route on the CPU: f64 ELL (or host direct), held to the
    JAX package's own auto route."""
    pro = board_project(tmp_path, name)
    stats = {}
    got = solver.solve(kicad.load_kicad_project(pro), device="cpu",
                       stats=stats)
    ref = jsolver.solve(jkicad.load_kicad_project(pro))
    assert isinstance(got, Solution)
    assert stats["route"] == ("direct" if name == "gen_zone_plane"
                              else "ell")
    _assert_fields_match(got, ref)
    if name == "gen_floating_island":
        # The dead island reaches the display meshes, not the solve.
        assert sum(len(l.disconnected_meshes)
                   for l in got.layer_solutions) == 1


def test_device_policy():
    from padne_tpu_torch import device

    assert device.resolve("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device.resolve(None)


@pytest.mark.parametrize("name", ["gen_regulator", "gen_two_layer_via"])
def test_system_to_scipy_matches_jax(tmp_path, name):
    """The bordered system in the reference layout, L and r equal to the
    JAX package's on each package's own assembly of the board."""
    pro = board_project(tmp_path, name)
    system = solver.build_system(kicad.load_kicad_project(pro))[0]
    ref = jsolver.build_system(jkicad.load_kicad_project(pro))[0]
    got_l, got_r = solver.system_to_scipy(system)
    want_l, want_r = jsolver.system_to_scipy(ref)
    assert got_l.shape == want_l.shape
    assert (got_l != want_l).nnz == 0
    np.testing.assert_array_equal(got_r, want_r)


def test_power_density_matches_jax():
    """One mesh's power density, f64, against the JAX package's, and the
    batch of one mesh."""
    import jax.numpy as jnp

    from padne_tpu import geom as jgeom
    from padne_tpu.ops import postproc as jpostproc
    from padne_tpu_torch.ops import postproc

    m = jmesh.Mesher(jmesh.Mesher.Config(
        maximum_size=0.7, variable_size_maximum_factor=1.0)).poly_to_mesh(
        jgeom.box(0, 0, 4, 3))
    vals = np.random.default_rng(5).standard_normal(m.num_vertices)
    want = np.asarray(jpostproc.power_density(
        jnp.asarray(m.vertices), jnp.asarray(m.triangles), jnp.asarray(vals),
        2.5))
    got = postproc.power_density(
        torch.from_numpy(np.asarray(m.vertices, np.float64)),
        torch.from_numpy(np.asarray(m.triangles, np.int64)),
        torch.from_numpy(vals), 2.5)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(
        postproc.power_density_batch([m], [vals], [2.5], "cpu")[0],
        got.numpy())
