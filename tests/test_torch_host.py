"""The port's own host pipeline against the JAX package's, on the
generated boards: the same KiCad project loaded by padne_tpu_torch.kicad
and padne_tpu.kicad gives the same layers, networks and element values,
bit-equal meshes for one Mesher.Config, and a bit-equal assembled
CoreSystem (ELL arrays, components, border, right-hand side, coordinates
and mesh groups).  The port keeps copies of these jax-free modules
instead of importing them, so nothing but this test holds the copies
to the reference."""

import numpy as np
import pytest

from padne_tpu import kicad as jkicad
from padne_tpu import mesh as jmesh
from padne_tpu import problem as jproblem
from padne_tpu import solver as jsolver
from padne_tpu_torch import kicad, mesh, problem, solver

from tests import boardgen

BOARDS = ["gen_strip", "gen_two_layer_via", "gen_zone_plane",
          "gen_regulator", "gen_resistor_divider", "gen_floating_island",
          "gen_via_stack_4layer"]
CONFIG = {"maximum_size": 0.4, "variable_size_maximum_factor": 2.0}

_ELEMENT_VALUES = {"Resistor": ("resistance",), "VoltageSource": ("voltage",),
                   "CurrentSource": ("current",),
                   "VoltageRegulator": ("voltage", "gain")}
_ELEMENT_NODES = {"Resistor": ("a", "b"), "VoltageSource": ("p", "n"),
                  "CurrentSource": ("f", "t"),
                  "VoltageRegulator": ("v_p", "v_n", "s_f", "s_t")}


def board_project(tmp_path, name):
    getattr(boardgen, name)(tmp_path)
    return tmp_path / name / f"{name}.kicad_pro"


def _network_summary(net, elements_module):
    """Per element: type name, values, and terminals.  NodeIDs are
    identity objects, so a terminal is named by the connection that
    carries it, or else by its first appearance among the elements."""
    label = {c.node_id: ("conn", i) for i, c in enumerate(net.connections)}
    out = []
    for e in net.elements:
        kind = type(e).__name__
        assert isinstance(e, getattr(elements_module, kind))
        terms = []
        for f in _ELEMENT_NODES[kind]:
            node = getattr(e, f)
            label.setdefault(node, ("internal", len(label)))
            terms.append(label[node])
        out.append((kind, tuple(getattr(e, f) for f in _ELEMENT_VALUES[kind]),
                    tuple(terms)))
    return out, len(net.connections), len(net.nodes), net.has_source


@pytest.mark.parametrize("name", BOARDS)
def test_problem_and_meshes_equal(tmp_path, name):
    pro = board_project(tmp_path, name)
    ref = jkicad.load_kicad_project(pro)
    got = kicad.load_kicad_project(pro)
    assert isinstance(got, problem.Problem)
    assert got.project_name == ref.project_name
    assert [(l.name, l.conductance) for l in got.layers] == [
        (l.name, l.conductance) for l in ref.layers]
    for lg, lr in zip(got.layers, ref.layers):
        assert len(lg.geoms) == len(lr.geoms)
        assert lg.shape.area == lr.shape.area
        for pg, pr in zip(lg.geoms, lr.geoms):
            assert len(pg.rings) == len(pr.rings)
            for rg, rr in zip(pg.rings, pr.rings):
                np.testing.assert_array_equal(rg, rr)
    assert len(got.networks) == len(ref.networks) >= 1
    for ng, nr in zip(got.networks, ref.networks):
        assert (_network_summary(ng, problem)
                == _network_summary(nr, jproblem))
        for cg, cr in zip(ng.connections, nr.connections):
            assert (cg.point.x, cg.point.y) == (cr.point.x, cr.point.y)
            assert cg.layer.name == cr.layer.name

    mesher = mesh.Mesher(mesh.Mesher.Config(**CONFIG))
    jmesher = jmesh.Mesher(jmesh.Mesher.Config(**CONFIG))
    for lg, lr in zip(got.layers, ref.layers):
        for pg, pr in zip(lg.geoms, lr.geoms):
            mg, mr = mesher.poly_to_mesh(pg), jmesher.poly_to_mesh(pr)
            assert mg.num_vertices > 3
            np.testing.assert_array_equal(mg.vertices, mr.vertices)
            np.testing.assert_array_equal(mg.triangles, mr.triangles)
            np.testing.assert_array_equal(mg.cotan_edge_weights,
                                          mr.cotan_edge_weights)


@pytest.mark.parametrize("name", BOARDS)
def test_core_system_equal(tmp_path, name):
    pro = board_project(tmp_path, name)
    got, g_meshes, g_m2l, _, g_disc = solver.build_system(
        kicad.load_kicad_project(pro),
        mesher_config=mesh.Mesher.Config(**CONFIG))
    ref, r_meshes, r_m2l, _, r_disc = jsolver.build_system(
        jkicad.load_kicad_project(pro),
        mesher_config=jmesh.Mesher.Config(**CONFIG))
    assert g_m2l == r_m2l
    for mg, mr in zip(g_meshes, r_meshes):
        np.testing.assert_array_equal(mg.vertices, mr.vertices)
        np.testing.assert_array_equal(mg.triangles, mr.triangles)
    assert [len(d) for d in g_disc] == [len(d) for d in r_disc]
    assert (got.n, got.num_components, got.ground_var) == (
        ref.n, ref.num_components, ref.ground_var)
    for field in ("cols", "vals", "diag"):
        np.testing.assert_array_equal(getattr(got.ell, field),
                                      getattr(ref.ell, field))
    for field in ("comp_id", "r_core", "coords", "group"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(ref, field))
    assert got.border.m == ref.border.m
    for field in ("row_idx", "row_node", "row_val", "col_idx", "col_node",
                  "col_val", "rhs"):
        np.testing.assert_array_equal(getattr(got.border, field),
                                      getattr(ref.border, field))
