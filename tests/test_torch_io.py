"""Port parity for padne_tpu_torch.io: the solution artifact, the ParaView
export and the HTML viewer against padne_tpu.io on the same solutions.

One solve per board with the port (on the CPU); the JAX package's
Solution of the same numpy arrays is built from that, so every
comparison is exact: arrays bit-equal, manifests equal, parsed XML trees
equal (lxml and xml.etree differ only in whitespace on disk), HTML
payloads equal and the written HTML byte-equal."""

import json
import warnings
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from padne_tpu import kicad as jkicad
from padne_tpu import mesh as jmesh
from padne_tpu import solver as jsolver
from padne_tpu.io import htmlview as jhtmlview
from padne_tpu.io import paraview as jparaview
from padne_tpu.io import solution as jsolution_io
from padne_tpu_torch import kicad, solver
from padne_tpu_torch.io import htmlview, paraview
from padne_tpu_torch.io import solution as solution_io

torch.set_num_threads(1)

BOARDS = ("gen_via_stack_4layer", "gen_floating_island", "gen_zone_plane")


def as_jax_solution(sol, jprob):
    """The JAX package's Solution of the port's `sol`, over the same
    numpy arrays, with `jprob` (the same project loaded by padne_tpu) as
    its problem."""
    layer_solutions = []
    for ls in sol.layer_solutions:
        meshes = [jmesh.TriMesh(vertices=m.vertices, triangles=m.triangles)
                  for m in ls.meshes]
        layer_solutions.append(jsolver.LayerSolution(
            meshes=meshes,
            potentials=[jmesh.ZeroForm(m, p.values)
                        for m, p in zip(meshes, ls.potentials)],
            power_densities=[jmesh.TwoForm(m, p.values)
                             for m, p in zip(meshes, ls.power_densities)],
            disconnected_meshes=[
                jmesh.TriMesh(vertices=m.vertices, triangles=m.triangles)
                for m in ls.disconnected_meshes]))
    info = sol.solver_info
    return jsolver.Solution(
        problem=jprob, layer_solutions=layer_solutions,
        solver_info=jsolver.SolverInfo(
            ground_node_current=info.ground_node_current,
            residual_norm=info.residual_norm,
            cg_iterations=info.cg_iterations, system_size=info.system_size,
            refinement_steps=info.refinement_steps))


@pytest.fixture(scope="module", params=BOARDS)
def solutions(request, boards_dir):
    """(port Solution, JAX Solution of the same arrays) of one board."""
    pro = boards_dir / request.param / f"{request.param}.kicad_pro"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol = solver.solve(kicad.load_kicad_project(pro), device="cpu")
    return sol, as_jax_solution(sol, jkicad.load_kicad_project(pro))


def npz_arrays(path):
    data = np.load(path)
    return {k: data[k] for k in data.files}


def assert_same_fields(a, b):
    """Two Solutions (of either package) hold bit-equal arrays."""
    assert a.problem.project_name == b.problem.project_name
    assert len(a.layer_solutions) == len(b.layer_solutions)
    for la, lb, pa, pb in zip(a.problem.layers, b.problem.layers,
                              a.layer_solutions, b.layer_solutions):
        assert la.name == lb.name and la.conductance == lb.conductance
        assert len(pa.meshes) == len(pb.meshes)
        assert len(pa.disconnected_meshes) == len(pb.disconnected_meshes)
        for ma, mb in zip(pa.meshes + pa.disconnected_meshes,
                          pb.meshes + pb.disconnected_meshes):
            assert np.array_equal(ma.vertices, mb.vertices)
            assert np.array_equal(ma.triangles, mb.triangles)
        for fa, fb in zip(pa.potentials + pa.power_densities,
                          pb.potentials + pb.power_densities):
            assert fa.values.dtype == fb.values.dtype
            assert np.array_equal(fa.values, fb.values)
    ia, ib = a.solver_info, b.solver_info
    assert (ia.ground_node_current, ia.residual_norm, ia.cg_iterations,
            ia.system_size, ia.refinement_steps) == (
        ib.ground_node_current, ib.residual_norm, ib.cg_iterations,
        ib.system_size, ib.refinement_steps)


def test_format_version_equal():
    assert solution_io.FORMAT_VERSION == jsolution_io.FORMAT_VERSION


def test_artifact_written_by_the_port_loads_in_the_jax_package(
        solutions, tmp_path):
    sol, _ = solutions
    solution_io.save_solution(sol, tmp_path / "port.npz")
    loaded = jsolution_io.load_solution(tmp_path / "port.npz")
    assert isinstance(loaded, jsolver.Solution)
    assert_same_fields(loaded, sol)


def test_artifact_written_by_the_jax_package_loads_in_the_port(
        solutions, tmp_path):
    sol, jsol = solutions
    jsolution_io.save_solution(jsol, tmp_path / "jax.npz")
    loaded = solution_io.load_solution(tmp_path / "jax.npz")
    assert isinstance(loaded, solver.Solution)
    assert_same_fields(loaded, sol)


def test_artifacts_equal_key_for_key(solutions, tmp_path):
    """Same keys, bit-equal arrays and equal manifests from either
    package."""
    sol, jsol = solutions
    solution_io.save_solution(sol, tmp_path / "port.npz")
    jsolution_io.save_solution(jsol, tmp_path / "jax.npz")
    got, want = npz_arrays(tmp_path / "port.npz"), npz_arrays(
        tmp_path / "jax.npz")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    assert (json.loads(bytes(got["__manifest__"]).decode())
            == json.loads(bytes(want["__manifest__"]).decode()))


def test_newer_format_is_refused(solutions, tmp_path):
    sol, _ = solutions
    solution_io.save_solution(sol, tmp_path / "a.npz")
    arrays = npz_arrays(tmp_path / "a.npz")
    manifest = json.loads(bytes(arrays["__manifest__"]).decode())
    manifest["format_version"] = solution_io.FORMAT_VERSION + 1
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez_compressed(tmp_path / "b.npz", **arrays)
    with pytest.raises(ValueError, match="newer"):
        solution_io.load_solution(tmp_path / "b.npz")


def tree_of(element):
    """(tag, attributes, text with whitespace normalised, children)."""
    return (element.tag, dict(element.attrib),
            " ".join((element.text or "").split()),
            [tree_of(child) for child in element])


def test_paraview_trees_equal(solutions, tmp_path):
    """The port writes the VTU trees with xml.etree, the JAX package
    with lxml: same files, and after parsing the same tags, attributes,
    texts and children in order."""
    sol, jsol = solutions
    paraview.export_solution(sol, tmp_path / "port")
    jparaview.export_solution(jsol, tmp_path / "jax")
    got = sorted(p.name for p in (tmp_path / "port").glob("*"))
    want = sorted(p.name for p in (tmp_path / "jax").glob("*"))
    assert got == want and got
    pieces = 0
    for name in want:
        a = ET.parse(tmp_path / "port" / name).getroot()
        b = ET.parse(tmp_path / "jax" / name).getroot()
        assert tree_of(a) == tree_of(b), name
        head = (tmp_path / "port" / name).read_bytes()[:60]
        assert head.startswith(b"<?xml version='1.0' encoding='utf-8'?>")
        pieces += len(a.findall(".//Piece"))
    assert pieces == sum(len(ls.meshes) for ls in sol.layer_solutions)


@pytest.mark.parametrize("name", ["F.Cu", "a b/c", "  ", "__x__", "In1.Cu"])
def test_sanitize_filename_equal(name):
    used, jused = set(), set()
    for _ in range(3):
        assert (paraview.sanitize_filename(name, used)
                == jparaview.sanitize_filename(name, jused))
    assert used == jused


def test_html_payload_and_bytes_equal(solutions, tmp_path):
    sol, jsol = solutions
    assert htmlview._solution_payload(sol) == jhtmlview._solution_payload(
        jsol)
    htmlview.export_html(sol, tmp_path / "port.html")
    jhtmlview.export_html(jsol, tmp_path / "jax.html")
    got = (tmp_path / "port.html").read_bytes()
    assert got == (tmp_path / "jax.html").read_bytes()
    assert b"webgl" in got and len(got) > 5000


def test_html_chunked_mesh_equal():
    """A mesh past the u16 index limit goes out in chunks: the port's
    encoder gives the JAX package's entries."""
    rng = np.random.default_rng(3)
    g = 300                                   # 90,000 vertices > 65,000
    xs, ys = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel()], 1) + rng.random((g * g, 2)) / 4
    idx = np.arange(g * g).reshape(g, g)
    a, b, c, d = (idx[:-1, :-1].ravel(), idx[1:, :-1].ravel(),
                  idx[:-1, 1:].ravel(), idx[1:, 1:].ravel())
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])
    vv, fv = rng.random(g * g), rng.random(len(tris))
    got = htmlview._encode_mesh(verts, tris, vvals=vv, fvals=fv)
    want = jhtmlview._encode_mesh(verts, tris, vvals=vv, fvals=fv)
    assert len(got) > 1 and got == want
