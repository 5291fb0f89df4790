"""Solution artifact: flat-array .npz persistence.

The reference pickles the whole Solution object graph with a custom
half-edge id-flattening protocol (mesh.py:96-105, 238-259).  Here the
mesh IS flat arrays, so the artifact is a single compressed .npz of
arrays plus a JSON manifest — portable, versioned, and loadable without
executing pickled code.
"""

from __future__ import annotations

import json

import numpy as np

from .. import mesh as mesh_mod
from .. import solver as solver_mod
from ..utils.validation import checked

FORMAT_VERSION = 1


@checked
def save_solution(sol: solver_mod.Solution, path) -> None:
    arrays: dict[str, np.ndarray] = {}
    manifest = {
        "format_version": FORMAT_VERSION,
        "project_name": sol.problem.project_name,
        "solver_info": {
            "ground_node_current": sol.solver_info.ground_node_current,
            "residual_norm": sol.solver_info.residual_norm,
            "cg_iterations": sol.solver_info.cg_iterations,
            "system_size": sol.solver_info.system_size,
            "refinement_steps": sol.solver_info.refinement_steps,
        },
        "layers": [],
    }
    for li, (layer, ls) in enumerate(
        zip(sol.problem.layers, sol.layer_solutions)
    ):
        layer_entry = {
            "name": layer.name,
            "conductance": layer.conductance,
            "num_meshes": len(ls.meshes),
            "num_disconnected": len(ls.disconnected_meshes),
        }
        manifest["layers"].append(layer_entry)
        for mi, (m, pot, pd) in enumerate(
            zip(ls.meshes, ls.potentials, ls.power_densities)
        ):
            p = f"L{li}_M{mi}_"
            arrays[p + "vertices"] = m.vertices
            arrays[p + "triangles"] = m.triangles
            arrays[p + "potential"] = pot.values
            arrays[p + "power"] = pd.values
        for di, m in enumerate(ls.disconnected_meshes):
            p = f"L{li}_D{di}_"
            arrays[p + "vertices"] = m.vertices
            arrays[p + "triangles"] = m.triangles
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


@checked
def load_solution(path) -> solver_mod.Solution:
    from .. import geom, problem

    data = np.load(path)
    manifest = json.loads(bytes(data["__manifest__"]).decode())
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"Solution file format {manifest['format_version']} is newer "
            f"than supported ({FORMAT_VERSION})"
        )
    layers = []
    layer_solutions = []
    for li, le in enumerate(manifest["layers"]):
        meshes, pots, pds, disc = [], [], [], []
        for mi in range(le["num_meshes"]):
            p = f"L{li}_M{mi}_"
            m = mesh_mod.TriMesh(
                vertices=data[p + "vertices"], triangles=data[p + "triangles"]
            )
            meshes.append(m)
            pots.append(mesh_mod.ZeroForm(m, data[p + "potential"]))
            pds.append(mesh_mod.TwoForm(m, data[p + "power"]))
        for di in range(le["num_disconnected"]):
            p = f"L{li}_D{di}_"
            disc.append(
                mesh_mod.TriMesh(
                    vertices=data[p + "vertices"],
                    triangles=data[p + "triangles"],
                )
            )
        # Layer geometry is not persisted; a placeholder empty shape keeps
        # the Layer interface intact for viewers/exporters.
        layers.append(
            problem.Layer(
                shape=geom.MultiPolygon([]),
                name=le["name"],
                conductance=le["conductance"],
            )
        )
        layer_solutions.append(
            solver_mod.LayerSolution(
                meshes=meshes,
                potentials=pots,
                power_densities=pds,
                disconnected_meshes=disc,
            )
        )
    si = manifest["solver_info"]
    return solver_mod.Solution(
        problem=problem.Problem(
            layers=layers, networks=[], project_name=manifest["project_name"]
        ),
        layer_solutions=layer_solutions,
        solver_info=solver_mod.SolverInfo(**si),
    )
