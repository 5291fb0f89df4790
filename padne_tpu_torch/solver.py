"""Solver pipeline of the port: host pre-passes, assembly, device solve,
fields.

The host pre-passes (connectivity, meshing, vertex/node indexing, dead
network filtering) and the result types are padne_tpu.solver's own — they
contain no JAX.  Assembly builds the port's CoreSystem, the solve runs
the DIA route of ops.schur on torch tensors, and `solve` returns the
same padne_tpu.solver.Solution type the JAX package returns.

Variable layout matches the reference system ordering:

    [ mesh vertices... | internal nodes... ]  -> "core" (size n)
    [ extra source variables... | ground ]    -> "border" (size m)
"""

from __future__ import annotations

import logging
import time
import warnings
from typing import Optional

import numpy as np

from padne_tpu import mesh, problem
from padne_tpu.solver import (
    DTYPE,
    LayerSolution,
    NodeIndexer,
    Solution,
    SolverInfo,
    SolverWarning,
    VertexIndexer,
    compute_connectivity,
    filter_dead_networks,
    generate_disconnected_meshes,
    generate_meshes_for_problem,
)

from . import device as device_mod
from .ops import assembly, postproc, schur

log = logging.getLogger(__name__)


def assemble_core_system(
    prob: problem.Problem,
    meshes: list[mesh.TriMesh],
    mesh_to_layer: list[int],
    vindex: VertexIndexer,
    networks: list[problem.Network],
    node_indexer: NodeIndexer,
):
    """Build the CoreSystem (ELL Laplacian + MNA border spec)."""
    n = node_indexer.core_size

    # Mesh edges with conductance-scaled cotan weights.
    edge_list = []
    weight_list = []
    for mesh_i, m in enumerate(meshes):
        conductance = prob.layers[mesh_to_layer[mesh_i]].conductance
        base = int(vindex.mesh_offsets[mesh_i])
        edge_list.append(m.edges.astype(np.int64) + base)
        weight_list.append(m.cotan_edge_weights * conductance)

    # Lumped resistor stamps are conductance edges in the same operator.
    border_rows = []  # (k, node, val)
    border_cols = []
    border_rhs = []
    extra_var_elements = []

    for network in networks:
        for element in network.elements:
            if isinstance(element, problem.Resistor):
                ia = node_indexer.node_to_index[element.a]
                ib = node_indexer.node_to_index[element.b]
                if ia != ib:
                    edge_list.append(np.array([[ia, ib]], dtype=np.int64))
                    weight_list.append(np.array([1.0 / element.resistance]))
            elif isinstance(element, problem.CurrentSource):
                pass  # handled in rhs below
            elif isinstance(element, problem.VoltageSource):
                k = len(extra_var_elements)
                extra_var_elements.append(element)
                ip = node_indexer.node_to_index[element.p]
                inn = node_indexer.node_to_index[element.n]
                border_rows += [(k, ip, 1.0), (k, inn, -1.0)]
                border_cols += [(k, ip, 1.0), (k, inn, -1.0)]
                border_rhs.append(element.voltage)
            elif isinstance(element, problem.VoltageRegulator):
                k = len(extra_var_elements)
                extra_var_elements.append(element)
                ip = node_indexer.node_to_index[element.v_p]
                inn = node_indexer.node_to_index[element.v_n]
                isf = node_indexer.node_to_index[element.s_f]
                ist = node_indexer.node_to_index[element.s_t]
                border_rows += [(k, ip, 1.0), (k, inn, -1.0)]
                border_cols += [
                    (k, ip, 1.0),
                    (k, inn, -1.0),
                    (k, isf, element.gain),
                    (k, ist, -element.gain),
                ]
                border_rhs.append(element.voltage)
            else:
                raise NotImplementedError(f"Unsupported element {element}")

    # Current sources -> core RHS (reference sign: r[i_f] += I, r[i_t] -= I).
    r_core = np.zeros(n, dtype=DTYPE)
    for network in networks:
        for element in network.elements:
            if isinstance(element, problem.CurrentSource):
                r_core[node_indexer.node_to_index[element.f]] += element.current
                r_core[node_indexer.node_to_index[element.t]] -= element.current

    # Ground pin: the highest-voltage VoltageSource's negative terminal
    # (regulators excluded, as in the reference), default node 0.
    ground_node = 0
    best_v = -np.inf
    for network in networks:
        for element in network.elements:
            if (isinstance(element, problem.VoltageSource)
                    and element.voltage > best_v):
                best_v = element.voltage
                ground_node = node_indexer.node_to_index[element.n]
    g = len(extra_var_elements)
    border_rows.append((g, ground_node, 1.0))
    border_cols.append((g, ground_node, 1.0))
    border_rhs.append(0.0)

    if edge_list:
        edges = np.concatenate(edge_list)
        weights = np.concatenate(weight_list)
    else:
        edges = np.zeros((0, 2), dtype=np.int64)
        weights = np.zeros(0, dtype=DTYPE)

    ell = assembly.build_ell(n, edges, weights)
    comp_id, num_comp = assembly.connected_components(n, edges, weights)

    # Node coordinates and mesh id (the primary ordering key) for the
    # Hilbert-ordered DIA path: mesh vertices carry their positions;
    # internal lumped nodes borrow those of a node they share an edge with.
    coords = np.zeros((n, 2))
    group = np.zeros(n, dtype=np.int64)
    nv = vindex.total
    if meshes:
        coords[:nv] = np.concatenate([m.vertices for m in meshes])
        group[:nv] = np.repeat(
            np.arange(len(meshes), dtype=np.int64),
            [m.num_vertices for m in meshes],
        )
    if n > nv and len(edges):
        internal = (edges >= nv)
        for a_col, b_col in ((0, 1), (1, 0)):
            sel = internal[:, a_col] & ~internal[:, b_col]
            coords[edges[sel, a_col]] = coords[edges[sel, b_col]]
            group[edges[sel, a_col]] = group[edges[sel, b_col]]

    border = schur.BorderSpec(
        m=g + 1,
        row_idx=np.array([x[0] for x in border_rows], dtype=np.int64),
        row_node=np.array([x[1] for x in border_rows], dtype=np.int64),
        row_val=np.array([x[2] for x in border_rows], dtype=DTYPE),
        col_idx=np.array([x[0] for x in border_cols], dtype=np.int64),
        col_node=np.array([x[1] for x in border_cols], dtype=np.int64),
        col_val=np.array([x[2] for x in border_cols], dtype=DTYPE),
        rhs=np.array(border_rhs, dtype=DTYPE),
    )
    system = schur.CoreSystem(
        n=n, ell=ell, comp_id=comp_id, num_components=num_comp,
        border=border, r_core=r_core, ground_var=g, coords=coords,
        group=group,
    )
    return system, extra_var_elements


def produce_layer_solutions(layers, vindex, meshes, mesh_to_layer, v,
                            disconnected_by_layer,
                            device) -> list[LayerSolution]:
    """Per-layer potentials and power densities (one batched device call
    over all meshes)."""
    all_vals = [
        v[int(vindex.mesh_offsets[i]):
          int(vindex.mesh_offsets[i]) + m.num_vertices]
        for i, m in enumerate(meshes)
    ]
    all_cond = [layers[mesh_to_layer[i]].conductance
                for i in range(len(meshes))]
    all_pd = postproc.power_density_batch(meshes, all_vals, all_cond,
                                          device)

    layer_solutions = []
    for layer_i, layer in enumerate(layers):
        l_meshes, l_pots, l_power = [], [], []
        for mesh_i, m in enumerate(meshes):
            if mesh_to_layer[mesh_i] != layer_i:
                continue
            l_meshes.append(m)
            l_pots.append(mesh.ZeroForm(m, all_vals[mesh_i]))
            l_power.append(mesh.TwoForm(m, all_pd[mesh_i]))
        layer_solutions.append(
            LayerSolution(
                meshes=l_meshes,
                potentials=l_pots,
                power_densities=l_power,
                disconnected_meshes=disconnected_by_layer[layer_i],
            )
        )
    return layer_solutions


def build_system(prob: problem.Problem,
                 mesher_config: Optional[mesh.Mesher.Config] = None):
    """The host pipeline up to the assembled system: connectivity,
    meshing, indexing, dead-network filtering, FEM/MNA assembly.

    Returns (system, meshes, mesh_to_layer, vindex, disconnected)."""
    mesher = mesh.Mesher(mesher_config)
    indices, _, connected_pairs = compute_connectivity(prob)
    meshes, mesh_to_layer = generate_meshes_for_problem(
        prob, mesher, connected_pairs, indices
    )
    disconnected = generate_disconnected_meshes(prob, connected_pairs)
    vindex = VertexIndexer.create(meshes)
    filtered = filter_dead_networks(prob, indices, connected_pairs)
    node_indexer = NodeIndexer.create(prob, meshes, mesh_to_layer, vindex,
                                      filtered)
    system, _ = assemble_core_system(
        prob, meshes, mesh_to_layer, vindex, filtered, node_indexer
    )
    log.info("System: %d core + %d border variables, %d components",
             system.n, system.border.m, system.num_components)
    return system, meshes, mesh_to_layer, vindex, disconnected


def solve(
    prob: problem.Problem,
    mesher_config: Optional[mesh.Mesher.Config] = None,
    check_against_scipy: bool = False,
    device=None,
    stats: Optional[dict] = None,
) -> Solution:
    """Solve a problem end-to-end on `device` (None: the CUDA card; see
    padne_tpu_torch.device).

    stats: optional dict that receives the stage wall times in seconds
    (mesh_assemble_s, setup_s, solve_s, postproc_s), the system shape
    (n, m, levels) and, with check_against_scipy, scipy_max_dv."""
    dev = device_mod.resolve(device)
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    system, meshes, mesh_to_layer, vindex, disconnected = build_system(
        prob, mesher_config
    )
    t1 = time.perf_counter()
    dia_solver = schur.DiaBorderedSolver(system, device=dev)
    t2 = time.perf_counter()
    result = dia_solver.solve(target_residual=1e-10, max_refinements=8)
    t3 = time.perf_counter()
    stats.update(
        n=system.n, m=system.border.m,
        levels=[lv.pack.np_ for lv in dia_solver.hierarchy.levels],
        mesh_assemble_s=t1 - t0, setup_s=t2 - t1, solve_s=t3 - t2)

    if check_against_scipy:
        import scipy.sparse.linalg

        L, r, *_ = schur.bordered_scipy_system(system)
        z_ref = scipy.sparse.linalg.spsolve(L, r)
        dv = float(np.abs(z_ref[: system.n] - result.v).max())
        stats["scipy_max_dv"] = dv
        log.info("Max |dV| vs scipy direct solve: %.3e", dv)

    info = SolverInfo(
        ground_node_current=result.ground_current,
        residual_norm=result.residual_norm,
        cg_iterations=result.cg_iterations,
        system_size=system.n + system.border.m,
        refinement_steps=result.refinement_steps,
    )
    if not np.isclose(info.ground_node_current, 0):
        warnings.warn(
            f"Ground node current is not zero ({info.ground_node_current} "
            "A), this may indicate an issue with the problem being solved. "
            "Check for unterminated current loops or floating connected "
            "components.",
            SolverWarning,
        )

    t4 = time.perf_counter()
    layer_solutions = produce_layer_solutions(
        prob.layers, vindex, meshes, mesh_to_layer, result.v, disconnected,
        dev)
    stats["postproc_s"] = time.perf_counter() - t4
    return Solution(
        problem=prob, layer_solutions=layer_solutions, solver_info=info
    )
