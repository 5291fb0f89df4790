"""Solver pipeline of the port: host pre-passes, assembly, device solve,
fields.

The host pre-passes (connectivity, meshing, vertex/node indexing, dead
network filtering) and the result types are carried from
padne_tpu.solver unchanged (they contain no JAX).  Assembly builds the
port's CoreSystem; `solve` routes it through ops.schur.solve_bordered
(host direct, DIA or ELL, as the JAX package routes) on torch tensors and
returns this module's Solution.

Variable layout matches the reference system ordering:

    [ mesh vertices... | internal nodes... ]  -> "core" (size n)
    [ extra source variables... | ground ]    -> "border" (size m)
"""

from __future__ import annotations

import logging
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import device as device_mod
from . import geom, mesh, problem
from .ops import assembly, postproc, schur
from .utils.validation import checked

log = logging.getLogger(__name__)

DTYPE = np.float64


class SolverWarning(Warning):
    """Non-fatal solver diagnostics (e.g. nonzero ground current),
    parity with reference solver.py:24-30."""


@dataclass(frozen=True)
class SolverInfo:
    ground_node_current: float
    residual_norm: float
    cg_iterations: int = 0
    system_size: int = 0
    refinement_steps: int = 0


@dataclass
class LayerSolution:
    meshes: list[mesh.TriMesh]
    potentials: list[mesh.ZeroForm]
    power_densities: list[mesh.TwoForm] = field(default_factory=list)
    disconnected_meshes: list[mesh.TriMesh] = field(default_factory=list)


@dataclass
class Solution:
    problem: problem.Problem
    layer_solutions: list[LayerSolution]
    solver_info: SolverInfo


# ---------------------------------------------------------------------------
# Connectivity pre-pass (host; reference solver.py:55-148)
# ---------------------------------------------------------------------------
def construct_indices_from_layers(layers: list[problem.Layer]) -> list[geom.BBoxIndex]:
    return [geom.BBoxIndex(layer.geoms) for layer in layers]


class ConnectivityGraph:
    """Graph over (layer_i, geom_i) copper polygons, wired together by the
    lumped networks; source-bearing networks mark roots."""

    def __init__(self, num_nodes_per_layer: list[int]):
        self.offsets = np.concatenate([[0], np.cumsum(num_nodes_per_layer)])
        total = int(self.offsets[-1])
        self.adj: list[set[int]] = [set() for _ in range(total)]
        self.is_root = np.zeros(total, dtype=bool)

    def node(self, layer_i: int, geom_i: int) -> int:
        return int(self.offsets[layer_i]) + geom_i

    @classmethod
    def create_from_problem(
        cls, prob: problem.Problem, indices: list[geom.BBoxIndex]
    ) -> "ConnectivityGraph":
        g = cls([len(layer.geoms) for layer in prob.layers])
        layer_pos = {id(layer): i for i, layer in enumerate(prob.layers)}
        # Batched containment: via-dense boards issue ~100k (connection,
        # candidate-geom) point tests; per-layer bbox broadcast + one
        # classify call per touched geometry replaces the per-point
        # native round-trips.
        pts_by_layer: list[list] = [[] for _ in prob.layers]  # (x, y, net_i)
        for net_i, network in enumerate(prob.networks):
            for conn in network.connections:
                layer_i = layer_pos[id(conn.layer)]
                pts_by_layer[layer_i].append(
                    (conn.point.x, conn.point.y, net_i))
        nodes_by_network: list[list[int]] = [[] for _ in prob.networks]
        for layer_i, items in enumerate(pts_by_layer):
            if not items:
                continue
            arr = np.array([(x, y) for x, y, _ in items])
            nets = np.array([n for _, _, n in items], dtype=np.int64)
            pt_idx, geom_idx = indices[layer_i].query_points(arr)
            layer = prob.layers[layer_i]
            for geom_i in np.unique(geom_idx):
                sel = pt_idx[geom_idx == geom_i]
                cls_ = layer.geoms[geom_i].classify_points(arr[sel])
                nid = g.node(layer_i, int(geom_i))
                for net_i in nets[sel[cls_ >= 1]]:
                    nodes_by_network[int(net_i)].append(nid)
        for net_i, network in enumerate(prob.networks):
            # Dedup first: via-dense nets repeat the same few geoms
            # thousands of times (one entry per connection), and the
            # wiring below must stay O(unique geoms).  Element-less
            # networks (PROBE seeds) wire geoms too — reference
            # behavior (create_from_problem wires every network's
            # connections, solver.py:108-129).
            nodes_here = sorted(set(nodes_by_network[net_i]))
            if network.has_source:
                for nid in nodes_here:
                    g.is_root[nid] = True
            # A network makes its geoms one connected clique; a star to
            # the first node yields the same connected components in
            # O(k) instead of the clique's O(k^2) edges.
            for b in nodes_here[1:]:
                g.adj[nodes_here[0]].add(b)
                g.adj[b].add(nodes_here[0])
        return g

    def compute_connected_nodes(self) -> set[int]:
        open_set = set(np.nonzero(self.is_root)[0].tolist())
        closed: set[int] = set()
        while open_set:
            n = open_set.pop()
            closed.add(n)
            for nb in self.adj[n]:
                if nb not in closed:
                    open_set.add(nb)
        return closed

    def connected_layer_geom_pairs(self) -> set[tuple[int, int]]:
        pairs = set()
        for n in self.compute_connected_nodes():
            layer_i = int(np.searchsorted(self.offsets, n, side="right")) - 1
            pairs.add((layer_i, n - int(self.offsets[layer_i])))
        return pairs


@checked
def compute_connectivity(prob: problem.Problem):
    """Returns (bbox_indices, graph, connected_layer_geom_pairs)."""
    indices = construct_indices_from_layers(prob.layers)
    g = ConnectivityGraph.create_from_problem(prob, indices)
    return indices, g, g.connected_layer_geom_pairs()


# ---------------------------------------------------------------------------
# Meshing orchestration (reference solver.py:151-347)
# ---------------------------------------------------------------------------
def collect_seed_points(prob: problem.Problem, layer: problem.Layer) -> list[geom.Point]:
    return [
        conn.point
        for network in prob.networks
        for conn in network.connections
        if conn.layer is layer
    ]


def generate_meshes_for_problem(
    prob: problem.Problem,
    mesher: mesh.Mesher,
    connected_pairs: set[tuple[int, int]],
    indices: list[geom.BBoxIndex],
):
    """Mesh every live polygon.  Polygons are triangulated in parallel
    host threads: the native core is stateless and the ctypes call
    releases the GIL, so a multi-layer board meshes at
    wall-clock ~= slowest polygon instead of the serial sum (the
    reference meshes serially, solver.py:263-318).  Output order is
    deterministic (layer, then geometry index)."""
    jobs = []   # (layer_i, polygon, seeds) in deterministic order
    for layer_i, layer in enumerate(prob.layers):
        seeds = collect_seed_points(prob, layer)
        geom_seeds: dict[int, list[geom.Point]] = {}
        for sp in seeds:
            for geom_i in indices[layer_i].query_point(sp):
                geom_i = int(geom_i)
                if (layer_i, geom_i) not in connected_pairs:
                    continue
                # Interior-only: boundary connection points must already be
                # polygon vertices (reference invariant, solver.py:299-308).
                if not layer.geoms[geom_i].contains(sp):
                    continue
                geom_seeds.setdefault(geom_i, []).append(sp)
        for geom_i, g in enumerate(layer.geoms):
            if (layer_i, geom_i) not in connected_pairs:
                continue
            jobs.append((layer_i, g, geom_seeds.get(geom_i, [])))

    if len(jobs) > 1:
        import os
        from concurrent.futures import ThreadPoolExecutor, as_completed

        ncpu = os.cpu_count() or 1
        workers = min(len(jobs), ncpu, 16)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [pool.submit(mesher.poly_to_mesh, j[1], j[2])
                    for j in jobs]
            if ncpu > 1:
                # Pipeline meshing with per-mesh FEM derivation (the
                # "PP" slot, SURVEY §2): as each polygon finishes, its
                # edge table + cotan weights (lazy cached_properties
                # consumed by assembly) are derived HERE while the
                # remaining polygons still run in the native CDT
                # threads (ctypes releases the GIL) — assembly work
                # rides inside the meshing wall-clock instead of after
                # it.  On a 1-core host the main-thread numpy work
                # only steals GIL slices from the lone CDT worker
                # (measured 7 -> 20 s at the 1M bench), so the eager
                # derivation is skipped there.
                for f in as_completed(futs):
                    m = f.result()
                    m.edges
                    m.cotan_edge_weights
            meshes = [f.result() for f in futs]
    else:
        meshes = [mesher.poly_to_mesh(g, s) for _, g, s in jobs]
    mesh_to_layer = [layer_i for layer_i, _, _ in jobs]
    return meshes, mesh_to_layer


def generate_disconnected_meshes(
    prob: problem.Problem, connected_pairs: set[tuple[int, int]]
) -> list[list[mesh.TriMesh]]:
    relaxed = mesh.Mesher(mesh.Mesher.Config.RELAXED)
    out: list[list[mesh.TriMesh]] = [[] for _ in prob.layers]
    for layer_i, layer in enumerate(prob.layers):
        for geom_i, g in enumerate(layer.geoms):
            if (layer_i, geom_i) in connected_pairs:
                continue
            out[layer_i].append(relaxed.poly_to_mesh(g))
    return out


# ---------------------------------------------------------------------------
# Indexing (reference solver.py:216-229, 350-466)
# ---------------------------------------------------------------------------
@dataclass
class VertexIndexer:
    """Global vertex index = mesh_offsets[mesh_i] + local index."""

    mesh_offsets: np.ndarray  # (num_meshes + 1,)

    @classmethod
    def create(cls, meshes: list[mesh.TriMesh]) -> "VertexIndexer":
        sizes = [m.num_vertices for m in meshes]
        return cls(mesh_offsets=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64))

    @property
    def total(self) -> int:
        return int(self.mesh_offsets[-1])

    def global_index(self, mesh_i: int, vertex_i: int) -> int:
        return int(self.mesh_offsets[mesh_i]) + vertex_i


def network_has_a_dead_terminal(
    network: problem.Network,
    prob: problem.Problem,
    connected_pairs: set[tuple[int, int]],
    indices: list[geom.BBoxIndex],
) -> bool:
    layer_pos = {id(layer): i for i, layer in enumerate(prob.layers)}
    for conn in network.connections:
        layer_i = layer_pos[id(conn.layer)]
        for geom_i in indices[layer_i].query_point(conn.point):
            geom_i = int(geom_i)
            if (layer_i, geom_i) in connected_pairs:
                continue
            if not conn.layer.geoms[geom_i].intersects(conn.point):
                continue
            return True
    return False


def filter_dead_networks(
    prob: problem.Problem,
    indices: list[geom.BBoxIndex],
    connected_pairs: set[tuple[int, int]],
) -> list[problem.Network]:
    """Drop networks with any terminal on dead copper (reference
    solver.py:654-668)."""
    return [
        net
        for net in prob.networks
        if not network_has_a_dead_terminal(net, prob, connected_pairs, indices)
    ]


@dataclass
class NodeIndexer:
    """Maps NodeIDs to global system indices.

    Connection nodes snap to the nearest mesh vertex on their layer
    (KD-tree, reference solver.py:350-466); internal nodes get fresh
    indices after all mesh vertices.
    """

    node_to_index: dict
    internal_node_count: int
    core_size: int

    @classmethod
    def create(
        cls,
        prob: problem.Problem,
        meshes: list[mesh.TriMesh],
        mesh_to_layer: list[int],
        vindex: VertexIndexer,
        networks: list[problem.Network],
    ) -> "NodeIndexer":
        import scipy.spatial

        layer_pos = {id(layer): i for i, layer in enumerate(prob.layers)}
        # Per-layer vertex pools for nearest-vertex snapping.
        layer_points = {}
        layer_globals = {}
        n_queries = np.zeros(len(prob.layers), dtype=np.int64)
        for network in networks:
            for conn in network.connections:
                n_queries[layer_pos[id(conn.layer)]] += 1
        for layer_i in range(len(prob.layers)):
            pts = []
            gids = []
            for mesh_i, m in enumerate(meshes):
                if mesh_to_layer[mesh_i] != layer_i:
                    continue
                base = vindex.mesh_offsets[mesh_i]
                pts.append(m.vertices)
                gids.append(np.arange(base, base + m.num_vertices))
            if not pts:
                continue
            layer_globals[layer_i] = np.concatenate(gids)
            pv = np.concatenate(pts)
            # A KD-tree build costs ~0.25 s per 1M-vertex layer; with
            # only a few connection queries a vectorized argmin over
            # the pool is cheaper (the snap RESULT is the same nearest
            # vertex either way; reference KD-tree: solver.py:398-466).
            # Via-dense boards carry thousands of connections, where
            # the tree wins decisively — keep the brute-force window
            # small.
            if n_queries[layer_i] * len(pv) <= 30_000_000:
                layer_points[layer_i] = pv
            else:
                layer_points[layer_i] = scipy.spatial.cKDTree(
                    pv, leafsize=32)

        node_to_index: dict = {}
        for network in networks:
            for conn in network.connections:
                layer_i = layer_pos[id(conn.layer)]
                if layer_i not in layer_globals:
                    # No meshes on this layer: the connection node falls
                    # through to the internal-variable pool below, i.e.
                    # it floats.  Loud, because a source wired to it
                    # will silently drive nothing.
                    log.warning(
                        "Connection at (%.3f, %.3f) on layer %r has no "
                        "mesh to attach to; its node is left floating",
                        conn.point.x, conn.point.y, conn.layer.name)
                    continue
                pool = layer_points[layer_i]
                if isinstance(pool, np.ndarray):
                    k = int(np.argmin(
                        (pool[:, 0] - conn.point.x) ** 2
                        + (pool[:, 1] - conn.point.y) ** 2))
                else:
                    _, k = pool.query([conn.point.x, conn.point.y])
                gidx = int(layer_globals[layer_i][k])
                # The mesher guarantees connection points become mesh
                # vertices (interior-seed invariant), so the snap
                # distance is float noise for well-formed problems.  A
                # large snap means the point sits off its copper and
                # just grabbed the closest vertex of SOME mesh on the
                # layer — possibly electrically unrelated.
                v = (pool[k] if isinstance(pool, np.ndarray)
                     else pool.data[k])
                snap2 = ((float(v[0]) - conn.point.x) ** 2
                         + (float(v[1]) - conn.point.y) ** 2)
                if snap2 > 1e-4:            # 10 um
                    log.warning(
                        "Connection at (%.3f, %.3f) on layer %r snapped "
                        "%.3g mm to the nearest mesh vertex — check that "
                        "the point lies on its copper",
                        conn.point.x, conn.point.y, conn.layer.name,
                        float(np.sqrt(snap2)))
                prev = node_to_index.get(conn.node_id)
                if prev is not None and prev != gidx:
                    raise ValueError(
                        f"connection node maps to two distinct mesh "
                        f"vertices ({prev} and {gidx}); the loader must "
                        f"emit one Connection per node"
                    )
                node_to_index[conn.node_id] = gidx

        # Internal nodes (terminals with no connection).  Deduplicate
        # across networks: a NodeID shared by two networks' elements
        # must map to ONE system index (a duplicate would become an
        # orphaned zero row and a spurious floating component).
        internal = []
        seen = set(node_to_index)
        for network in networks:
            for node in network.nodes:
                if node not in seen:
                    seen.add(node)
                    internal.append(node)
        at = vindex.total
        for node in internal:
            node_to_index[node] = at
            at += 1
        return cls(
            node_to_index=node_to_index,
            internal_node_count=len(internal),
            core_size=at,
        )


# ---------------------------------------------------------------------------
# System assembly (host structure + device values; reference 469-560)
# ---------------------------------------------------------------------------

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


def system_to_scipy(system) -> tuple:
    """Full sparse system in reference layout [core | border] for
    cross-checking against a scipy direct solve: L z = r with
    L = [[-A, C], [B, 0]] (ops.schur.bordered_scipy_system)."""
    L, r, *_ = schur.bordered_scipy_system(system)
    return L, r


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


# Systems from this many core unknowns go to a resident server when one
# answers; smaller ones solve locally faster than they cross the socket.
SERVE_MIN_N = 200_000


def _served(system, dev, stats: dict):
    """The system solved by a resident server (see `solve`), or None."""
    import os
    import pathlib

    from . import serve

    if (system.n < SERVE_MIN_N
            or os.environ.get("PADNE_TORCH_SERVER", "1") == "0"):
        return None
    path = serve.default_socket_path()
    if not pathlib.Path(path).exists():
        return None
    result = serve.client_solve(system, target_residual=1e-10,
                                max_refinements=8, socket_path=path,
                                device=dev, stats=stats)
    if result is not None:
        stats.update(route="dia", levels=[])
    return result


def solve(
    prob: problem.Problem,
    mesher_config: Optional[mesh.Mesher.Config] = None,
    check_against_scipy: bool = False,
    device=None,
    stats: Optional[dict] = None,
    device_mesh=None,
) -> Solution:
    """Solve a problem end-to-end on `device` (None: the CUDA card; see
    padne_tpu_torch.device).

    device_mesh: optional parallel.sharding.Mesh; with more than one
    device the inner solve row-shards over it (ops.schur.solve_bordered)
    and the mesh's first device takes the place of `device`.  A mesh
    skips the resident-server dispatch, as in the JAX package.

    The system goes through ops.schur.solve_bordered as the JAX package
    sends it there: the card plays the accelerator (f32 inner solves
    with f64 refinement), the CPU runs the inner solves in f64.

    A system of SERVE_MIN_N core unknowns or more is shipped to a
    resident server (padne_tpu_torch.serve) when one answers on its
    socket and runs on this call's device type; PADNE_TORCH_SERVER=0
    turns that off.  A server that declines or fails is logged at
    WARNING and the system solves here, on the same device and kernels.

    stats: optional dict that receives the stage wall times in seconds
    (mesh_assemble_s, setup_s, solve_s, postproc_s), the system shape
    (n, m, levels), the route ("direct", "dia" or "ell"), served_by (the
    server's pid, or None when solved in this process) and, with
    check_against_scipy, scipy_max_dv.  For a served solve, setup_s is
    the server's set-up (0 on a cached operator), server_solve_s its
    solve and solve_s the rest of the round trip."""
    if device_mesh is not None and device_mesh.size > 1:
        device = device_mesh.devices[0]
    else:
        device_mesh = None
    dev = device_mod.resolve(device)
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    system, meshes, mesh_to_layer, vindex, disconnected = build_system(
        prob, mesher_config
    )
    t1 = time.perf_counter()
    result = None if device_mesh is not None else _served(system, dev, stats)
    if result is None:
        stats["served_by"] = None
        inner_dtype = torch.float32 if dev.type == "cuda" else None
        result = schur.solve_bordered(system, inner_dtype=inner_dtype,
                                      device=dev, stats=stats,
                                      mesh=device_mesh)
    t3 = time.perf_counter()
    stats.update(n=system.n, m=system.border.m, mesh_assemble_s=t1 - t0,
                 solve_s=t3 - t1 - stats["setup_s"])
    log.info("Solved on the %s route%s in %.2f s: residual %.3e, %d CG "
             "iterations", stats["route"],
             "" if stats["served_by"] is None
             else f" by the server (pid {stats['served_by']})",
             t3 - t1, result.residual_norm, result.cg_iterations)

    if check_against_scipy:
        import scipy.sparse.linalg

        L, r = system_to_scipy(system)
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
