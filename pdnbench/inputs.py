"""The benchmark's inputs, made with the frozen host pipeline
(pdnbench/frozen) and never with the program.

A configuration names a generated board and its mesher settings.  Its
geometry is fixed by the configuration; a request changes only values
(copper weight of each layer, source and load values), taken from a
fixed set that the seed puts in its own order.  So the
assembled system is made once per checkout and kept in a fixed cache
directory (`CACHE`), written under a temporary name and renamed; later
runs load it.  Values are applied to the cached arrays:

- a layer's copper weight scales the conductance of that layer's mesh
  edges (a layer's conductance is linear in its copper thickness), and
  `variant_ell` packs the scaled edges with the frozen assembly;
- source and load values scale the nominal values in `excitation`,
  accumulated in the order of the frozen assembly, so that scales of 1
  give its arrays bit for bit.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import pathlib
import re

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
CACHE = HERE / ".cache" / "inputs"
FROZEN = HERE / "frozen"

_COPPER = re.compile(r'\(layer "(?P<name>[^"]+)" \(type "copper"\) '
                     r'\(thickness (?P<t>[0-9.]+)\)\)')
_VOLTAGE = re.compile(r"(!padne VOLTAGE v=)(?P<v>[0-9.]+)V")
_CURRENT = re.compile(r"(!padne CURRENT i=)(?P<v>[0-9.]+)A")


def write_board(config: dict, out_dir, layer_weights=None,
                current_scale=None, voltage_scale=None) -> pathlib.Path:
    """The configuration's KiCad project written under out_dir (its
    .kicad_pro path), with each copper layer's thickness times its
    weight (in the configuration's `copper_layers` order) and each
    CURRENT and VOLTAGE directive's value times its scale (in the order
    of the schematic)."""
    from .frozen import boardgen

    board = config["board"]
    gen = getattr(boardgen, board["generator"])
    pro = pathlib.Path(gen(out_dir, **board.get("args", {})))
    pcb, sch = pro.with_suffix(".kicad_pcb"), pro.with_suffix(".kicad_sch")
    if layer_weights is not None:
        weight = dict(zip(config["copper_layers"], layer_weights))

        def thick(m):
            t = float(m["t"]) * float(weight[m["name"]])
            return m[0].replace(f"(thickness {m['t']})",
                                f"(thickness {t!r})")

        pcb.write_text(_COPPER.sub(thick, pcb.read_text()))
    text = sch.read_text()
    for pattern, scales, unit in ((_CURRENT, current_scale, "A"),
                                  (_VOLTAGE, voltage_scale, "V")):
        if scales is None:
            continue
        it = iter(scales)
        text = pattern.sub(
            lambda m: f"{m[1]}{float(m['v']) * float(next(it))!r}{unit}", text)
    sch.write_text(text)
    return pro


def source_counts(pro) -> tuple[int, int]:
    """(CURRENT, VOLTAGE) directives in a project's schematic."""
    text = pathlib.Path(pro).with_suffix(".kicad_sch").read_text()
    return len(_CURRENT.findall(text)), len(_VOLTAGE.findall(text))


def mesher_settings(config: dict, prob) -> dict:
    """Keyword arguments of Mesher.Config for this configuration:
    the `mesher` entry as given, or, with `target_dof`, the bench size
    rule: maximum_size = max(0.05, sqrt(area / (0.43 target_dof))) over
    the summed layer areas, with a uniform density."""
    kw = dict(config["mesher"])
    target = kw.pop("target_dof", None)
    if target is not None:
        area = sum(layer.shape.area for layer in prob.layers)
        kw["maximum_size"] = max(0.05, (area / (0.43 * target)) ** 0.5)
    return kw


class Inputs:
    """The assembled system of a configuration at nominal values, with
    what its variants need: host arrays, read as attributes."""

    def __init__(self, arrays: dict):
        self.__dict__.update(arrays)

    @property
    def n(self) -> int:
        return int(self.__dict__["n"])

    @property
    def m(self) -> int:
        return len(self.b_rhs)

    def ell(self):
        """The frozen EllMatrix of the nominal system."""
        from .frozen import assembly

        return assembly.EllMatrix(cols=self.ell_cols, vals=self.ell_vals,
                                  diag=self.ell_diag)


def assemble(prob, mesher_kw: dict) -> dict:
    """The frozen host pipeline on a loaded problem: the arrays of its
    CoreSystem, each mesh edge's layer (-1 for lumped resistors), the
    current sources in the order their right-hand side accumulates, and
    the vertices of each mesh by layer."""
    from .frozen import mesh, problem
    from .frozen import system as fs

    mesher = mesh.Mesher(mesh.Mesher.Config(**mesher_kw))
    indices, _, pairs = fs.compute_connectivity(prob)
    meshes, m2l = fs.generate_meshes_for_problem(prob, mesher, pairs,
                                                 indices)
    vindex = fs.VertexIndexer.create(meshes)
    nets = fs.filter_dead_networks(prob, indices, pairs)
    nix = fs.NodeIndexer.create(prob, meshes, m2l, vindex, nets)
    system, _ = fs.assemble_core_system(prob, meshes, m2l, vindex, nets,
                                        nix)
    # The edges and weights as assemble_core_system lists them.
    edges, weights, layer = [], [], []
    for mesh_i, m in enumerate(meshes):
        base = int(vindex.mesh_offsets[mesh_i])
        edges.append(m.edges.astype(np.int64) + base)
        weights.append(m.cotan_edge_weights
                       * prob.layers[m2l[mesh_i]].conductance)
        layer.append(np.full(len(m.edges), m2l[mesh_i], np.int8))
    cur = []
    for network in nets:
        for el in network.elements:
            if isinstance(el, problem.Resistor):
                ia, ib = nix.node_to_index[el.a], nix.node_to_index[el.b]
                if ia != ib:
                    edges.append(np.array([[ia, ib]], dtype=np.int64))
                    weights.append(np.array([1.0 / el.resistance]))
                    layer.append(np.array([-1], np.int8))
    for network in nets:
        for el in network.elements:
            if isinstance(el, problem.CurrentSource):
                cur.append((nix.node_to_index[el.f], nix.node_to_index[el.t],
                            el.current))
    b = system.border
    return dict(
        n=np.int64(system.n), edges=np.concatenate(edges),
        weights=np.concatenate(weights), edge_layer=np.concatenate(layer),
        comp_id=system.comp_id, num_components=np.int64(
            system.num_components), ground_var=np.int64(system.ground_var),
        coords=system.coords, group=system.group, r_core=system.r_core,
        b_row_idx=b.row_idx, b_row_node=b.row_node, b_row_val=b.row_val,
        b_col_idx=b.col_idx, b_col_node=b.col_node, b_col_val=b.col_val,
        b_rhs=b.rhs, ell_cols=system.ell.cols, ell_vals=system.ell.vals,
        ell_diag=system.ell.diag,
        cur_f=np.array([c[0] for c in cur], np.int64),
        cur_t=np.array([c[1] for c in cur], np.int64),
        cur_i=np.array([c[2] for c in cur], np.float64),
        mesh_layer=np.array(m2l, np.int64),
        mesh_vertices=np.array([m.num_vertices for m in meshes], np.int64))


def _key(config: dict) -> str:
    h = hashlib.sha256(json.dumps(
        {k: config[k] for k in ("board", "mesher", "copper_layers")},
        sort_keys=True).encode())
    for p in sorted(FROZEN.rglob("*")):
        if p.suffix in (".py", ".h", ".cpp"):
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load_problem(config: dict, out_dir, **values):
    """The configuration's board written under out_dir and loaded by
    the frozen KiCad loader."""
    from .frozen import kicad

    return kicad.load_kicad_project(write_board(config, out_dir, **values))


def base_inputs(config: dict, tmp_dir) -> Inputs:
    """The configuration's assembled system at nominal values: from the
    cache, or made with the frozen pipeline (the board written under
    tmp_dir) and cached."""
    path = CACHE / f"{config['name']}-{_key(config)}.npz"
    if path.exists():
        with np.load(path, allow_pickle=False) as z:
            return Inputs({k: z[k] for k in z.files})
    prob = load_problem(config, tmp_dir)
    names = [layer.name for layer in prob.layers]
    if names != config["copper_layers"]:
        raise RuntimeError(f"{config['name']}: the board's layers are "
                           f"{names}, the configuration's copper_layers "
                           f"{config['copper_layers']}")
    arrays = assemble(prob, mesher_settings(config, prob))
    expect = config.get("n")
    if expect is not None and int(arrays["n"]) != expect:
        raise RuntimeError(f"{config['name']}: the frozen pipeline made "
                           f"{int(arrays['n'])} unknowns, the configuration "
                           f"states {expect}")
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return Inputs(arrays)


def variant_ell(inp: Inputs, layer_weights):
    """The frozen assembly's ELL matrix with each layer's mesh edges
    scaled by its weight (lumped resistors unscaled); weights of 1 give
    the nominal matrix bit for bit."""
    from .frozen import assembly

    scale = np.append(np.asarray(layer_weights, np.float64), 1.0)
    return assembly.build_ell(inp.n, inp.edges,
                              inp.weights * scale[inp.edge_layer])


def excitation(inp: Inputs, current_scale, voltage_scale):
    """(r_core, rhs) with each current source and each voltage source
    (border rows before the ground pin) scaled."""
    r = np.zeros(inp.n)
    for f, t, i, s in zip(inp.cur_f, inp.cur_t, inp.cur_i, current_scale):
        r[f] += i * s
        r[t] -= i * s
    rhs = inp.b_rhs.copy()
    rhs[:len(voltage_scale)] *= voltage_scale
    return r, rhs


def source_levels(traffic: dict, n_current: int, n_voltage: int) -> list:
    """Every (current scales, voltage scales) that puts one of the mix's
    `current_levels` on each current source and one of its
    `voltage_levels` on each voltage source, in a fixed order: the same
    set for every seed, since the values change the work a solve does
    (its refinement passes)."""
    levels = ([traffic["current_levels"]] * n_current
              + [traffic["voltage_levels"]] * n_voltage)
    return [(np.array(c[:n_current], np.float64),
             np.array(c[n_current:], np.float64))
            for c in itertools.product(*levels)]
