"""The whole `padne solve` path short of writing the artifact:
padne_tpu_torch.kicad.load_kicad_project, then
padne_tpu_torch.solver.solve(prob, mesher_config, device) at the
configuration's mesher settings (meshing, assembly, the solve and the
fields), with no server.

Each request is a KiCad project written before the window: the
configuration's board with each copper layer's thickness times one of
the mix's `layer_weights` and source values of one combination of its
source levels (every seed the same set, in its own order).  Checked:
for the sample of answers the harness keeps, every mesh vertex's
potential against the
reference's, which loads and meshes the same project with the frozen
pipeline and solves it with SciPy's direct solver in float64; the
largest gap in volts, against the configuration's `check.max_dv`.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .. import inputs
from ..reference import check


def requests(ctx):
    """(the warm-up project, the request projects): each request the
    configuration's board with the
    k-th of the mix's layer weights and the k-th combination of its
    source levels, in an order drawn from the seed, written under the
    scratch directory."""
    t, config = ctx.traffic, ctx.config
    order = np.random.default_rng(ctx.seed).permutation(
        len(t["layer_weights"]))
    root = pathlib.Path(ctx.tmp_dir)
    warm = inputs.write_board(config, root / "warm")
    levels = inputs.source_levels(t, *inputs.source_counts(warm))
    pool = []
    for k in order:
        cur, volt = levels[k * len(levels) // len(order)]
        pool.append(inputs.write_board(
            config, root / f"v{k}", layer_weights=t["layer_weights"][k],
            current_scale=cur, voltage_scale=volt))
    return warm, pool


def reference_potentials(pro, mesher_kw) -> np.ndarray:
    """The reference's mesh-vertex potentials of a project: loaded and
    meshed by the frozen pipeline, solved by SciPy's direct solver."""
    from ..frozen import kicad

    inp = inputs.Inputs(inputs.assemble(kicad.load_kicad_project(pro),
                                        mesher_kw))
    v, _ = check.Bordered(inp, inp.ell()).direct(inp.r_core, inp.b_rhs)
    return check.vertex_potentials(inp, v)


class Entry:
    def __init__(self, ctx):
        from ..frozen import kicad

        self.ctx = ctx
        self.warm, self.pool = requests(ctx)
        self.mesher_kw = inputs.mesher_settings(
            ctx.config, kicad.load_kicad_project(self.warm))

    def _solve(self, pro):
        from padne_tpu_torch import kicad, mesh, solver

        stats = {}
        sol = solver.solve(kicad.load_kicad_project(pro),
                           mesher_config=mesh.Mesher.Config(**self.mesher_kw),
                           device=self.ctx.device, stats=stats)
        pots = np.concatenate([p.values for ls in sol.layer_solutions
                               for p in ls.potentials])
        return pots, stats

    def warm_up(self) -> None:
        for _ in range(self.ctx.traffic["warmup"]):
            self._solve(self.warm)

    def request(self, i: int):
        k = i % len(self.pool)
        pots, stats = self._solve(self.pool[k])
        return (k, pots), {"mesh_assemble_s": stats["mesh_assemble_s"],
                           "route": stats["route"]}

    def close(self) -> None:
        pass

    def check(self, answers):
        worst = max((check.max_abs_diff(
            pots, reference_potentials(self.pool[k], self.mesher_kw))
            for k, pots in answers), default=float("inf"))
        return [("max_dv", worst, self.ctx.config["check"]["max_dv"])]

