"""The user path's solve of a new board, as solver.solve calls it:
ops.schur.solve_bordered(system, inner_dtype=float32) on the card, with
routing, the host AMG set-up, the device operator build, graph capture
and one solve in every request.

Each request is a variant of the configuration's board: the copper
weights of its layers (one of the mix's `layer_weights`) and its source
values (one combination of the mix's source levels); every seed runs
the same variants, in an order of its own.
A weight changes A's values, not its structure.  The variants are
assembled with the frozen pipeline before the window and taken in turn.
Checked: the relative residual of every answer on its own frozen
system, against the configuration's `check.rel_residual`.
"""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import check
from . import _program


def requests(ctx, inp) -> list:
    """The (frozen EllMatrix, r_core, rhs) of each request in the pool:
    the k-th of the mix's layer weights with the k-th combination of its
    source levels, in an order drawn from the seed."""
    t = ctx.traffic
    levels = inputs.source_levels(t, len(inp.cur_i), inp.m - 1)
    n = len(t["layer_weights"])
    order = np.random.default_rng(ctx.seed).permutation(n)
    return [(inputs.variant_ell(inp, t["layer_weights"][k]),
             *inputs.excitation(inp, *levels[k * len(levels) // n]))
            for k in order]


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        inp = self.inp = inputs.base_inputs(ctx.config, ctx.tmp_dir)
        self.pool = requests(ctx, inp)
        self.warm = (inp.ell(), inp.r_core, inp.b_rhs)

    def _solve(self, ell, rc, rhs):
        import torch

        from padne_tpu_torch.ops import schur

        acc = self.ctx.config["accuracy"]
        stats = {}
        sol = schur.solve_bordered(
            _program.core_system(self.inp, ell, rc, rhs),
            inner_dtype=torch.float32, device=self.ctx.device, stats=stats,
            target_residual=acc["target_residual"],
            max_refinements=acc["max_refinements"])
        return sol, stats

    def warm_up(self) -> None:
        for _ in range(self.ctx.traffic["warmup"]):
            self._solve(*self.warm)

    def request(self, i: int):
        k = i % len(self.pool)
        sol, stats = self._solve(*self.pool[k])
        return (k, sol.v, sol.j), {"cg_iterations": sol.cg_iterations,
                                   "host_setup_s": stats["setup_s"],
                                   "route": stats["route"]}

    def close(self) -> None:
        pass

    def check(self, answers):
        refs = {}
        for k in sorted({k for k, _, _ in answers}):
            refs[k] = check.Bordered(self.inp, self.pool[k][0])
        worst = max((refs[k].rel_residual(*self.pool[k][1:], v, j)
                     for k, v, j in answers), default=float("inf"))
        return [("rel_residual", worst,
                 self.ctx.config["check"]["rel_residual"])]
