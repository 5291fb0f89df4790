"""The server's repeat path without the socket: one
ops.schur.DiaBorderedSolver set up on the configuration's board, then per
request `set_excitation` and `solve` (the CG loop, the V-cycle, K1'/K2'
and the refinement ladder at R = 1; set-up bypassed).

Each request's current-source and voltage-source values are one
combination of the mix's levels around the board's nominal values
(`current_levels`, `voltage_levels`); every combination is made before
the window, put in an order drawn from the seed, and taken in turn.
Checked: the relative residual of every answer on the frozen system,
against the configuration's `check.rel_residual`.
"""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import check
from . import _program


def requests(ctx, inp) -> list:
    """The (r_core, rhs) of each request in the pool: every combination
    of the mix's source levels, in an order drawn from the seed."""
    levels = inputs.source_levels(ctx.traffic, len(inp.cur_i), inp.m - 1)
    order = np.random.default_rng(ctx.seed).permutation(len(levels))
    return [inputs.excitation(inp, *levels[i]) for i in order]


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        inp = self.inp = inputs.base_inputs(ctx.config, ctx.tmp_dir)
        self.pool = requests(ctx, inp)
        self.ell = inp.ell()
        self.acc = ctx.config["accuracy"]
        self.solver = None
        self._set_up()

    def _set_up(self) -> None:
        from padne_tpu_torch.ops import schur

        inp = self.inp
        system = _program.core_system(inp, self.ell, inp.r_core.copy(),
                                      inp.b_rhs.copy())
        self.solver = schur.DiaBorderedSolver(system, device=self.ctx.device)

    def _solve(self):
        return self.solver.solve(
            target_residual=self.acc["target_residual"],
            max_refinements=self.acc["max_refinements"])

    def warm_up(self) -> None:
        # The first solve runs at R = m + 1 and keeps A^+ C; the next at
        # R = 1, as every request does, captures its graph.
        self._solve()
        for k in range(self.ctx.traffic["warmup"]):
            self.solver.set_excitation(*self.pool[-1 - k])
            self._solve()

    def renew(self) -> None:
        """Set up and warm up a new solver: under the profiler, so that
        it traces the kernels of the CUDA graphs captured here (it does
        not see those of graphs captured before it started)."""
        self.solver = None
        self._set_up()
        self.warm_up()

    def request(self, i: int):
        k = i % len(self.pool)
        self.solver.set_excitation(*self.pool[k])
        sol = self._solve()
        return (k, sol.v, sol.j), {
            "cg_iterations": sol.cg_iterations,
            "passes": sol.refinement_steps + 1,
            "host_reads": self.solver.host_reads}

    def close(self) -> None:
        self.solver = None

    def check(self, answers):
        ref = check.Bordered(self.inp, self.ell)
        worst = max((ref.rel_residual(*self.pool[k], v, j)
                     for k, v, j in answers), default=float("inf"))
        return [("rel_residual", worst,
                 self.ctx.config["check"]["rel_residual"])]
