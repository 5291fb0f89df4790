"""The server's repeat path on a many-island board: resolve.py's Entry
(one ops.schur.DiaBorderedSolver set up, then per request
`set_excitation` and `solve`) on the site board of pdnbench/siteboard.py,
whose 144 islands and ground zone make 145 copper components and a
145-row border.  So the CG deflates over segment sums (more than 64
components) and each pass works on the border at width m + 1 and the
small Schur block at width m + p.

Each request puts one of the mix's `current_levels` on every site's
load and one of its `voltage_levels` on every site's supply, drawn
independently for each site: a pool of `pool` such draws from a
generator seeded with the mix's `pool_seed`, the same pool for every
seed, taken in an order drawn from the seed.  Each request reports the
solver's widths (DiaBorderedSolver.counters) and fails unless the route
is DIA and the projector sums by segment; the entry fails at once,
before any input is made, where the program reports no widths.

Checked: the relative residual of every sampled answer on the frozen
system, and with the configuration's `check.max_site_dv` the largest
|V - V_ref| over the sites' load pads of the first `direct_answers`
sampled answers against SciPy's direct solve.
"""

from __future__ import annotations

import numpy as np

from .. import inputs, siteboard
from ..reference import check
from . import resolve


def requests(ctx, inp) -> list:
    """The (r_core, rhs) of each request in the pool, in an order drawn
    from the seed."""
    mix = ctx.traffic
    rng = np.random.default_rng(mix["pool_seed"])
    sites = len(inp.cur_i)
    pool = [(rng.choice(mix["current_levels"], sites),
             rng.choice(mix["voltage_levels"], inp.m - 1))
            for _ in range(mix["pool"])]
    order = np.random.default_rng(ctx.seed).permutation(len(pool))
    return [inputs.excitation(inp, *pool[i]) for i in order]


def check_widths(counters: dict) -> None:
    """Raises unless the solve took the DIA route with the segment-sum
    projector."""
    if counters.get("route") != "dia" or counters.get(
            "projector") != "segment":
        raise RuntimeError(f"the site board must take the DIA route with "
                           f"the segment projector, not {counters}")


class Entry(resolve.Entry):
    def __init__(self, ctx):
        from padne_tpu_torch.ops import schur

        if not hasattr(schur.DiaBorderedSolver, "counters"):
            raise RuntimeError("the program's DiaBorderedSolver reports no "
                               "widths (counters)")
        self.ctx = ctx
        inp = self.inp = siteboard.site_inputs(ctx.config, ctx.tmp_dir)
        self.pool = requests(ctx, inp)
        self.ell = inp.ell()
        self.acc = ctx.config["accuracy"]
        self.solver = None
        self._set_up()

    def _set_up(self) -> None:
        super()._set_up()
        check_widths(self.solver.counters())

    def request(self, i: int):
        answer, counters = super().request(i)
        widths = self.solver.counters()
        check_widths(widths)
        return answer, {**counters, **widths}

    def check(self, answers):
        out = super().check(answers)
        limits = self.ctx.config["check"]
        if "max_site_dv" in limits:
            ref = check.Bordered(self.inp, self.ell)
            pads, n = self.inp.cur_f, self.inp.n
            # An answer of another length reads inf.
            dv = [check.max_abs_diff(
                np.asarray(v)[pads] if np.shape(v) == (n,) else v,
                ref.direct(*self.pool[k])[0][pads])
                for k, v, _ in answers[:limits["direct_answers"]]]
            out.append(("max_site_dv", max(dv, default=float("inf")),
                        limits["max_site_dv"]))
        return out
