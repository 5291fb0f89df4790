"""The server's repeat path on a regulated multi-rail board: resolve.py's
Entry (one ops.schur.DiaBorderedSolver set up, then per request
`set_excitation` and `solve`) on the SoC power tree of
pdnbench/railboard.py, whose rails, 12 V input and ground make a few
tens of copper components and whose border holds the input source, one
variable a regulator (its column draws the regulator's gain-scaled
input current from another rail) and the ground pin.  So the CG deflates
with dense one-hot products (2 to 64 components) and the Schur block is
not symmetric.

Each request puts one of the mix's `current_levels` on every load and
one of its `voltage_levels` on the input source and on every
regulator's set point, drawn independently for each: site_resolve's
pool of `pool` draws from the mix's `pool_seed`, the same for every
seed, taken in an order drawn from the seed.  Each request reports the
solver's counters (DiaBorderedSolver.counters) and fails unless the
route is DIA, the projector one-hot, and the components, border rows
and regulators those the configuration states; the entry fails at once,
before any input is made, where the program counts no regulators.

Checked: the relative residual of every sampled answer on the frozen
system, and with the configuration's `check.max_rail_dv` the largest
|V - V_ref| over the load pads of the first `direct_answers` sampled
answers against pdnbench/reference/mna.py's direct solve.
"""

from __future__ import annotations

import numpy as np

from .. import railboard
from ..reference import check, mna
from . import resolve, site_resolve


def check_counters(counters: dict, config: dict) -> None:
    """Raises unless the solve took the DIA route with the one-hot
    projector at the configuration's widths and regulators."""
    want = {"route": "dia", "projector": "onehot",
            "components": config["components"], "border_rows": config["m"],
            "regulators": config["regulators"]}
    got = {k: counters.get(k) for k in want}
    if got != want:
        raise RuntimeError(f"the rail board must solve with {want}, not "
                           f"{got}")


class Entry(resolve.Entry):
    def __init__(self, ctx):
        from padne_tpu_torch.ops import schur

        if not hasattr(schur, "count_regulators"):
            raise RuntimeError("the program's DiaBorderedSolver counts no "
                               "regulators")
        self.ctx = ctx
        inp = self.inp = railboard.rail_inputs(ctx.config, ctx.tmp_dir)
        self.pool = site_resolve.requests(ctx, inp)
        self.ell = inp.ell()
        self.acc = ctx.config["accuracy"]
        self.solver = None
        self._set_up()

    def _set_up(self) -> None:
        super()._set_up()
        check_counters(self.solver.counters(), self.ctx.config)

    def request(self, i: int):
        answer, counters = super().request(i)
        got = self.solver.counters()
        check_counters(got, self.ctx.config)
        return answer, {**counters, **got}

    def check(self, answers):
        out = super().check(answers)
        limits = self.ctx.config["check"]
        ref = mna.Reference(self.inp)
        pads, n = self.inp.cur_f, self.inp.n
        # An answer of another length reads inf.
        dv = [check.max_abs_diff(
            np.asarray(v)[pads] if np.shape(v) == (n,) else v,
            ref.solve(*self.pool[k])[0][pads])
            for k, v, _ in answers[:limits["direct_answers"]]]
        out.append(("max_rail_dv", max(dv, default=float("inf")),
                    limits["max_rail_dv"]))
        return out
