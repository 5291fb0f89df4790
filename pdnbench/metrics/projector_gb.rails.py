"""projector_gb.rails: GB a request of the CG projector's own operands
(DiaBorderedSolver.counters()["projector_bytes"]: the one-hot read twice
an application, two applications an iteration and three a CG call),
mean over the window; None where the program counts none.  Counted, not
timed: the projector runs inside the CG loop's graph, where no span can
split it."""


def read(run):
    got = run.mean("projector_bytes")
    return None if got is None else got / 1e9
