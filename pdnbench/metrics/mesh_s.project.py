"""mesh_s.project: seconds a request meshing the copper (the
`pipeline.mesh` spans), mean over the window's requests.  Read from the
program's span log (padne_tpu_torch.spans): the last unprofiled
top-level spans of the cell's requests (`kicad.load`, `solver.solve`),
one each a window request; None where the program keeps no span log."""

TOP = ("kicad.load", "solver.solve")


def read(run):
    n = len(run.latencies)
    if not n:
        return None
    try:
        from padne_tpu_torch import spans
    except ImportError:
        return None
    got = spans.recent(TOP, n)
    if not any(name in got for name in TOP):
        return None
    return got.get("pipeline.mesh", (0, 0.0, 0.0))[1] / n
