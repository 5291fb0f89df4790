"""galerkin_s.board: seconds a request in the DIA hierarchy's Galerkin
products (the `hierarchy.galerkin` spans, one a level, inside
`setup.hierarchy`), mean over the window's requests.  Read from the
program's span log (padne_tpu_torch.spans): the last unprofiled
top-level spans of the cell's requests (`schur.solve_bordered`), one
each a window request; None where the program keeps no span log or
opens no `hierarchy.galerkin` span."""

TOP = ("schur.solve_bordered",)


def read(run):
    n = len(run.latencies)
    if not n:
        return None
    try:
        from padne_tpu_torch import spans
    except ImportError:
        return None
    got = spans.recent(TOP, n)
    if "hierarchy.galerkin" not in got:
        return None
    return got["hierarchy.galerkin"][1] / n
