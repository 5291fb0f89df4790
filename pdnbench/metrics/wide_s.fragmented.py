"""wide_s.fragmented: seconds a request in the work that grows with the
border's width: the border products of each Schur pass and their reads
(the `schur.border_products` spans) and the small (m + p) Schur block
(the `schur.small` spans), mean over the window's requests.  Read from
the program's span log (padne_tpu_torch.spans): the last unprofiled
top-level spans of the cell's requests (`schur.set_excitation`,
`schur.solve`), one each a window request; None where the program keeps
no span log or no `schur.border_products` span."""

TOP = ("schur.set_excitation", "schur.solve")


def read(run):
    n = len(run.latencies)
    if not n:
        return None
    try:
        from padne_tpu_torch import spans
    except ImportError:
        return None
    got = spans.recent(TOP, n)
    if "schur.border_products" not in got:
        return None
    return sum(got.get(name, (0, 0.0, 0.0))[1]
               for name in ("schur.border_products", "schur.small")) / n
