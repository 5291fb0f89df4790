"""border_s.resolve: seconds a request of the bordered solve's own host
work outside the CG (the self seconds of every `schur.*` span: passes,
ladder, small block, downloads, residuals), mean over the window's
requests.  Read from the program's span log (padne_tpu_torch.spans):
the last unprofiled top-level spans of the cell's requests
(`schur.set_excitation`, `schur.solve`), one each a window request;
None where the program keeps no span log."""

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
    if not any(name in got for name in TOP):
        return None
    return sum(own for name, (_, _, own) in got.items()
               if name.startswith("schur.")) / n
