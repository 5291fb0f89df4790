"""capture_s.board: seconds a request capturing and instantiating the CG
loop's CUDA graphs (the `cg.capture` spans), mean over the window's
requests.  Read from the program's span log (padne_tpu_torch.spans): the
last unprofiled top-level spans of the cell's requests
(`schur.solve_bordered`), one each a window request; None where the
program keeps no span log."""

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
    if not any(name in got for name in TOP):
        return None
    return got.get("cg.capture", (0, 0.0, 0.0))[1] / n
