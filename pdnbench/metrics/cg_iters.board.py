"""cg_iters.board: CG iterations a request (BorderedSolution.cg_iterations),
mean over the window."""


def read(run):
    return run.mean("cg_iterations")
