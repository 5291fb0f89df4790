"""passes.resolve: refinement passes a solve (refinement_steps + 1 of
BorderedSolution), mean over the window."""


def read(run):
    return run.mean("passes")
