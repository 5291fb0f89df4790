"""host_setup_s.board: solve_bordered's own set-up seconds a board
(stats["setup_s"]: hierarchy build and uploads, timed on the host
without a synchronisation), mean over the window."""


def read(run):
    return run.mean("host_setup_s")
