"""host_reads.resolve: the CG loop's continue tests read on the host
a solve (DiaBorderedSolver.host_reads), mean over the window."""


def read(run):
    return run.mean("host_reads")
