"""setup_s: seconds from the start of the process to the start of the
window (imports, inputs, the program's set-up, warm-up)."""


def read(run):
    return run.setup_s
