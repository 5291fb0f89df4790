"""solve_s: seconds of the window a completed request (the window runs
requests back to back: its length over the requests completed)."""

from pdnbench import arith


def read(run):
    return arith.per_request(run.window_s, len(run.latencies))
