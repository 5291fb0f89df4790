"""The benchmark's arithmetic: rates, the bytes a
sparse product must move, the device's busy time from a trace, and the
table of peaks.  Plain Python and NumPy; nothing here reads the program.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
# at the 700 W power limit): HBM3 bandwidth in bytes a second.
HBM_BYTES_PER_S = 3.35e12


def per_request(window_s: float, completed: int):
    """Seconds of the window a completed request: None when none did."""
    return window_s / completed if completed else None


def csr_bytes(rows: int, nnz: int, value_bytes: int, diag_bytes: int,
              x_rows: int, r: int, vec_bytes: int,
              epilogue_bytes: int = 0) -> int:
    """Bytes a sparse product y = A x must move, counted from the work
    and not from any stored layout: the off-diagonal nonzeros as a CSR
    with int32 column indices and int32 row pointers, the diagonal, the
    rows of x (R columns) that the nonzeros name, y, and any epilogue
    operands of the call, each once."""
    return (nnz * (4 + value_bytes) + (rows + 1) * 4 + rows * diag_bytes
            + x_rows * r * vec_bytes + rows * r * vec_bytes
            + epilogue_bytes)


def roofline_pct(nbytes: float, seconds: float,
                 bytes_per_s: float = HBM_BYTES_PER_S):
    """The least time to move nbytes over the time taken, in percent;
    None without time."""
    if seconds <= 0:
        return None
    return 100.0 * nbytes / bytes_per_s / seconds


def merge(intervals):
    """Sorted, non-overlapping (start, end) pairs covering the same
    points as `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals: time in which at
    least one of them ran, overlapping ones counted once."""
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals, start: float, end: float):
    """(start, end) stretches of [start, end] that no interval covers."""
    out, at = [], start
    for s, e in merge(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]
