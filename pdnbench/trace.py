"""The traced segment of a `--trace 1` run: a few requests under
torch.profiler, with a hook in the program's launch accounting
(padne_tpu_torch.kernels.HOOKS) that records the operands of every
launch of its sparse products.

Read from the segment, all on the profiler's clock:
- busy seconds: the union of every device activity's interval (kernels,
  copies, sets), overlapping ones counted once;
- each hand-written kernel's seconds and calls, by its name;
- the bytes each launch of K1' (ops.dia.sell_matvec) and K3'
  (ops.spmv.ell_spmv) must move, by arith.csr_bytes over the
  operator's nonzeros (counted once per operator after the segment);
- the breakdown: the device operations that took most time, and the
  idle gaps by the host event that was running (the innermost one
  covering the gap's middle).
"""

from __future__ import annotations

import bisect
import collections

from . import arith

# The kernel names (csrc/*.cu) of the launches each counted wrapper makes.
KERNEL_OF = {"sell_matvec": "dia_sell_kernel", "ell_spmv": "ell_sell_kernel"}


class Launches:
    """A kernels.HOOKS hook: every counted launch's wrapper and the
    operands the bound needs; the operators are kept to count their
    nonzeros after the segment."""

    def __init__(self):
        self.records = []          # (wrapper name, operator id, r, extras)
        self.operators = {}

    def __call__(self, wrapper, *ops):
        name = wrapper.__name__
        if name == "sell_matvec":
            params, xt = ops
            self.operators[id(params)] = params
            self.records.append((name, id(params), xt.shape[0], 0))
        elif name == "ell_spmv":
            op, x, b, w, x0 = ops
            self.operators[id(op)] = op
            s, n, r = x.element_size(), op.n, x.shape[1]
            extra = ((n * r * s if b is not None else 0)
                     + (n * s if w is not None else 0)
                     + (n * r * s if x0 is not None else 0))
            self.records.append((name, id(op), r, extra))
        else:
            self.records.append((name, None, 0, 0))

    def count(self, name: str) -> int:
        return sum(1 for rec in self.records if rec[0] == name)

    def bytes(self, name: str) -> int:
        """The bound bytes of every launch of `name`'s kernel."""
        shape = {}
        total = 0
        for wname, key, r, extra in self.records:
            if wname != name:
                continue
            if key not in shape:
                shape[key] = _operator_shape(wname, self.operators[key])
            rows, nz_bytes, diag_bytes, x_rows, vec = shape[key]
            total += (arith.csr_bytes(rows, 0, 0, diag_bytes, x_rows, r,
                                      vec, extra) + nz_bytes)
        return total


def _operator_shape(name, op):
    """(rows, bytes of the off-diagonal nonzeros as an int32-index CSR,
    bytes a row of the diagonal, rows of x named, bytes an entry of x)
    of one operator, counted from its values: padding rows and entries
    (value 0) are not work."""
    import torch

    if name == "sell_matvec":
        diag = op["diag"]
        nz = ((op["a_val"] != 0).sum().item()
              * (4 + op["a_val"].element_size())
              + (op["b_val"] != 0).sum().item() * (4 + 4))
        rows = int((diag != 0).sum().item())
        # Square (nx = rows): the diagonal names every live row of x;
        # over a window, all of x.
        x_rows = rows if op["nx"] == diag.numel() else int(op["nx"])
        return rows, nz, diag.element_size(), x_rows, 4
    keep = op.val != 0
    nz = int(keep.sum().item()) * (4 + op.val.element_size())
    named = op.col[keep].long()
    if op.diag is not None:
        named = torch.cat([named, torch.nonzero(op.diag).flatten()])
    x_rows = int(torch.unique(named).numel())
    diag_bytes = 0 if op.diag is None else op.diag.element_size()
    return op.n, nz, diag_bytes, x_rows, op.val.element_size()


class Reading:
    """What the traced segment gave (seconds on the profiler's clock)."""

    def __init__(self, window_s, busy_s, kernel_s, kernel_calls, launches,
                 breakdown):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernel_s = kernel_s            # {kernel name: seconds}
        self.kernel_calls = kernel_calls    # {kernel name: calls}
        self.launches = launches            # Launches
        self.breakdown = breakdown

    def roofline(self, wrapper: str):
        """Percent of the bound time over the measured time of one
        hand-written kernel, None where the segment ran none.  Raises
        where the profiler saw fewer of its kernels than were launched:
        its time would be incomplete."""
        kernel = KERNEL_OF[wrapper]
        counted = self.launches.count(wrapper)
        seen = self.kernel_calls.get(kernel, 0)
        if counted == 0 and seen == 0:
            return None
        if seen != counted:
            raise RuntimeError(
                f"the profiler saw {seen} {kernel} kernels, the program "
                f"counted {counted} launches: the kernel time is incomplete")
        return arith.roofline_pct(self.launches.bytes(wrapper),
                                  self.kernel_s[kernel])


def _kernel_key(name: str):
    for kernel in KERNEL_OF.values():
        if kernel in name:
            return kernel
    return None


def profile(run_requests, count: int, prepare=None) -> Reading:
    """Run `prepare()` (where given) and then `run_requests(count)` under
    the profiler, the launch hook installed for the requests alone, and
    read the segment of the requests."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    from padne_tpu_torch import kernels

    hook = Launches()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        if prepare is not None:
            prepare()
            torch.cuda.synchronize()
        kernels.HOOKS.append(hook)
        try:
            with record_function("pdnbench.segment"):
                run_requests(count)
                torch.cuda.synchronize()
        finally:
            kernels.HOOKS.remove(hook)
    events = list(prof.events())
    seg = next(e for e in events if e.name == "pdnbench.segment"
               and e.device_type == torch.autograd.DeviceType.CPU)
    start, end = seg.time_range.start, seg.time_range.end
    device, host = [], []
    for e in events:
        if e.name == "pdnbench.segment" or getattr(
                e, "is_user_annotation", False):
            continue
        if e.time_range.end <= start or e.time_range.start >= end:
            continue
        (device if e.device_type == torch.autograd.DeviceType.CUDA
         else host).append(e)
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    busy_us = arith.union_length(
        [(max(s, start), min(e, end)) for s, e in intervals])
    kernel_s, kernel_calls = collections.Counter(), collections.Counter()
    by_name = collections.Counter()
    for e in device:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] += us
        key = _kernel_key(e.name)
        if key is not None:
            kernel_s[key] += us / 1e6
            kernel_calls[key] += 1
    breakdown = {
        "device_ops": [[name[:160], us / 1e6]
                       for name, us in by_name.most_common(10)],
        "idle_gaps": _idle_by_host(intervals, host, start, end)}
    return Reading((end - start) / 1e6, busy_us / 1e6, dict(kernel_s),
                   dict(kernel_calls), hook, breakdown)


def _idle_by_host(intervals, host, start, end, top: int = 10):
    """[[host event, idle seconds]] of the segment's device idle gaps,
    each gap named by the innermost host event covering its middle,
    summed by name, longest first."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host)
    starts = [s for s, _, _ in spans]
    idle = collections.Counter()
    for g0, g1 in arith.gaps(intervals, start, end):
        mid = (g0 + g1) / 2
        name = "host Python (no torch event)"
        i = bisect.bisect_right(starts, mid) - 1
        # The latest-starting event that still covers mid is innermost.
        for k in range(i, max(i - 512, -1), -1):
            if spans[k][1] > mid:
                name = spans[k][2]
                break
        idle[name[:160]] += (g1 - g0) / 1e6
    return [[name, s] for name, s in idle.most_common(top)]
