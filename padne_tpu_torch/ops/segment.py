"""Fixed-order segment sums: the port's counterpart of
jax.ops.segment_sum.

    out[s] = sum of x[i] over the i with seg[i] == s

A scatter-add on a CUDA tensor (`index_add_`, `index_put_(...,
accumulate=True)`) adds with atomics in the order the threads arrive,
so the bits of its floating-point sums change from call to call, and a
CG that reads them takes another number of iterations from solve to
solve.  XLA's segment_sum adds in a fixed order.  So does `SegmentSum`:
the segment index is fixed (a component id, a border row index, a node
position), and its layout is built once, at set-up:

* the entries sorted stably by segment, then cut into chunks of CHUNK
  slots that never cross a segment boundary (a segment's last chunk is
  padded with slots that are set to zero after the gather); the layout
  is worked out on the host and only its gather indices (int32) and pad
  masks go to the device;
* a sum is a gather of the chunks and a `sum` over the chunk's axis;
  the chunk sums of each segment are chunked and summed again, until
  every segment holds at most one value, which a last gather places
  (an empty segment reads zero).

Each stage pads at most CHUNK - 1 slots per non-empty segment, so a
segment of a million rows beside a hundred small ones costs a few
stages, never p times the largest segment.  Only gathers, fills and
sums run: no atomics, the same order on every call and every device,
and every stage captures in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 32   # slots summed at once; stages = ceil(log_CHUNK(largest))


def _gather(x: torch.Tensor, dim: int, idx: torch.Tensor,
            pad: torch.Tensor) -> torch.Tensor:
    """x's entries idx along `dim`, zero where pad is set (pad slots
    read entry 0 and are cleared: no copy of x with a zero appended)."""
    shape = [1] * x.ndim
    shape[dim] = -1
    return x.index_select(dim, idx).masked_fill_(pad.view(shape), 0)


def _on(idx: torch.Tensor, dev) -> tuple:
    """(gather index, pad slots) on `dev` of a host index whose pad
    slots are -1."""
    return (idx.clamp_min(0).to(device=dev, dtype=torch.int32),
            (idx < 0).to(dev))


class SegmentSum:
    """The layout of one segment index, and its sums.

    seg: (N,) integer segment of each entry (numpy or torch), all in
    [0, num_segments); device: where the layout lives (default: seg's
    device).  Calling it with x, whose axis `dim` runs over the N
    entries ((N,), (N, R) or (R, N); f32 or f64), gives the sums with
    that axis of length num_segments."""

    def __init__(self, seg, num_segments: int, device=None):
        seg = torch.as_tensor(np.asarray(seg) if not torch.is_tensor(seg)
                              else seg)
        dev = seg.device if device is None else torch.device(device)
        seg = seg.to(device="cpu", dtype=torch.int64).reshape(-1)
        n, p = seg.numel(), num_segments
        if n and (int(seg.min()) < 0 or int(seg.max()) >= p):
            raise ValueError(f"segment ids outside [0, {p})")
        self.n, self.num_segments = n, p
        # Items of the current stage: keys (their segments, sorted) and
        # src (where each is read from: x's rows, then the last stage's
        # chunk sums).
        src = torch.sort(seg, stable=True).indices
        keys = seg[src]
        items = n
        self.stages = []      # (gather index, pad slots) of each stage
        while items:
            counts = torch.bincount(keys, minlength=p)
            if int(counts.max()) <= 1:
                break
            chunks = (counts + CHUNK - 1) // CHUNK
            rank = (torch.arange(items)
                    - (torch.cumsum(counts, 0) - counts)[keys])
            first = (torch.cumsum(chunks, 0) - chunks)[keys]
            total = int(chunks.sum())
            idx = torch.full((total * CHUNK,), -1, dtype=torch.int64)
            idx[(first + rank // CHUNK) * CHUNK + rank % CHUNK] = src
            self.stages.append(_on(idx, dev))
            keys = torch.repeat_interleave(torch.arange(p), chunks)
            src = torch.arange(total)
            items = total
        # Segment s reads its one item, or zero.
        place = torch.full((p,), -1, dtype=torch.int64)
        place[keys] = src
        self.place = _on(place, dev)

    def index_bytes(self) -> int:
        """Bytes of the layout a sum reads: each stage's gather index
        and pad slots, and the last gather's."""
        return sum(t.numel() * t.element_size()
                   for stage in (*self.stages, self.place) for t in stage)

    def __call__(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        dim = dim % x.ndim
        if x.shape[dim] != self.n:
            raise ValueError(f"axis {dim} of x has {x.shape[dim]} entries, "
                             f"the segment index {self.n}")
        if not self.n:
            shape = list(x.shape)
            shape[dim] = self.num_segments
            return x.new_zeros(shape)
        for idx, pad in self.stages:
            x = _gather(x, dim, idx, pad).unflatten(dim, (-1, CHUNK)).sum(
                dim + 1)
        return _gather(x, dim, *self.place)
