"""Device meshes, the collectives of the row-sharded solve and the
standalone dp x tp solvers.

Port of padne_tpu.parallel.sharding (`make_mesh`, `pad_rows`, the
standalone solvers) and of the collectives the sharded solve calls
inside `shard_map`.  The JAX package drives a mesh from one controller
through `shard_map`; here too one process drives every device of the
mesh, and a shard's state is a list of tensors, entry s on
`mesh.devices[s]`.  The collectives become explicit tensor operations on
such lists:

* `halo_exchange` (a `ppermute` to each neighbour): the edge columns of
  each shard copied to the device of the shard beside it;
* `all_gather`: the shards concatenated on every device;
* `psum`: the per-shard partials moved to the mesh's first device and
  summed there; `broadcast` hands a tensor of that device back to every
  shard.

On one card a mesh may name it several times (`Mesh(["cuda:0"] * 4)`):
the copies are then no-ops and the decomposition runs with its launches
and exchanges on one device.  On a host with several cards shard s
lives on cuda:s and the copies are peer copies.  Tests build
`Mesh(["cpu"] * tp)`, as the JAX tests build meshes over virtual CPU
devices.

The JAX module's standalone dp x tp solvers follow:
`prepare_sharded_system` places one system, or a batch of systems that
share one structure, as per-shard lists; `sharded_cg` (one system over
the tp shards of a dp row) and `batched_sharded_cg` (the batch split over
the dp rows, each row's systems over its tp shards) run a fixed number of
Jacobi-PCG iterations on them, every product one launch of kernel K3'
per shard and system over the all-gathered direction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import amg, spmv


class Mesh:
    """A (dp, tp) grid of torch devices, the counterpart of
    jax.sharding.Mesh for the sharded solve.

    devices: a flat sequence of n devices (names or torch.device), laid
    out row-major as dp rows of n / dp.  The sharded solve row-shards
    over all of them (`devices`, `tp` = n when dp is 1)."""

    def __init__(self, devices: Sequence, dp: int = 1):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(devs) % dp:
            raise ValueError(f"dp={dp} does not divide device count "
                             f"{len(devs)}")
        self.devices = devs
        self.dp = dp

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices) // self.dp

    @property
    def grid(self) -> list:
        """The devices as dp rows of tp."""
        return [list(self.devices[i * self.tp:(i + 1) * self.tp])
                for i in range(self.dp)]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int] = None, dp: int = 1) -> Mesh:
    """A (dp, tp) mesh over the first n_devices CUDA devices (all of them
    by default).  Raises if fewer than n_devices exist; a mesh with a
    device named more than once is built with Mesh([...])."""
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is not None and available < n_devices:
        raise RuntimeError(
            f"requested a {n_devices}-device mesh but only {available} CUDA "
            "device(s) exist; name the devices with Mesh([...]) to place "
            "several shards on one")
    n = n_devices or available
    if n == 0:
        raise RuntimeError("no CUDA device for a mesh")
    return Mesh([f"cuda:{i}" for i in range(n)], dp=dp)


def pad_rows(arr: np.ndarray, multiple: int, axis: int = 0,
             fill=0) -> np.ndarray:
    """Pad `axis` up to a multiple (rows padded with identity/no-op
    entries are harmless in the Laplacian: zero vals, self columns)."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def split(mesh: Mesh, x: torch.Tensor, dim: int) -> list:
    """x cut into mesh.size equal parts along `dim`, part s moved to
    shard s's device."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards")
    return [part.to(dev).contiguous() for part, dev in
            zip(torch.chunk(x, mesh.size, dim=dim), mesh.devices)]


def halo_exchange(mesh: Mesh, xs: list, halo: int, dim: int = -1):
    """(left, right) halos of each shard's (.., n_local) tensor along
    `dim`: left[s] holds the last `halo` entries of shard s - 1, right[s]
    the first `halo` of shard s + 1, both on shard s's device.  Shard 0's
    left halo and the last shard's right halo are zeros, as a `ppermute`
    without a source leaves them."""
    tp = len(xs)
    left, right = [], []
    for s, dev in enumerate(mesh.devices):
        edge = list(xs[s].shape)
        edge[dim] = halo
        zeros = xs[s].new_zeros(edge)
        left.append(xs[s - 1].narrow(dim, xs[s - 1].shape[dim] - halo,
                                     halo).to(dev) if s else zeros)
        right.append(xs[s + 1].narrow(dim, 0, halo).to(dev)
                     if s + 1 < tp else zeros)
    return left, right


def all_gather(mesh: Mesh, parts: list, dim: int) -> list:
    """The shards' parts concatenated along `dim`, on every device (one
    concatenation per distinct device)."""
    out = {}
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = torch.cat([p.to(dev) for p in parts], dim=dim)
    return [out[dev] for dev in mesh.devices]


def gather_to(parts: list, dev, dim: int) -> torch.Tensor:
    """The shards' parts concatenated along `dim` on one device."""
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def psum(mesh: Mesh, parts: list) -> torch.Tensor:
    """The sum of the per-shard partials, on the mesh's first device."""
    dev = mesh.devices[0]
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def broadcast(mesh: Mesh, t: torch.Tensor) -> list:
    """t on every shard's device."""
    return [t.to(dev) for dev in mesh.devices]


def prepare_sharded_system(ell, b, mesh: Mesh):
    """Pad a system to a multiple of mesh.tp rows and place it for the
    solvers below (the JAX function's pad and device_put).

    ell: an ops.assembly.EllMatrix (or anything with its cols, vals and
    diag) and b of one system: vals (n, K), diag (n,), b (n, R), for
    `sharded_cg`; or of a batch of B systems that share cols: vals
    (B, n, K), diag (B, n), b (B, n, R), for `batched_sharded_cg`.  The
    values are f32 or f64 as the inputs' types promote.  Padding rows
    have no entries and a zero diagonal: inert.

    One system goes to the tp devices of the mesh's first dp row, a batch
    to all dp * tp, its systems split in order over the dp rows (B must
    be a multiple of dp).  Returns (cols, vals, diag, b): lists with
    entry k on mesh.devices[k], for the rows [s * n_pad / tp, (s + 1) *
    n_pad / tp) of shard s = k % tp.  cols[k]: those rows as a
    rectangular K3' operator over the gathered vector (ops.spmv.
    EllOperator, n_pad columns), the diagonal folded in as an entry at
    the row's own column; vals[k]: its values in the operator's slots,
    (stored,), or (B / dp, stored) for the systems of shard k's dp row;
    diag[k] and b[k]: the diagonal and the right-hand sides of the rows,
    with the same leading axis for a batch.  `gather_to` gives the
    global arrays back."""
    vals, diag, b = (np.asarray(t) for t in (ell.vals, ell.diag, b))
    batch = vals.ndim == 3
    if not batch:
        vals, diag, b = vals[None], diag[None], b[None]
    tp, dp = mesh.tp, mesh.dp if batch else 1
    if len(vals) % dp:
        raise ValueError(f"a batch of {len(vals)} systems does not split "
                         f"over dp={dp}")
    n = vals.shape[1]
    n_pad = n + (-n) % tp
    nl, per_row = n_pad // tp, len(vals) // dp
    dtype = torch.from_numpy(np.zeros(0, np.result_type(vals, diag,
                                                        b))).dtype
    rows = [amg.shard_rows(ell.cols, v, d, n_pad, tp)
            for v, d in zip(vals, diag)]
    diag, b = pad_rows(diag, tp, axis=1), pad_rows(b, tp, axis=1)
    out = [], [], [], []
    for k, dev in enumerate(mesh.devices[:dp * tp]):
        d, s = divmod(k, tp)
        group = range(d * per_row, (d + 1) * per_row)
        # The layout holds the row's first system's values: op.val is
        # val[0], no copy.
        op, val = spmv.build_operators(
            rows[0][s][0], np.stack([rows[j][s][1] for j in group]), n_pad,
            dev, dtype)
        parts = [op, val] + [torch.from_numpy(np.array(
            t[group.start:group.stop, s * nl:(s + 1) * nl])).to(dev, dtype)
            for t in (diag, b)]
        if not batch:
            parts[1:] = [t[0] for t in parts[1:]]
        for lst, t in zip(out, parts):
            lst.append(t)
    return out


class _RowPCG:
    """The Jacobi-PCG iteration of `sharded_cg` and `batched_sharded_cg`
    on the tp shards of one dp row (`mesh`): ops[s] the operators of
    shard s, one per system of the row; diag[s] (B, n_local); b[s]
    (B, n_local, R).  tol None: no per-column freezing (the batched
    solver has none).  Nothing here waits for the device: the guards
    and the freezing are torch.where on it, as in the JAX fori_loop."""

    def __init__(self, mesh: Mesh, ops, diag, b, tol: Optional[float]):
        self.mesh, self.ops = mesh, ops
        self.minv = [torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0),
                                 1.0).unsqueeze(-1) for d in diag]
        # A zero on the row's first device: torch.where with a Python
        # scalar would fill one on the card at every call.
        self.zero = b[0].new_zeros(())
        self.target = (None if tol is None else
                       tol * self.dot(b, b).sqrt().clamp_min(1e-300))
        self.x = [torch.zeros_like(t) for t in b]
        self.r = b
        self.z = self.p = [m * r for m, r in zip(self.minv, b)]
        self.rz = self.dot(self.r, self.z)

    def dot(self, a, c):
        """(B, R) sums over all rows of the row's shards."""
        return psum(self.mesh, [(x * y).sum(dim=1) for x, y in zip(a, c)])

    def matvec(self, ps):
        """One K3' launch per shard and system over the gathered p."""
        out = []
        for ops, full in zip(self.ops, all_gather(self.mesh, ps, dim=1)):
            ys = [spmv.ell_spmv(op, full[j]) for j, op in enumerate(ops)]
            out.append(torch.stack(ys) if len(ys) > 1 else ys[0][None])
        return out

    def step(self) -> None:
        def ratio(num, den):
            # num / den where den > 0, else 0; the quotient where den <= 0
            # is computed and dropped.
            return torch.where(den > 0, num / den, self.zero)

        def frozen(coef):
            if self.target is not None:
                coef = torch.where(active, coef, self.zero)
            return broadcast(self.mesh, coef.unsqueeze(1))

        if self.target is not None:
            active = self.dot(self.r, self.r).sqrt() > self.target
        ap = self.matvec(self.p)
        alpha = frozen(ratio(self.rz, self.dot(self.p, ap)))
        self.x = [torch.addcmul(x, a, p) for x, a, p in
                  zip(self.x, alpha, self.p)]
        self.r = [torch.addcmul(r, a, q, value=-1.0) for r, a, q in
                  zip(self.r, alpha, ap)]
        self.z = [m * r for m, r in zip(self.minv, self.r)]
        rz = self.dot(self.r, self.z)
        beta = frozen(ratio(rz, self.rz))
        self.p = [torch.addcmul(z, bt, p) for z, bt, p in
                  zip(self.z, beta, self.p)]
        self.rz = rz


def _placed(cols, count: int) -> None:
    if (not isinstance(cols, (list, tuple)) or len(cols) != count
            or not all(isinstance(op, spmv.EllOperator) for op in cols)):
        raise TypeError(f"expected {count} shard operators, as "
                        "prepare_sharded_system places them")


def sharded_cg(mesh: Mesh, cols, vals, diag, b, iters: int = 200,
               tol: float = 0.0) -> torch.Tensor:
    """Row-sharded Jacobi-PCG over the tp shards (single system), on
    what `prepare_sharded_system` placed for one system.  Runs `iters`
    iterations and freezes a column (alpha = beta = 0) while its
    residual norm, measured at the top of each iteration, is at most tol
    * max(|b|, 1e-300); minv = 1 where diag <= 0, alpha = 0 unless
    p.Ap > 0, beta = 0 unless the old r.z > 0.  Every product is one
    K3' launch per shard over the all-gathered direction, every dot a
    psum of the shards' partials, and no value comes to the host, so
    the host never waits for the card inside the loop.

    With dp > 1 the JAX function runs replicated over the dp rows; here
    it runs once, on the first (Mesh(mesh.grid[0])), as ops.schur.
    solve_bordered does.  Returns x (n_pad, R) on the mesh's first
    device."""
    _placed(cols, mesh.tp)
    ops = [[dataclasses.replace(op, val=v)] for op, v in zip(cols, vals)]
    row = Mesh(mesh.grid[0])
    pcg = _RowPCG(row, ops, [d[None] for d in diag], [t[None] for t in b],
                  tol)
    for _ in range(iters):
        pcg.step()
    return gather_to(pcg.x, row.devices[0], dim=1)[0]


def batched_sharded_cg(mesh: Mesh, cols, vals, diag, b,
                       iters: int = 200) -> torch.Tensor:
    """DP x TP: a batch of systems that share one sparsity structure, on
    what `prepare_sharded_system` placed for the batch: the systems
    split over the dp rows of the mesh, each system's rows over the tp
    devices of its row, the all-gather and the dots within a row.  The
    iteration is `sharded_cg`'s without `tol`.  The rows are
    independent; each iteration runs on every row in turn, so that rows
    on different cards overlap.  Returns x (B, n_pad, R) on the mesh's
    first device."""
    _placed(cols, mesh.size)
    tp = mesh.tp
    rows = []
    for d in range(mesh.dp):
        k = slice(d * tp, (d + 1) * tp)
        ops = [[dataclasses.replace(op, val=v) for v in vs]
               for op, vs in zip(cols[k], vals[k])]
        rows.append(_RowPCG(Mesh(mesh.grid[d]), ops, diag[k], b[k], None))
    for _ in range(iters):
        for pcg in rows:
            pcg.step()
    return torch.cat([gather_to(pcg.x, mesh.devices[0], dim=1)
                      for pcg in rows])
