"""Device meshes and the collectives of the row-sharded solve.

Port of the parts of padne_tpu.parallel.sharding that the sharded solve
runs (`make_mesh`, `pad_rows`) and of the collectives it calls inside
`shard_map`.  The JAX package drives a mesh from one controller through
`shard_map`; here too one process drives every device of the mesh, and
a shard's state is a list of tensors, entry s on `mesh.devices[s]`.  The
collectives become explicit tensor operations on such lists:

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

The JAX module's standalone dp x tp solvers (`sharded_cg`,
`batched_sharded_cg`, `prepare_sharded_system`) are not carried yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


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
