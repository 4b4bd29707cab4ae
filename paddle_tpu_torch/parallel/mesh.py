"""The device mesh (counterpart of paddle_tpu/parallel/mesh.py).

The reference names its parallel axes on a ``jax.sharding.Mesh`` of the
devices one process sees.  The port is one process per rank: a ``Mesh``
lays the ranks of ``torch.distributed`` over the same axes in the same
order (``dp`` outermost, ``sp`` fastest) and keeps, for this rank, one
process group per axis: the ranks that differ from it along that axis
only.  Every rank builds the same mesh (each ``torch.distributed.new_group``
is made by all ranks, in one order).

- An axis of size 1 needs no group and has none, except in a world of one
  rank that was started: there every axis's group is that world, so the
  collectives of a one-card run go through the backend (NCCL on the card).
- ``NamedSharding(mesh, P(...))`` and ``PartitionSpec`` (``P``, a tuple of
  axis names or None per dimension) are the port's own small classes;
  ``sharding.shard_shape(shape)`` and ``sharding.index(shape)`` give this
  rank's block of an array.
- Without a started process group the mesh is one rank (every axis of
  size 1) and every collective on it is the identity.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..core.errors import enforce

__all__ = ["AXES", "Mesh", "PartitionSpec", "P", "NamedSharding",
           "create_mesh", "set_mesh", "get_mesh", "axis_size", "sharding",
           "replicated"]

AXES = ("dp", "pp", "ep", "tp", "sp")

_GLOBAL_MESH = None


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of names, or
    None (not sharded)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _started() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """Ranks over ``AXES``; ``shape`` maps every axis to its size."""

    def __init__(self, sizes: Dict[str, int], ranks: Sequence[int]):
        self.axis_names = AXES
        self.shape = {a: int(sizes.get(a, 1)) for a in AXES}
        self.devices = np.array(list(ranks)).reshape(
            tuple(self.shape[a] for a in AXES))
        self.size = int(self.devices.size)
        me = dist.get_rank() if _started() else int(self.devices.flat[0])
        where = np.argwhere(self.devices == me)
        self.rank = me
        self.coords = ({a: int(c) for a, c in zip(AXES, where[0])}
                       if len(where) else None)
        self._groups: Dict[str, object] = {}
        if not _started():
            return
        world_of_one = dist.get_world_size() == 1
        for i, a in enumerate(AXES):
            if self.shape[a] == 1:
                if world_of_one:
                    self._groups[a] = dist.group.WORLD
                continue
            # every line along axis a (the other coordinates fixed), in one
            # order on every rank
            others = [range(self.shape[b]) for b in AXES if b != a]
            for rest in itertools.product(*others):
                idx = list(rest)
                idx.insert(i, slice(None))
                line = [int(r) for r in self.devices[tuple(idx)]]
                g = dist.new_group(line)
                if me in line:
                    self._groups[a] = g

    def group(self, axis: str):
        """This rank's process group along ``axis``, or None (an axis of
        size 1 outside a started world of one)."""
        return self._groups.get(axis)

    def coord(self, axis: str) -> int:
        return 0 if self.coords is None else self.coords[axis]

    def axis_ranks(self, axis: str):
        """The global ranks of this rank's line along ``axis``."""
        idx = [self.coord(a) for a in AXES]
        idx[AXES.index(axis)] = slice(None)
        return [int(r) for r in self.devices[tuple(idx)]]

    def __repr__(self):
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({sizes})"


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class NamedSharding:
    """A ``PartitionSpec`` on a ``Mesh``: this rank holds the block given
    by its coordinates along the named axes."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def _parts(self, ndim: int):
        entries = list(self.spec) + [None] * (ndim - len(self.spec))
        out = []
        for e in entries[:ndim]:
            n, c = 1, 0
            for a in _axes_of(e):
                c = c * self.mesh.shape[a] + self.mesh.coord(a)
                n *= self.mesh.shape[a]
            out.append((n, c))
        return out

    def shard_shape(self, shape) -> tuple:
        return tuple(d // n for d, (n, _) in zip(shape, self._parts(
            len(shape))))

    def index(self, shape) -> tuple:
        """This rank's block as a tuple of slices."""
        out = []
        for d, (n, c) in zip(shape, self._parts(len(shape))):
            b = d // n
            out.append(slice(c * b, (c + 1) * b))
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        return all(self.mesh.shape[a] == 1 for e in self.spec
                   for a in _axes_of(e))

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __hash__(self):
        return hash((id(self.mesh), tuple(self.spec)))

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"


def create_mesh(axes: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence] = None, **axis_sizes) -> Mesh:
    """A mesh from ``{"dp": 2, "tp": 2, ...}``; unlisted axes get size 1.
    ``devices`` are global ranks (default: every rank of the started
    world, else rank 0 alone); the reference's refusals carry over (an
    unknown axis, more ranks asked for than there are)."""
    sizes = dict(axes or {})
    sizes.update(axis_sizes)
    for a in sizes:
        enforce(a in AXES, f"unknown mesh axis {a!r}; valid: {AXES}")
    if devices is None:
        devices = range(dist.get_world_size() if _started() else 1)
    devices = list(devices)
    n = int(np.prod([sizes.get(a, 1) for a in AXES]))
    enforce(n <= len(devices),
            f"mesh wants {n} devices but only {len(devices)} available")
    return Mesh(sizes, devices[:n])


def set_mesh(mesh: Optional[Mesh]):
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_mesh(create_default: bool = False) -> Optional[Mesh]:
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None and create_default:
        _GLOBAL_MESH = create_mesh(
            {"dp": dist.get_world_size() if _started() else 1})
    return _GLOBAL_MESH


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def sharding(mesh: Mesh, *spec) -> NamedSharding:
    """``sharding(mesh, "dp", None)``: rows over dp."""
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
