"""Ranks laid out on named axes, the counterpart of the parts of
``idc_models_tpu/mesh.py`` that sequence parallelism needs.

The JAX package builds a ``jax.sharding.Mesh`` of devices and lets XLA
insert the collectives. Here one process drives one card, so a mesh is a
grid of ranks of the initialized ``torch.distributed`` world, and for
each axis this rank holds the process group of the ranks that share its
coordinates on every other axis: the group `collectives` and
`ring_attention.make_ring_attention` take. Where ``torch.distributed``
is not initialized the world is this one rank, and every axis has size 1
and group None.

Axis names are the JAX package's: ``"data"`` (the batch axis) and
``"seq"`` (the ring of ring attention). The tensor-parallel mesh, the
sharding helpers and device placement wait for the rest of the
distribution layer (ROADMAP A4-rest).
"""

from __future__ import annotations

import datetime
import itertools
import math
import os

import torch
import torch.distributed as dist

from idc_models_tpu_torch import collectives

DATA_AXIS = "data"
SEQ_AXIS = "seq"
# how long a collective waits for the other ranks before it raises
PROCESS_GROUP_TIMEOUT_S = 600.0


class Mesh:
    """This rank's place in a grid of ranks.

    `shape` maps each axis name to its size, in layout order (the last
    axis innermost: its ranks are neighbours). `coords` is this rank's
    coordinate on each axis, None for a rank outside the grid (the grid
    may use fewer ranks than the world holds). `group(axis)` is the
    process group along `axis` through this rank."""

    def __init__(self, shape: dict[str, int], coords, groups):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = coords
        self._groups = groups

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        if axis not in self.shape:
            raise ValueError(f"mesh {self.axis_names} has no {axis!r} axis")
        if self.coords is None:
            raise ValueError(f"rank {collectives.axis_index()} is not in "
                             f"this mesh of {self.size} ranks")
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(axes: dict[str, int]) -> Mesh:
    """A grid of the first prod(sizes) ranks of the world, the last axis
    innermost. Every rank of the world must call it, in the same order
    as every other mesh: building a process group is collective."""
    world = collectives.axis_size()
    names, sizes = list(axes), list(axes.values())
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {axes}")
    total = math.prod(sizes)
    if total > world:
        raise ValueError(f"mesh {axes} needs {total} ranks, have {world}")
    shape = dict(zip(names, sizes))
    me = collectives.axis_index()
    coords = None
    if me < total:
        coords, rest = {}, me
        for name, size in reversed(shape.items()):
            coords[name], rest = rest % size, rest // size
        coords = {name: coords[name] for name in names}
    groups = {}
    if world > 1:
        strides = {name: math.prod(sizes[i + 1:])
                   for i, name in enumerate(names)}
        for axis in names:
            others = [n for n in names if n != axis]
            for fixed in itertools.product(*(range(shape[n])
                                             for n in others)):
                base = sum(c * strides[n] for n, c in zip(others, fixed))
                ranks = [base + i * strides[axis]
                         for i in range(shape[axis])]
                group = dist.new_group(ranks)
                if me in ranks:
                    groups[axis] = group
    else:
        groups = dict.fromkeys(names)
    return Mesh(shape, coords, groups)


def seq_mesh(n: int | None = None) -> Mesh:
    """1-D sequence-parallel mesh (axis "seq") over n ranks (default:
    all): the ring of `ring_attention`."""
    return make_mesh({SEQ_AXIS: n or collectives.axis_size()})


def data_seq_mesh(n_seq: int, n_data: int | None = None) -> Mesh:
    """2-D ("data", "seq") mesh: the batch over "data", the ring over
    "seq", innermost so its hops join neighbouring ranks. Without
    n_data every remaining rank joins the data axis, and n_seq must
    divide the world (idle ranks would skew any measurement; pass n_data
    to use a subset on purpose)."""
    world = collectives.axis_size()
    if n_data is None:
        if n_seq < 1 or world % n_seq:
            raise ValueError(
                f"n_seq {n_seq} must be a positive divisor of the "
                f"device count ({world}); pass n_data explicitly to "
                f"deliberately use a device subset")
        n_data = world // n_seq
    return make_mesh({DATA_AXIS: n_data, SEQ_AXIS: n_seq})


def largest_dividing_mesh(n_clients: int, n_devices: int | None = None) -> int:
    """The largest rank count <= n_devices that divides n_clients: the
    mesh size for programs whose aggregation cannot absorb weight-0
    padding (the unweighted secure mean)."""
    if n_devices is None:
        n_devices = collectives.axis_size()
    return max(d for d in range(1, min(n_clients, n_devices) + 1)
               if n_clients % d == 0)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Initialize ``torch.distributed`` for a multi-process run: NCCL
    where there is a card, else gloo, with a `PROCESS_GROUP_TIMEOUT_S`
    timeout on every collective.

    `coordinator` is rank 0's ``host:port``, or any URL
    ``torch.distributed`` takes (``file:///path`` for a shared file).
    Arguments left None are read from ``torchrun``'s environment
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with no
    world size given or a world of one it does nothing, as a
    single-process run needs no group. Each process takes the card
    ``LOCAL_RANK`` names (else its rank modulo the cards it sees)."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or collectives.initialized():
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator is None:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=(coordinator if "://" in coordinator
                              else f"tcp://{coordinator}"),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
