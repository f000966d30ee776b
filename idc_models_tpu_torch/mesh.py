"""Ranks laid out on named axes, the counterpart of
``idc_models_tpu/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` of devices and lets XLA
insert the collectives. Here one process drives one card, so a mesh is a
grid of ranks of the initialized ``torch.distributed`` world, and for
each axis this rank holds the process group of the ranks that share its
coordinates on every other axis: the group `collectives` and
`ring_attention.make_ring_attention` take. Where ``torch.distributed``
is not initialized the world is this one rank, and every axis has size 1
and group None.

Axis names are the JAX package's: ``"data"`` (the batch axis, and
FSDP's parameter axis), ``"model"`` (tensor parallelism: weights only,
never activations), ``"client"`` (federated clients, `client_mesh`) and
``"seq"`` (the ring of ring attention).

A sharding is a (mesh, spec) pair (`Sharding`); a spec
(`PartitionSpec`) names, for each leading dim of a tensor, the mesh
axis or axes it is split over. A tensor does not carry its sharding:
`put_with_sharding` returns this rank's block, and `gather_block` puts
the blocks back together.

`launch_cpu_pod` is the counterpart of ``force_cpu_pod``: where the JAX
package fakes N devices in one process, the port starts N processes,
gloo ranks on the CPU joined through a ``file://`` rendezvous (the
verbs' ``--host-devices N``, and the example scripts' through
``script=``).
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from idc_models_tpu_torch import collectives

DATA_AXIS = "data"
MODEL_AXIS = "model"
CLIENT_AXIS = "client"
SEQ_AXIS = "seq"
# how long a collective waits for the other ranks before it raises
PROCESS_GROUP_TIMEOUT_S = 600.0
# the rendezvous URL a rank of `launch_cpu_pod` joins through
POD_ENV = "IDC_TORCH_CPU_POD"
# how long `launch_cpu_pod` waits for its ranks before it kills them
POD_TIMEOUT_S = 3600.0


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
        self._host = None

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

    def host_group(self):
        """A gloo group of the mesh's ranks for host values (clock
        readings, decisions), whatever the world's backend; None outside
        an initialized world. Built on first use, and like `make_mesh`
        every rank of the world must make that first call, in the same
        order."""
        if self._host is None and collectives.initialized():
            self._host = dist.new_group(list(range(self.size)),
                                        backend="gloo")
        return self._host

    def axis_size(self, axis: str) -> int:
        """The axis's size, 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on the axis, 0 for an axis the mesh
        does not have."""
        if axis not in self.shape:
            return 0
        if self.coords is None:
            raise ValueError(f"rank {collectives.axis_index()} is not in "
                             f"this mesh of {self.size} ranks")
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(axes: dict[str, int]) -> Mesh:
    """A grid of the first prod(sizes) ranks of the world, the last axis
    innermost. Every rank of the world must call it, in the same order
    as every other mesh: building a process group is collective. In an
    initialized world every axis gets a group, one of one rank too, so a
    world of one runs its collectives' code over the real backend."""
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
    if collectives.initialized():
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


def data_mesh(n: int | None = None) -> Mesh:
    """1-D data-parallel mesh (axis "data") over n ranks (default: all)."""
    return make_mesh({DATA_AXIS: n or collectives.axis_size()})


def client_mesh(n: int | None = None) -> Mesh:
    """1-D federated mesh (axis "client") over the first n ranks
    (default: all): the group a round's clients split over, each rank
    training its k = C/n of them. With fewer ranks than the world it is
    a sub-group; the ranks past it are outside the mesh (coords None)
    and take each round's result from its rank 0
    (`federated.fedavg.ClientLayout.share`)."""
    return make_mesh({CLIENT_AXIS: n or collectives.axis_size()})


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


def fsdp_tp_mesh(fsdp: int = 1, tp: int = 1, seq: int = 1) -> Mesh:
    """3-D ("data", "model", "seq") mesh for the sharded LM: FSDP shards
    the parameters and optimizer moments over "data" (the batch axis),
    tensor parallelism shards them over "model", and "seq" carries the
    ring. Size-1 axes stay in the mesh (the partition rules drop them),
    and exactly fsdp * tp * seq ranks are used, as the JAX package's."""
    for name, v in (("fsdp", fsdp), ("tp", tp), ("seq", seq)):
        if v < 1:
            raise ValueError(f"{name} degree must be >= 1, got {v}")
    n = collectives.axis_size()
    if fsdp * tp * seq > n:
        raise ValueError(
            f"mesh fsdp={fsdp} x tp={tp} x seq={seq} needs "
            f"{fsdp * tp * seq} devices, have {n}")
    return make_mesh({DATA_AXIS: fsdp, MODEL_AXIS: tp, SEQ_AXIS: seq})


def largest_dividing_mesh(n_clients: int, n_devices: int | None = None) -> int:
    """The largest rank count <= n_devices that divides n_clients: the
    mesh size for programs whose aggregation cannot absorb weight-0
    padding (the unweighted secure mean)."""
    if n_devices is None:
        n_devices = collectives.axis_size()
    return max(d for d in range(1, min(n_clients, n_devices) + 1)
               if n_clients % d == 0)


# ---------------------------------------------------------------------------
# specs and shardings
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """How a tensor's leading dims lie over mesh axes, the port's
    ``jax.sharding.PartitionSpec``: one entry per dim -- an axis name, a
    tuple of names (the dim split over their product, the first
    outermost) or None (not split); dims past the last entry are not
    split. A tuple of one name is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


P = PartitionSpec


def axes_of(entry) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec over a mesh: the ``NamedSharding`` of the port."""

    mesh: Mesh
    spec: PartitionSpec


def sharding(mesh: Mesh, *spec) -> Sharding:
    """`Sharding` for `spec` over `mesh` (e.g. sharding(mesh, "data"))."""
    return Sharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, P())


def batch_axes(mesh: Mesh, axis: str = SEQ_AXIS):
    """The axis group a leading batch dimension shards over on a
    sequence-parallel mesh: every axis except the ring `axis` and the
    weight-only "model" axis, None when there is none."""
    others = tuple(a for a in mesh.axis_names
                   if a not in (axis, MODEL_AXIS))
    return others if others else None


def batch_seq_spec(mesh: Mesh, axis: str = SEQ_AXIS,
                   trailing: int = 2) -> PartitionSpec:
    """The sequence-parallel activation layout: the batch over every
    non-`axis` axis but "model", the sequence dim over `axis`, then
    `trailing` unsplit dims ([B, T, H, D]: 2; the residual stream
    [B, T, E]: 1)."""
    return P(batch_axes(mesh, axis), axis, *([None] * trailing))


def batch_seq_sharding(mesh: Mesh, axis: str = SEQ_AXIS,
                       trailing: int = 2) -> Sharding:
    return Sharding(mesh, batch_seq_spec(mesh, axis, trailing))


def batch_axis(mesh: Mesh, axis: str | None = None) -> str:
    """The axis a leading batch dimension shards over: `axis` if given,
    else "data" when present, else the mesh's only axis."""
    if axis is not None:
        return axis
    if DATA_AXIS in mesh.axis_names:
        return DATA_AXIS
    if len(mesh.axis_names) == 1:
        return mesh.axis_names[0]
    raise ValueError(f"cannot infer batch axis from mesh axes "
                     f"{mesh.axis_names}; pass axis=...")


def _split(mesh: Mesh, entry) -> tuple[tuple[str, ...], int, int]:
    """(axes, parts, this rank's part) of one spec entry on `mesh`."""
    axes = axes_of(entry)
    parts, index = 1, 0
    for a in axes:
        parts *= mesh.axis_size(a)
        index = index * mesh.axis_size(a) + mesh.axis_index(a)
    return axes, parts, index


def put_with_sharding(a, sh: Sharding, device=None) -> torch.Tensor:
    """This rank's block of `a` (a host array or a tensor) under `sh`,
    on `device` when given. Every dim the spec splits must divide into
    its parts."""
    x = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    if len(sh.spec) > x.dim():
        raise ValueError(f"spec {sh.spec} has more entries than the "
                         f"{x.dim()} dims of a {tuple(x.shape)} tensor")
    for dim, entry in enumerate(sh.spec):
        _, parts, index = _split(sh.mesh, entry)
        if parts == 1:
            continue
        if x.shape[dim] % parts:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide into {parts} blocks for {sh.spec}")
        size = x.shape[dim] // parts
        x = x.narrow(dim, index * size, size)
    return x if device is None else x.to(device)


def gather_block(x: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """The whole tensor from every rank's block under `sh` (the inverse
    of `put_with_sharding`): for each split dim, its axes' blocks
    gathered innermost axis first."""
    for dim, entry in enumerate(sh.spec):
        for a in reversed(axes_of(entry)):
            if sh.mesh.axis_size(a) > 1:
                x = collectives.all_gather(x, sh.mesh.group(a), axis=dim,
                                           tiled=True)
    return x


def local_device_count() -> int:
    """The cards this process drives: one (a process per card)."""
    return 1


def process_index() -> int:
    return collectives.axis_index()


# ---------------------------------------------------------------------------
# joining a world
# ---------------------------------------------------------------------------


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Initialize ``torch.distributed`` for a multi-process run: NCCL
    where there is a card, else gloo, with a `PROCESS_GROUP_TIMEOUT_S`
    timeout on every collective. Nothing falls back: a backend that
    fails to start raises.

    `coordinator` is rank 0's ``host:port``, or any URL
    ``torch.distributed`` takes (``file:///path`` for a shared file).
    Arguments left None are read from ``torchrun``'s environment
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with no
    world size given it does nothing, as a single-process run needs no
    group, and a world of one (``torchrun --nproc-per-node 1``) gets its
    group. Each process takes the card ``LOCAL_RANK`` names (else its
    rank modulo the cards it sees), set before the group starts."""
    env = os.environ
    if num_processes is None:
        if "WORLD_SIZE" not in env:
            return
        num_processes = int(env["WORLD_SIZE"])
    if num_processes < 1 or collectives.initialized():
        return
    if num_processes == 1 and coordinator is None and "MASTER_ADDR" not in env:
        return
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
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


def in_cpu_pod() -> bool:
    """Whether this process is a rank `launch_cpu_pod` started."""
    return POD_ENV in os.environ


def join_world() -> bool:
    """Join the world this process was started into: a rank of
    `launch_cpu_pod` through its rendezvous, a ``torchrun`` rank through
    torchrun's environment; nothing for a process started alone, or
    already in a world. True when this call joined one."""
    if collectives.initialized():
        return False
    if in_cpu_pod():
        initialize_multihost(os.environ[POD_ENV])
    else:
        initialize_multihost()
    return collectives.initialized()


def leave_world() -> None:
    """Take down the world `join_world` joined, once every rank is done
    (a barrier first): no process group is left to the interpreter's
    exit, where gloo's threads can abort it."""
    if collectives.initialized():
        dist.barrier()
        dist.destroy_process_group()


def launch_cpu_pod(n: int, argv: list[str], *,
                   script: str | os.PathLike | None = None) -> int:
    """Run ``python -m idc_models_tpu_torch <argv>`` (or, with `script`,
    ``python <script> <argv>``) as n gloo ranks on
    the CPU (no card is visible to them), joined through a ``file://``
    rendezvous in a temporary directory, and wait for them at most
    `POD_TIMEOUT_S`. The ranks share the host's cores: each takes its
    share, one thread at least, and no more than ``OMP_NUM_THREADS``
    where that is set. Rank 0's standard output and error are passed on; when a rank fails, every rank is killed and this raises
    ``SystemExit`` with the failing rank's last error line (a verb's
    refusal reads as it would from one process). Returns 0."""
    if n < 1:
        raise ValueError(f"--host-devices {n} must be >= 1")
    deadline = time.monotonic() + POD_TIMEOUT_S
    threads = max(1, (os.cpu_count() or 1) // n)
    if os.environ.get("OMP_NUM_THREADS", "").isdigit():
        threads = max(1, min(threads, int(os.environ["OMP_NUM_THREADS"])))
    pythonpath = os.pathsep.join(
        [str(Path(__file__).resolve().parent.parent)]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])
    command = ([sys.executable, str(Path(script).resolve())]
               if script is not None
               else [sys.executable, "-m", "idc_models_tpu_torch"])
    with tempfile.TemporaryDirectory(prefix="idc_cpu_pod_") as tmp:
        tmp = Path(tmp)
        base = dict(os.environ, CUDA_VISIBLE_DEVICES="", WORLD_SIZE=str(n),
                    OMP_NUM_THREADS=str(threads), PYTHONPATH=pythonpath,
                    **{POD_ENV: f"file://{tmp / 'store'}"})
        procs, files = [], []
        try:
            for r in range(n):
                out = open(tmp / f"out.{r}", "w")
                err = open(tmp / f"err.{r}", "w")
                files += [out, err]
                procs.append(subprocess.Popen(
                    [*command, *argv],
                    stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
            while any(p.poll() is None for p in procs):
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=60)
            for f in files:
                f.close()
        codes = [p.returncode for p in procs]
        sys.stdout.write((tmp / "out.0").read_text())
        sys.stdout.flush()
        if codes == [0] * n:
            sys.stderr.write((tmp / "err.0").read_text())
            return 0
        # the first rank that failed by itself (not killed here)
        failed = [r for r, c in enumerate(codes) if c not in (0, -9)]
        r = failed[0] if failed else 0
        lines = [line for line in (tmp / f"err.{r}").read_text()
                 .splitlines() if line.strip()]
        if not failed:
            raise SystemExit(f"the CPU pod of {n} ranks did not finish in "
                             f"{POD_TIMEOUT_S} s; ranks "
                             f"killed")
        if codes[r] == 1 and lines:
            raise SystemExit(lines[-1])
        raise SystemExit(f"rank {r} of the CPU pod of {n} ended with "
                         f"{codes[r]}:\n" + "\n".join(lines[-20:]))
