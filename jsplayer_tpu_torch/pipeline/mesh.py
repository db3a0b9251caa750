"""The (dp, gop) mesh: the port's multi-device sharding substrate.

Counterpart of jsplayer_tpu/pipeline/mesh.py.  Batched decode lays out

  * ``dp``  — independent streams (the data-parallel axis), and
  * ``gop`` — keyframe-led windows of one stream (independent decode
    chains, the sequence-parallel axis)

over a grid of slots.  A slot is one rank of the mesh: the sharded steps
(pipeline/batch.py, kernels/lane_recon.make_lane_decode_step) copy each
slot's rows to the slot's device and launch the already-ported kernels
there, one instance a slot.  Streams and keyframe-led windows are
independent, so no slot reads another's data; the only collective is
``Mesh.psum``.

Where JAX places arrays with ``NamedSharding`` and runs ``shard_map``, the
port splits explicitly: ``run_bg`` runs a function on each slot's part of
``P("dp", "gop")`` [B, G, ...] arrays (``bg_slots``), ``run_rows`` on
each slot's rows of a leading-axis spec (``row_slots``: ``P("dp")``,
replicated over gop, or the lane path's ``P(("dp", "gop"))``); both copy
every slot's inputs to its device first, then launch every slot, then
assemble the result on the first local slot's device (the gather slot).
The reference's three ``NamedSharding`` helpers keep their names:
``stream_sharding``, ``batch_sharding`` and ``replicated`` return a
``Placement``, whose ``indices`` says which part of an array each slot holds.

Several processes: ``init_multihost`` joins a torch.distributed process
group over TCP; ``make_mesh`` then lays the slots out process-major, as
``jax.devices()`` orders them, and each process runs only its own slots.
A process owns whole dp rows (gop divides its slot count: keep gop within
one host, as the reference says), and a step returns that process's rows
(``Mesh.local_rows`` says which).

Traced (utils/logging.TRACE, on only while a torch.profiler session
records), both steps build the slots' inputs inside a ``jsp.shard`` span
(the uploads' ``jsp.upload`` spans are its children) and assemble the
result inside ``jsp.gather``; the launches stay in the caller's span.
Always, each call counts (LOG) ``mesh.dispatches`` (one),
``mesh.slot_launches`` (the slots it launched) and
``mesh.exchange_bytes``: the bytes of every tensor input that a slot other
than the gather slot receives (a carry, held on the gather slot's device)
and of every result such a slot returns to the gather.  They are counted
by slot, not by card: on four cards, one slot a card, they are the peer
copies; on one card they count all the same.

An input of ``run_bg`` may be a ``SlotBuilt`` in an array's place: each
slot builds its part on its own device (still elision uploads each slot's
changed paycode rows straight from the host window this way).  Such an
input is an upload from the host, not an exchange between slots, so
``mesh.exchange_bytes`` leaves it out.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import to_device
from ..utils.logging import LOG, TRACE


class Mesh:
    """A [dp, gop] grid of slots: ``devices`` (a numpy object array of
    torch.device, as ``jax.sharding.Mesh.devices``), ``owners`` (the
    process that runs each slot) and ``process_index`` (this process)."""

    axis_names = ("dp", "gop")

    def __init__(self, devices: np.ndarray, owners: np.ndarray,
                 process_index: int = 0):
        self.devices = devices
        self.owners = owners
        self.process_index = process_index
        self.local_slots = [(i, j) for i in range(devices.shape[0])
                            for j in range(devices.shape[1])
                            if owners[i, j] == process_index]
        if not self.local_slots:
            raise ValueError(f"process {process_index} owns no slot of the "
                             f"mesh")
        #: where a step gathers its result: the first local slot's device
        self.device = devices[self.local_slots[0]]

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def local_rows(self, n: int) -> range:
        """The global leading rows (of n, split over dp) that this
        process's slots hold: the rows a step returns here."""
        dp = self.devices.shape[0]
        _check_div(n, dp, "dp")
        rows = sorted({i for i, _ in self.local_slots})
        return range(rows[0] * (n // dp), (rows[-1] + 1) * (n // dp))

    def psum(self, per_slot: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over the mesh of one value a local slot: summed on the
        first local slot's device, then all-reduced over the process group
        when one is up (the reference's ``lax.psum`` over ("dp", "gop"))."""
        total = per_slot[0].to(self.device)
        for t in per_slot[1:]:
            total = total + t.to(self.device)
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            torch.distributed.all_reduce(total)
        return total


def _process_group() -> tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(dp: Optional[int] = None, gop: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (dp, gop) mesh over this process's devices (default: every
    CUDA device; where there is none this raises — the mesh never falls
    back to the CPU).  A device may repeat in `devices`: a slot is a rank,
    not a separate card, so ``[torch.device("cpu")] * 8`` gives the CPU
    tests 8 slots (JAX's 8 virtual CPU devices) and ``["cuda:0"] * 4`` runs
    dp=2, gop=2 on one card.  After init_multihost, `devices` are each
    process's local devices and the mesh spans world size x len(devices)
    slots, process-major; every process passes the same count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "False); pass devices explicitly, e.g. "
                "[torch.device('cpu')] * 8")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    world, rank = _process_group()
    n = world * len(local)
    if dp is None:
        dp = n // gop
    if dp * gop != n:
        raise ValueError(f"dp({dp})*gop({gop}) != ndevices({n})")
    if world > 1 and len(local) % gop:
        raise ValueError(
            f"gop({gop}) must divide each process's {len(local)} slots: a "
            f"process owns whole dp rows")
    arr = np.empty(n, dtype=object)
    arr[:] = [local[k % len(local)] for k in range(n)]
    owners = np.arange(n) // len(local)
    return Mesh(arr.reshape(dp, gop), owners.reshape(dp, gop), rank)


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str = "nccl") -> None:
    """Join a process group over ``tcp://coordinator`` (host:port) as rank
    `process_id` of `num_processes`: NCCL between cards, gloo between CPU
    processes.  make_mesh then spans every process's slots."""
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)


def _check_div(n: int, k: int, axis: str) -> None:
    if n % k:
        raise ValueError(f"{n} rows do not divide over the mesh's {axis} "
                         f"axis of {k}")


def bg_slots(mesh: Mesh, B: int, G: int) -> dict:
    """``P("dp", "gop")`` on [B, G, ...] arrays → {local slot: (the slot's
    stream slice, its window slice)}.  B or G that the axis does not
    divide raise ValueError (where jax.device_put raises)."""
    dp, gop = mesh.devices.shape
    _check_div(B, dp, "dp")
    _check_div(G, gop, "gop")
    bs, gs = B // dp, G // gop
    return {(i, j): (slice(i * bs, (i + 1) * bs), slice(j * gs, (j + 1) * gs))
            for i, j in mesh.local_slots}


def row_slots(mesh: Mesh, n: int, axes=("dp",)) -> dict:
    """A leading-axis spec on [n, ...] arrays → {local slot: its row
    slice}.  ``("dp",)`` is ``P("dp")``: dp rows, replicated over gop, so
    the gop-0 slot of each dp row computes them and the replicas are not
    run; ``("dp", "gop")`` is ``P(("dp", "gop"))``: n split over the slots
    in order."""
    dp, gop = mesh.devices.shape
    if tuple(axes) == ("dp",):
        _check_div(n, dp, "dp")
        k = n // dp
        return {(i, j): slice(i * k, (i + 1) * k)
                for i, j in mesh.local_slots if j == 0}
    if tuple(axes) != ("dp", "gop"):
        raise ValueError(f"unknown sharding axes {axes!r}")
    _check_div(n, dp * gop, "(dp, gop)")
    k = n // (dp * gop)
    return {(i, j): slice((i * gop + j) * k, (i * gop + j + 1) * k)
            for i, j in mesh.local_slots}


class Placement:
    """How an array lies on a mesh, the port's counterpart of a
    ``NamedSharding``: ``spec`` has one entry a leading axis, as a
    ``PartitionSpec`` has (a mesh axis name, a tuple of names, or None);
    the axes it does not name are whole on every slot."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"Placement(spec={self.spec!r}, mesh={self.mesh.shape})"

    def indices(self, shape) -> dict:
        """{slot (i, j): the index (a tuple of slices, one an axis of
        `shape`) of the part that slot holds}, for every slot of the mesh,
        replicas included: ``NamedSharding.devices_indices_map`` keyed by
        slot.  An axis its mesh axes do not divide raises ValueError."""
        dp, gop = self.mesh.devices.shape
        size = {"dp": dp, "gop": gop}
        out = {}
        for i in range(dp):
            for j in range(gop):
                coord = {"dp": i, "gop": j}
                index = [slice(0, n) for n in shape]
                for d, names in enumerate(self.spec):
                    if names is None:
                        continue
                    names = (names,) if isinstance(names, str) else names
                    k, c = 1, 0
                    for name in names:  # major to minor, as JAX orders them
                        k, c = k * size[name], c * size[name] + coord[name]
                    _check_div(shape[d], k, "(" + ", ".join(names) + ")")
                    step = shape[d] // k
                    index[d] = slice(c * step, (c + 1) * step)
                out[(i, j)] = tuple(index)
        return out


def stream_sharding(mesh: Mesh) -> Placement:
    """[B, T, ...] arrays: streams over dp, time/GOP over gop — the
    reference's ``NamedSharding(mesh, P("dp", "gop"))``, the layout
    ``bg_slots`` gives and ``run_bg`` runs."""
    return Placement(mesh, ("dp", "gop"))


def batch_sharding(mesh: Mesh) -> Placement:
    """[B, ...] arrays: streams over dp, replicated over gop — the
    reference's ``NamedSharding(mesh, P("dp"))``, whose spec is the `axes`
    ``row_slots`` and ``run_rows`` take (they run each dp row on its gop-0
    slot, not on the replicas)."""
    return Placement(mesh, ("dp",))


def replicated(mesh: Mesh) -> Placement:
    """Every slot holds the whole array — the reference's
    ``NamedSharding(mesh, P())``."""
    return Placement(mesh, ())


class SlotBuilt:
    """An input of ``run_bg`` that each slot builds for itself: ``shape``
    is the global [B, G, ...] shape it stands for, and ``build(rows, cols,
    device)`` returns the slot's part [rows, cols, ...] (global slices) on
    the slot's device."""

    def __init__(self, shape, build):
        self.shape = tuple(shape)
        self.build = build


def _slot_input(a, rows: slice, n: int, base: int, device,
                cols: Optional[slice] = None):
    """A slot's part a[rows, cols] of a global [n, ...] input, on its
    device.  `a` is a SlotBuilt, or a numpy array or a tensor holding
    either all n leading rows or only this process's (what a step returns,
    e.g. a carried frame), which start at global row `base`.  It only
    copies: it does not wait for the device."""
    if isinstance(a, SlotBuilt):
        return a.build(rows, cols, device)
    if a.shape[0] != n:
        rows = slice(rows.start - base, rows.stop - base)
    part = a[rows] if cols is None else a[rows, cols]
    if isinstance(part, np.ndarray):
        return to_device(part, device)
    return part.to(device)


def _gather(outs: dict, join):
    """Join each output (a tensor, or a tuple of them) over the slots."""
    first = next(iter(outs.values()))
    if isinstance(first, tuple):
        return tuple(join({s: o[k] for s, o in outs.items()})
                     for k in range(len(first)))
    return join(outs)


def _count(mesh: Mesh, arrays, parts: dict, outs: dict) -> None:
    """The counters of one run_bg or run_rows call (the module's
    docstring): what crosses between the gather slot and every other
    slot.  Of the inputs, only tensors cross: numpy arrays and SlotBuilt
    parts come from the host."""
    first = mesh.local_slots[0]
    moved = 0
    for s, xs in parts.items():
        if s == first:
            continue
        moved += sum(x.nbytes for a, x in zip(arrays, xs)
                     if isinstance(a, torch.Tensor))
        o = outs[s]
        moved += sum(t.nbytes for t in (o if isinstance(o, tuple) else (o,)))
    LOG.count("mesh.dispatches")
    LOG.count("mesh.slot_launches", len(outs))
    LOG.count("mesh.exchange_bytes", moved)


def run_bg(mesh: Mesh, fn, *arrays):
    """shard_map over ``P("dp", "gop")``: fn on each local slot's part of
    the [B, G, ...] `arrays` (each a numpy array, a tensor or a
    SlotBuilt), the slot's (b, g) rows flattened into fn's batch axis →
    fn's [B, G, ...] result(s) (this process's dp rows) gathered on the
    mesh's device."""
    # an input may hold only this process's rows (a carry): the others
    # hold all B
    B, G = max(a.shape[0] for a in arrays), arrays[0].shape[1]
    slots = bg_slots(mesh, B, G)
    base = min(rows.start for rows, _ in slots.values())
    with TRACE.span("jsp.shard"):
        # input by input, the SlotBuilt ones last: a blocking upload
        # synchronises its card's stream, so it would wait for the
        # non-blocking copies a SlotBuilt input may queue there
        parts = {s: [None] * len(arrays) for s in slots}
        for k in sorted(range(len(arrays)),
                        key=lambda k: isinstance(arrays[k], SlotBuilt)):
            for s, (rows, cols) in slots.items():
                parts[s][k] = _slot_input(arrays[k], rows, B, base,
                                          mesh.devices[s], cols).flatten(0, 1)
    # every copy above, every launch here: nothing in this loop waits for
    # the device, so slots on separate cards run at once
    outs = {s: fn(*x) for s, x in parts.items()}
    shape = {s: (rows.stop - rows.start, cols.stop - cols.start)
             for s, (rows, cols) in slots.items()}
    gop = mesh.devices.shape[1]

    def join(per_slot):
        dp_rows = sorted({i for i, _ in per_slot})
        return torch.cat([torch.cat([
            per_slot[(i, j)].unflatten(0, shape[(i, j)]).to(mesh.device)
            for j in range(gop)], dim=1) for i in dp_rows])

    with TRACE.span("jsp.gather"):
        out = _gather(outs, join)
    _count(mesh, arrays, parts, outs)
    return out


def run_rows(mesh: Mesh, fn, *arrays, axes=("dp",)):
    """shard_map over a leading-axis spec (row_slots): fn on each slot's
    rows of the [n, ...] `arrays` → fn's result(s), this process's rows in
    order, gathered on the mesh's device."""
    n = max(a.shape[0] for a in arrays)  # as run_bg
    slots = row_slots(mesh, n, axes)
    base = min(rows.start for rows in slots.values())
    with TRACE.span("jsp.shard"):
        parts = {s: [_slot_input(a, rows, n, base, mesh.devices[s])
                     for a in arrays] for s, rows in slots.items()}
    outs = {s: fn(*x) for s, x in parts.items()}  # as run_bg
    with TRACE.span("jsp.gather"):
        out = _gather(outs, lambda per_slot: torch.cat(
            [per_slot[s].to(mesh.device) for s in sorted(per_slot)]))
    _count(mesh, arrays, parts, outs)
    return out
