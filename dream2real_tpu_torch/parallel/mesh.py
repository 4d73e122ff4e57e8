"""The data mesh and its shardings (port of dream2real_tpu/parallel/mesh.py).

The JAX package shards the pose and ray batch axes over a 1-D
``jax.sharding.Mesh`` from one controller. The port's mesh is one process
driving a tuple of ``torch.device``s: ``run_shards`` runs each shard's part
under its device and on a CUDA stream of its own, and brings the results
back to the first device in shard order. No process group, no launcher.

A mesh may name one device several times (``data_mesh(devices=[...])``):
that is the port's stand-in for XLA's virtual CPU devices, so the sharded
paths run on one card, or on the CPU in the tests, with the same splits,
gathers and reductions as across cards.

``auto_mesh()`` is where production code picks the mesh: every visible
CUDA device when there are several, none when there is one or when
``D2R_MESH=0`` (re-read on every call).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import torch

DATA_AXIS = "data"


def canonical(device) -> torch.device:
    """``device`` with its index: "cuda" is the current CUDA device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DataMesh:
    """A 1-D mesh over the data axis: the devices the shards run on, in
    order; a device may repeat. CUDA meshes carry one stream per shard."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                             for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The first device: where inputs come from and results gather."""
        return self.devices[0]

    def distinct(self) -> tuple:
        """The devices of the mesh, each once, in order of first use."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"


class ShardSpec:
    """Where an array's axes go on a mesh (``NamedSharding``'s counterpart):
    ``axis`` is DATA_AXIS for a leading axis split into contiguous shards,
    None for a replicated array."""

    def __init__(self, mesh: DataMesh, axis: Optional[str]):
        self.mesh, self.axis = mesh, axis

    def __repr__(self) -> str:
        return f"ShardSpec({self.mesh!r}, {self.axis!r})"


_AUTO_MESH: Optional[DataMesh] = None


def auto_mesh() -> Optional[DataMesh]:
    """The process-wide mesh over every visible CUDA device, or None when at
    most one is visible or ``D2R_MESH=0``. The mesh is cached and rebuilt
    when the count of devices changes."""
    global _AUTO_MESH
    if os.environ.get("D2R_MESH", "1") == "0":
        return None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n <= 1:
        return None
    if _AUTO_MESH is None or _AUTO_MESH.size != n:
        _AUTO_MESH = data_mesh()
    return _AUTO_MESH


def score_mesh_for(n_poses: int, clip_batch: int) -> Optional[DataMesh]:
    """The mesh for a scoring run of ``n_poses`` candidates, or None when the
    grid is too small to amortise sharding: every dispatch pads to
    ``size * clip_batch`` poses, so a grid below twice that stays on one
    device."""
    mesh = auto_mesh()
    if mesh is None or n_poses < 2 * mesh.size * clip_batch:
        return None
    return mesh


def leads(mesh: Optional[DataMesh], device) -> Optional[DataMesh]:
    """``mesh`` when its first device is ``device``, else None: work the
    caller put on another device, the CPU say, stays there alone."""
    return mesh if mesh is not None and mesh.lead == canonical(device) else None


def data_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> DataMesh:
    """A 1-D mesh over the pose / ray axis: the first ``n_devices`` CUDA
    devices (all of them by default), raising when there are fewer; or the
    ``devices`` named, repeats allowed."""
    if devices is not None:
        return DataMesh(devices)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n_devices is None else n_devices
    if have < want or want < 1:
        raise RuntimeError(f"need {want} CUDA devices, have {have}")
    return DataMesh([torch.device("cuda", i) for i in range(want)])


def pose_sharding(mesh: DataMesh) -> ShardSpec:
    """Shard the leading (pose / ray / image) axis across the mesh."""
    return ShardSpec(mesh, DATA_AXIS)


def replicated(mesh: DataMesh) -> ShardSpec:
    return ShardSpec(mesh, None)


def shard_bounds(n: int, size: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) rows of each of ``size`` shards of ``n`` rows,
    as ``torch.tensor_split`` cuts them."""
    base, extra = divmod(n, size)
    out, start = [], 0
    for i in range(size):
        end = start + base + (i < extra)
        out.append((start, end))
        start = end
    return out


def _tensors(x) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _to_lead(x, lead: torch.device):
    if torch.is_tensor(x):
        return x.to(lead, non_blocking=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_lead(v, lead) for v in x)
    return x


def run_shards(mesh: DataMesh, fn: Callable) -> list:
    """``fn(i, device)`` for each shard i, under its device and on its own
    stream, after the work already queued on the lead's and its own
    device's current streams.
    -> each shard's result, its tensors on the lead device, in shard order;
    the caller's current stream is ordered after the shards through events,
    never a host synchronisation. On the CPU the shards run in turn."""
    lead = mesh.lead
    if lead.type != "cuda":
        return [fn(i, d) for i, d in enumerate(mesh.devices)]
    main = torch.cuda.current_stream(lead)
    ready = main.record_event()
    outs, done = [], []
    for i, (dev, side) in enumerate(zip(mesh.devices, mesh.streams)):
        with torch.cuda.device(dev):
            side.wait_event(ready)
            if dev != lead:
                side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                outs.append(fn(i, dev))
                done.append(side.record_event())
    for event, out in zip(done, outs):
        main.wait_event(event)
        # The shard's tensors were made on its stream: keep their memory
        # from that stream's next allocations until the lead has used them.
        for t in _tensors(out):
            t.record_stream(main)
    return [_to_lead(out, lead) for out in outs]


class ShardDraws:
    """The random numbers of one sharded step. The k-th draw of every shard
    is its rows of one draw over the whole batch from the step's generator,
    made when shard 0 asks for it: so shard i sees what rows
    ``bounds[i]`` of the unsharded step would see, and a one-shard mesh
    draws exactly what the unsharded step draws. Hand ``shard(i)`` to the
    renders in place of a generator (``uniform`` reads either)."""

    def __init__(self, generator: torch.Generator, n_rows: int, n_shards: int):
        self.generator, self.n_rows = generator, n_rows
        self.bounds = shard_bounds(n_rows, n_shards)
        self.draws: list = []  # (tensor, event or None)

    def shard(self, i: int) -> "_ShardView":
        return _ShardView(self, i)

    def _rows(self, k: int, i: int, shape, device) -> torch.Tensor:
        lo, hi = self.bounds[i]
        if shape[0] != hi - lo:
            raise ValueError(f"shard {i} asks for {shape[0]} rows of a draw, it has {hi - lo}")
        if k == len(self.draws):
            if i != 0:
                raise RuntimeError("shard 0 makes every draw before the other shards read it")
            full = torch.rand((self.n_rows, *shape[1:]), generator=self.generator,
                              device=self.generator.device)
            event = torch.cuda.current_stream(full.device).record_event() if full.is_cuda else None
            self.draws.append((full, event))
        full, event = self.draws[k]
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            full.record_stream(stream)
        return full[lo:hi].to(device, non_blocking=True)


class _ShardView:
    def __init__(self, draws: ShardDraws, i: int):
        self.draws, self.i, self.k = draws, i, 0

    def rows(self, shape, device) -> torch.Tensor:
        k, self.k = self.k, self.k + 1
        return self.draws._rows(k, self.i, tuple(shape), device)


def uniform(source, shape, device) -> torch.Tensor:
    """U[0, 1) numbers of ``shape`` on ``device`` from ``source``: a
    ``torch.Generator``, or a shard's view of ``ShardDraws``."""
    if isinstance(source, torch.Generator):
        return torch.rand(shape, generator=source, device=device)
    return source.rows(shape, device)

