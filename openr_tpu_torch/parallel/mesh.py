"""Position meshes for the sharded SPF (port of `openr_tpu/parallel/mesh.py`).

A mesh is an [S, G] grid of positions, each a `torch.device`: the
`sources` axis shards the roots, the `graph` axis the tables or the edge
list. A device may hold several positions: eight positions on one card
(or on the CPU) run every sharding and every exchange of an eight-card
mesh, in turn on one device. A mesh from `distributed.global_mesh` spans
processes: each position also names the process (rank) that drives it,
and each graph row has the process group its exchanges run on.
"""

from __future__ import annotations

import numpy as np
import torch

SOURCES_AXIS = "sources"
GRAPH_AXIS = "graph"


class Mesh:
    """An [S, G] grid of positions.

    `devices` is an [S, G] object array of `torch.device`; `ranks` the
    process of each position (default: all this process's) and `rank`
    this process's; `groups[s]` the `torch.distributed` group of graph
    row s's processes, or None for a mesh inside one process, whose
    exchanges are copies between devices. `shape` maps each axis name to
    its size, as the reference's `Mesh.shape` does."""

    axis_names = (SOURCES_AXIS, GRAPH_AXIS)

    def __init__(self, devices, ranks=None, rank: int = 0, groups=None):
        devs = np.asarray(devices, dtype=object)
        if devs.ndim != 2:
            raise ValueError("Mesh: devices must be an [S, G] grid")
        self.devices = devs
        s, g = devs.shape
        self.ranks = (np.zeros((s, g), dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(s, g))
        self.rank = int(rank)
        self.groups = groups
        self.shape = {SOURCES_AXIS: s, GRAPH_AXIS: g}

    def device(self, s: int, g: int) -> torch.device:
        return self.devices[s, g]

    def is_local(self, s: int, g: int) -> bool:
        """Whether this process drives position (s, g)."""
        return int(self.ranks[s, g]) == self.rank

    def flat(self, s: int, g: int) -> int:
        """The position's index in sources-major order."""
        return s * self.shape[GRAPH_AXIS] + g

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def position_device(d) -> torch.device:
    """`d` as a torch.device with its index where it is a CUDA one
    (`"cuda"` names the current card), so that a tensor's own device
    compares equal to it."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of this process."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_sources: int | None = None, n_graph: int = 1,
              devices: list | None = None) -> Mesh:
    """[n_sources, n_graph] mesh over `devices` (default: every CUDA
    device of the process), filled sources-major. `n_sources` defaults to
    all the devices over `n_graph`. A device may appear more than once.
    Raises ValueError when the mesh needs more devices than given, as the
    reference does (the sizes come from operator config)."""
    devs = list(cuda_devices() if devices is None else devices)
    if n_sources is None:
        n_sources = len(devs) // n_graph
    if n_sources < 1 or n_graph < 1 or n_sources * n_graph > len(devs):
        raise ValueError(
            f"mesh {n_sources}x{n_graph} needs "
            f"{n_sources * n_graph} devices, have {len(devs)}"
        )
    grid = np.empty((n_sources, n_graph), dtype=object)
    for i, d in enumerate(devs[: n_sources * n_graph]):
        grid[i // n_graph, i % n_graph] = position_device(d)
    return Mesh(grid)


def _span(n: int, parts: int, i: int, what: str) -> tuple[int, int]:
    if n % parts:
        raise ValueError(
            f"dimension of size {n} must divide by the {what} axis size "
            f"{parts}"
        )
    step = n // parts
    return i * step, (i + 1) * step


def spec_index(shape, spec, mesh: Mesh, s: int, g: int) -> tuple:
    """Position (s, g)'s (start, stop) in each dimension of an array of
    `shape` laid out by `spec` (one axis name or None per leading
    dimension, as a `PartitionSpec` lists them; the rest whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    pos = {SOURCES_AXIS: s, GRAPH_AXIS: g}
    return tuple(
        (0, n) if ax is None else _span(n, mesh.shape[ax], pos[ax], ax)
        for n, ax in zip(shape, spec)
    )


class ShardedArray:
    """A global array of `shape` laid out over a mesh: `indices` gives
    every position's (start, stop) per dimension, `pieces` the tensor of
    each position this process drives, on its device (positions that
    share a device and an index share one tensor). `spec` names the
    layout where it is a regular one."""

    def __init__(self, mesh: Mesh, shape, spec, pieces: dict,
                 indices: dict | None = None, dtype=None):
        self.mesh = mesh
        self.shape = tuple(int(n) for n in shape)
        self.spec = spec
        self.pieces = pieces
        s_n, g_n = mesh.devices.shape
        self.indices = indices if indices is not None else {
            (s, g): spec_index(self.shape, spec, mesh, s, g)
            for s in range(s_n) for g in range(g_n)
        }
        self.dtype = dtype if dtype is not None else next(
            iter(pieces.values())).dtype

    def local(self):
        """(position, index, piece) of each position this process
        drives."""
        return [(p, self.indices[p], t) for p, t in self.pieces.items()]

    def full(self, device) -> torch.Tensor:
        """The whole array on `device`. Only a mesh inside one process
        holds every piece: raises ValueError otherwise."""
        if len(self.pieces) != len(self.indices):
            raise ValueError(
                "ShardedArray.full: the array spans processes; read the "
                "pieces this process drives (`local()`)"
            )
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for _p, idx, t in self.local():
            if idx not in done:
                done.add(idx)
                out[tuple(slice(a, b) for a, b in idx)] = t.to(device)
        return out

    def cut(self, dim: int, stop: int) -> "ShardedArray":
        """The array's first `stop` entries along `dim`: every piece and
        index cut to them (a view of each piece)."""
        def trim(idx):
            a, b = idx[dim]
            return idx[:dim] + ((a, max(a, min(b, stop))),) + idx[dim + 1:]

        indices = {p: trim(i) for p, i in self.indices.items()}
        pieces = {}
        for p, t in self.pieces.items():
            a, b = indices[p][dim]
            pieces[p] = t.narrow(dim, 0, b - a)
        shape = self.shape[:dim] + (stop,) + self.shape[dim + 1:]
        return ShardedArray(self.mesh, shape, None, pieces, indices,
                            self.dtype)


def shard(arr, mesh: Mesh, spec) -> ShardedArray:
    """The pieces of `arr` (a tensor or a NumPy array, the same whole
    array in every process) for the positions this process drives, laid
    out by `spec`: a view where the position's device is the tensor's
    own, else one copy per device and index. A `ShardedArray` on `mesh`
    with the same spec passes through; raises ValueError on a dimension
    the axis does not divide."""
    if isinstance(arr, ShardedArray):
        if arr.mesh is not mesh or tuple(arr.spec or ()) != tuple(spec):
            raise ValueError(
                f"shard: the array is laid out by {arr.spec} on another "
                f"mesh or spec than {tuple(spec)}"
            )
        return arr
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    s_n, g_n = mesh.devices.shape
    indices = {(s, g): spec_index(t.shape, spec, mesh, s, g)
               for s in range(s_n) for g in range(g_n)}
    made: dict = {}
    pieces = {}
    for p, idx in indices.items():
        if not mesh.is_local(*p):
            continue
        dev = mesh.device(*p)
        key = (str(dev), idx)
        if key not in made:
            view = t[tuple(slice(a, b) for a, b in idx)]
            made[key] = (view.contiguous() if view.device == dev
                         else view.to(dev, copy=True).contiguous())
        pieces[p] = made[key]
    return ShardedArray(mesh, t.shape, tuple(spec), pieces, indices, t.dtype)
