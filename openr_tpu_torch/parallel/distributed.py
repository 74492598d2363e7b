"""Multi-process sharded solve over `torch.distributed` (port of
`openr_tpu/parallel/distributed.py`).

Only the batched and all-sources SPF shapes spread over processes; the
control plane needs none of this. The wiring is read from the same
environment as the reference's, so a deployment starts identical
processes:

  OPENR_COORDINATOR   host:port of process 0 (its presence turns it on)
  OPENR_NUM_PROCESSES the number of processes
  OPENR_PROCESS_ID    this process's index

`initialize()` joins one process group (gloo for CPU tensors, NCCL for
CUDA ones where this torch has it) and does nothing when the coordinator
is unset. `global_mesh` then lays every process's positions on one mesh,
and `shard_host_array` gives each process its pieces of an array that
every process holds whole (every node holds the whole LSDB, so nothing
is scattered).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from openr_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedArray,
    cuda_devices,
    make_mesh,
    position_device,
    shard,
)

_initialized = False


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the process group (or skip it). Returns True when running
    across processes. The arguments default from the OPENR_* environment;
    without a coordinator this is a no-op that returns False. Idempotent.
    """
    global _initialized
    if _initialized:
        return True
    coordinator = coordinator or os.environ.get("OPENR_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ["OPENR_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["OPENR_PROCESS_ID"])
    import torch.distributed as dist

    backend = ("cpu:gloo,cuda:nccl"
               if torch.cuda.is_available() and dist.is_nccl_available()
               else "gloo")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
    )
    _initialized = True
    return True


def shutdown() -> None:
    """Leave the process group `initialize` joined (and its subgroups)."""
    global _initialized
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def global_mesh(n_graph: int = 1, local_devices: list | None = None) -> Mesh:
    """A mesh over every process's positions (call after `initialize`;
    without a process group, `make_mesh` over `local_devices`).

    `local_devices` (default: every CUDA device of the process) are this
    process's positions, all on one device; a device may repeat. The
    positions are dealt onto the [S, n_graph] grid sources-major, one
    from each process in turn, so a graph row spans the processes and
    its exchanges are the collectives. Every process must call this with
    the same `n_graph`: it builds one process group per graph row, each
    process calling `new_group` for every row in the same order."""
    local = [position_device(d) for d in (
        cuda_devices() if local_devices is None else local_devices)]
    import torch.distributed as dist

    if not dist.is_initialized():
        return make_mesh(n_graph=n_graph, devices=local)
    if len({str(d) for d in local}) > 1:
        raise ValueError(
            f"global_mesh: one device per process, got {local}")
    if local and local[0].type == "cuda":
        torch.cuda.set_device(local[0])
    world, rank = dist.get_world_size(), dist.get_rank()
    per_rank: list = [None] * world
    dist.all_gather_object(per_rank, [str(d) for d in local])
    order = [(r, torch.device(per_rank[r][i]))
             for i in range(max(len(x) for x in per_rank))
             for r in range(world) if i < len(per_rank[r])]
    n_sources = len(order) // n_graph
    if n_sources < 1 or n_graph < 1:
        raise ValueError(
            f"global_mesh: {len(order)} positions cannot fill a graph axis "
            f"of {n_graph}")
    keep = order[: n_sources * n_graph]
    devices = np.empty((n_sources, n_graph), dtype=object)
    ranks = np.empty((n_sources, n_graph), dtype=np.int64)
    for i, (r, d) in enumerate(keep):
        devices[i // n_graph, i % n_graph] = d
        ranks[i // n_graph, i % n_graph] = r
    groups = [dist.new_group(sorted({int(r) for r in ranks[s]}))
              for s in range(n_sources)]
    return Mesh(devices, ranks, rank, groups)


def shard_host_array(arr, mesh: Mesh, spec) -> ShardedArray:
    """This process's pieces of `arr`, which every process passes whole,
    laid out by `spec` (a tuple of axis names or None per dimension, e.g.
    `(GRAPH_AXIS, None)` for table rows, `()` replicated). The sharded
    functions take the result beside plain tensors."""
    return shard(arr, mesh, spec)

