"""Multi-process runtime: initialization and placement across ranks.

Reproduces `vss_tpu/parallel/multihost.py:45-107` on `torch.distributed`.
Every process runs the same program over the same data (SPMD). Each rank
holds the shards of its own slots; the host bookkeeping of a sharded
index is the same on every rank, and a search's merged result is too.

    from vss_tpu_torch.parallel import multihost
    mesh = multihost.initialize()          # process group + global slots
    idx = ShardedHNSWIndex.build(vectors, config, mesh)   # same API
    d, rows = idx.search(queries, k=10)    # the same on every rank

The JAX package's merge is an `all_gather` inside `shard_map`. Here each
rank searches its local shards and the per-shard lists travel through
`dist.all_gather` (`gather_ranks`); ranks own contiguous slot ranges in
rank order, so the gathered blocks are in shard order.

Backends: `nccl` for CUDA slots, `gloo` for CPU slots, unless the caller
names one. NCCL refuses two ranks on one GPU, so ranks that share a card
pass `backend="gloo"`, which carries the lists through host memory. A
backend that fails to initialize raises; nothing falls back to another.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from vss_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = [
    "initialize",
    "global_mesh",
    "is_multiprocess",
    "local_shard_indices",
    "place_sharded",
    "gather_ranks",
]


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _as_mesh(slots: Union[Mesh, Sequence, None]) -> Mesh:
    if slots is None:
        return make_mesh()
    return slots if isinstance(slots, Mesh) else Mesh(slots)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    local_slots: Union[Mesh, Sequence, None] = None,
    timeout_s: float = 300.0,
) -> Mesh:
    """Join the process group and return the global shard mesh.

    Explicit arguments win; otherwise the VSS_COORDINATOR ("host:port"),
    VSS_NUM_PROCESSES and VSS_PROCESS_ID environment variables; with no
    coordinator and no `init_method`, torch's `env://` launch variables.
    `local_slots` are this rank's shard slots (a Mesh or a list of
    devices; default: one slot per visible CUDA card). `backend` defaults
    to `nccl` for CUDA slots and `gloo` for CPU slots."""
    coordinator_address = coordinator_address or os.environ.get("VSS_COORDINATOR")
    if num_processes is None and "VSS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["VSS_NUM_PROCESSES"])
    if process_id is None and "VSS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["VSS_PROCESS_ID"])
    local = _as_mesh(local_slots)
    if backend is None:
        backend = "nccl" if local.devices[0].type == "cuda" else "gloo"
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address is not None
                       else "env://")
    if backend == "nccl":
        torch.cuda.set_device(local.devices[0])
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return global_mesh(local)


def global_mesh(local_slots: Union[Mesh, Sequence, None] = None) -> Mesh:
    """Every rank's local slots, in rank order (every rank sees the same
    mesh). Without a process group: the local slots alone."""
    local = _as_mesh(local_slots)
    if not dist.is_initialized():
        return Mesh(local.devices)
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in local.devices])
    devices, owners = [], []
    for rank, devs in enumerate(gathered):
        devices += devs
        owners += [rank] * len(devs)
    return Mesh(devices, owners)


def is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh holds slots of other ranks."""
    me = _rank()
    return mesh.owners is not None and any(o != me for o in mesh.owners)


def local_shard_indices(mesh: Mesh) -> list[int]:
    """The slots this rank holds, in mesh order."""
    if mesh.owners is None:
        return list(range(mesh.size))
    me = _rank()
    return [s for s, o in enumerate(mesh.owners) if o == me]


def place_sharded(mesh: Mesh, host_array) -> list:
    """This rank's leading-axis slices of `host_array` (numpy or a tensor,
    the full global array on every rank), each on its slot's device; None
    at the slots of other ranks."""
    local = set(local_shard_indices(mesh))
    out = []
    for s, dev in enumerate(mesh.devices):
        if s not in local:
            out.append(None)
            continue
        part = host_array[s]
        part = part if isinstance(part, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(part))
        out.append(part.to(dev))
    return out


def gather_ranks(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's `t` (the same shape and dtype on every rank), in rank
    order, on `t`'s device. Under gloo the tensors travel through host
    memory."""
    src = t.contiguous() if dist.get_backend() == "nccl" else t.detach().cpu().contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out]
