"""Several processes, one mesh (counterpart of
mini3dgs_tpu/parallel/distributed.py).

Every process runs the same program.  `initialize_distributed` joins them in
one `torch.distributed` group, and `make_global_mesh` lays a (data, tile)
mesh over the ranks of all of them, process-major: the ranks of process 0
first, each process's in the order of its `local_devices`.  By default
`tile` is one process's ranks and `data` the number of processes, so the
tile axis (the band exchanges and the gradient sums of every step) stays
inside a process and the data axis (one mean of the loss and one sum of the
replicated gradients a step) crosses the processes, as the JAX package lays
its axes over hosts.  Any other (data, tile) takes the first data x tile
ranks in that order, as JAX's `make_global_mesh` takes the first devices:
an axis may then span some processes and not others, and a process may
hold no rank at all.  A rank of another process stands in the mesh as a
`mesh.Remote`; each axis that crosses processes exchanges through a group
of exactly its processes (`mesh.form_groups`), and parallel/mesh.py says
how the collectives cross.

A process that holds no rank of the mesh takes part in none of its
exchanges.  The JAX package's step runs there and returns arrays with no
value on that process; the port's steps and renderers return None there.

Nothing here is needed in one process: `make_mesh` stays the default.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, Remote, form_groups, gather_processes


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> None:
    """Join this process to the group, from the arguments or else from the
    environment: COORDINATOR_ADDRESS ("host:port" of process 0),
    NUM_PROCESSES and PROCESS_ID.  A second call, or a call in a process
    already in a group, does nothing.  With no topology given at all it
    returns without a group (one process).  With one given, it forms the
    group or raises: an incomplete topology, or a group that does not form
    within `timeout` seconds, is an error, not one process.  `backend`
    defaults to "nccl" when a card is visible (one process a card) and
    "gloo" otherwise; processes that share a card, or ranks on the CPU,
    pass "gloo".  Nothing tries another backend when one fails."""
    if dist.is_initialized():
        return
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    n = num_processes if num_processes is not None \
        else env.get("NUM_PROCESSES")
    pid = process_id if process_id is not None else env.get("PROCESS_ID")
    given = {"coordinator_address": addr, "num_processes": n,
             "process_id": pid}
    if not any(v not in (None, "") for v in given.values()):
        return
    missing = [k for k, v in given.items() if v in (None, "")]
    if missing:
        raise ValueError(f"initialize_distributed: {missing} not given, "
                         f"with {given}: a group needs all three")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=int(n), rank=int(pid), **kw)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_global_mesh(data: Optional[int] = None, tile: Optional[int] = None,
                     local_devices: Optional[Sequence] = None) -> Mesh:
    """A (data, tile) mesh over the ranks of every process, process-major.
    `local_devices` are this process's ranks (default: every visible card;
    without a card, name CPU devices).  `tile` defaults to one process's
    rank count and `data` to as many rows as the ranks fill; the mesh
    takes the first data * tile ranks.  Raises when data * tile exceeds
    the ranks.  Every process of the group must call it with the same
    arguments at the same point: it forms the groups of the axes that
    cross processes (`mesh.form_groups`)."""
    if local_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_global_mesh: no CUDA device is visible; pass "
                "local_devices= to build a mesh of CPU ranks")
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local_devices = [torch.device(d) for d in local_devices]
    me = process_index()
    counts = gather_processes(len(local_devices))
    owner = [p for p, c in enumerate(counts) for _ in range(c)]
    total = len(owner)
    tile = len(local_devices) if tile is None else tile
    data = total // tile if data is None else data
    if data < 1 or tile < 1 or data * tile > total:
        raise ValueError(f"make_global_mesh: a ({data}, {tile}) mesh over "
                         f"{total} ranks of {len(counts)} processes")
    owner = owner[:data * tile]
    first = owner.index(me) if me in owner else 0
    mesh = Mesh(data, tile, tuple(
        local_devices[k - first] if p == me else Remote(p)
        for k, p in enumerate(owner)))
    form_groups(mesh)
    return mesh
