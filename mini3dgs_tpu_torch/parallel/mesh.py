"""A (data, tile) mesh of ranks and the collectives over it (counterpart of
mini3dgs_tpu/parallel/mesh.py and of the `jax.lax` collectives its SPMD
programs use).

The JAX package is single-controller: one process runs `shard_map` programs
over a mesh of devices.  The port keeps that shape.  A `Mesh` names one
`torch.device` per rank; the per-rank code of a `shard_map` body becomes a
Python loop over the ranks of an axis, holding one value per rank in a
list, and the collectives are plain functions over such lists.  A tensor
moves with `.to(device)` when source and destination differ, so on one
card every rank shares `cuda:0` (as JAX's virtual devices share the CPU)
and on a host with several cards each exchange is a device-to-device copy.
Autograd differentiates through the collectives as they stand: the
gradient of `.to` flows back to the source device, and the gradient of a
sum over ranks is the sum over ranks.

Axes:
  * data: camera-batch parallelism; rank d trains view d, gradients are
    averaged over the axis.
  * tile: image-band parallelism; rank t owns a horizontal band of whole
    tile rows, per-Gaussian gradients are summed over the axis.

Across processes (parallel/distributed.py): a mesh may hold ranks of other
OS processes joined by `torch.distributed`.  Such a rank stands in
`Mesh.devices`, and in the device list a collective takes, as
`Remote(process)`, and its entry in every per-rank list is None.  A
collective whose ranks all live in this process runs the code above as it
stands.  Otherwise the values that cross the process boundary go through
one exchange for the whole collective (`_Exchange`: an autograd Function
over `dist.all_to_all_single` with split sizes: the int64 header lengths,
the headers, then the payload as bytes; its backward sends the gradient of
what a rank received back to its sender the same way), and `.to` moves
the rest.  With the gloo backend the payload is staged through host
buffers.  An exchange runs on the group of the processes that hold the
ranks of its axis (`form_groups`: one `torch.distributed` group for each
set of processes that a row or a column of the mesh, or the whole mesh,
spans short of every process; the whole group where it spans them all),
so an axis may lie over some processes and not others.  Every process of
that group issues the axis's exchanges in the same order, forward and
backward, and calls each one even when it moves nothing.  Two groups that
share a process cannot wait on each other: every process runs the same
program, so each issues its data-axis exchanges (the gauss-sharded step's
gathers) before its tile-axis ones, and autograd takes them back in the
reverse order, which the data gathers' outputs feeding the tile exchanges
force.  Two rules keep the gradients right:

  * A reduction (`psum`, `pmean`) across processes sends its gradient to
    the inputs of the process that differentiates it only: every process
    takes the backward of its own copy of the sum, so each term gets its
    gradient exactly once (the sum is linear in its terms).
  * A value that every process of the mesh holds (a replicated
    parameter) gets its gradient from each process's part of the graph;
    `all_reduce_sum` over the mesh's processes adds them once, after the
    backward.  A step that differentiates across
    processes passes `ANCHOR` among the tensors it asks gradients for (see
    `_Exchange`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils import profiling


@dataclass(frozen=True)
class Remote:
    """A rank that process `process` holds: it stands where this process's
    own ranks have their `torch.device`."""

    process: int


def is_local(device) -> bool:
    return not isinstance(device, Remote)


def local_ranks(devices: Sequence) -> List[int]:
    """The positions in `devices` of the ranks this process holds."""
    return [i for i, d in enumerate(devices) if is_local(d)]


def spans_processes(devices: Sequence) -> bool:
    return not all(is_local(d) for d in devices)


@dataclass(frozen=True)
class Mesh:
    """`data` x `tile` ranks; rank (d, t) lives on `devices[d * tile + t]`,
    a `Remote` where another process holds it."""

    data: int
    tile: int
    devices: Tuple[Union[torch.device, Remote], ...]

    def tile_devices(self, d: int = 0) -> list:
        """The devices of the `tile` axis at data index `d`."""
        return list(self.devices[d * self.tile:(d + 1) * self.tile])

    def data_devices(self, t: int = 0) -> list:
        """The devices of the `data` axis at tile index `t`."""
        return list(self.devices[t::self.tile])

    def is_local(self, rank: int) -> bool:
        return is_local(self.devices[rank])

    def local_ranks(self) -> List[int]:
        return local_ranks(self.devices)

    def processes(self) -> Tuple[int, ...]:
        """The processes that hold ranks of the mesh."""
        return processes_of(self.devices)


def make_mesh(data: int = 1, tile: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `data * tile` ranks.  `devices` defaults to every visible
    CUDA device; rank k lives on `devices[k % len(devices)]`, so fewer
    devices than ranks are shared round-robin.  Without a card and without
    `devices` this raises: nothing moves to the CPU unless the caller names
    CPU devices."""
    if data < 1 or tile < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} "
                         f"tile={tile}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= "
                "explicitly to build a mesh of CPU ranks")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    n = data * tile
    return Mesh(data, tile, tuple(devices[k % len(devices)]
                                  for k in range(n)))


def _to(x, device):
    """Move a tensor, or a tuple/list of them, to `device`."""
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    return x.to(device)


# ---------------------------------------------------------------------------
# The cross-process exchange.
# ---------------------------------------------------------------------------

# What this process has put through `torch.distributed`: the calls, the
# bytes sent to other processes (the exchanges' headers and payloads,
# `all_reduce_sum`'s buffer), and the host seconds spent in them (staging
# included, and the wait for the device's pending work and for the other
# processes).
TRAFFIC = {"calls": 0, "bytes": 0, "seconds": 0.0}
profiling.declare(*(f"traffic.{k}" for k in TRAFFIC))


def _traffic(calls: int, nbytes: int, t_start: float) -> None:
    """Add an exchange that began at `t_start` (perf_counter) to TRAFFIC
    and to the active recording's `traffic.*` counters."""
    for k, v in (("calls", calls), ("bytes", nbytes),
                 ("seconds", time.perf_counter() - t_start)):
        TRAFFIC[k] += v
        profiling.count(f"traffic.{k}", v)


# A leaf that every differentiable exchange takes as an input.  It gives
# the exchange an autograd node on a process that sends nothing which
# needs a gradient (the other processes' backward waits for this one's),
# and a step that asks `torch.autograd.grad` for it keeps every exchange
# node in the backward pass, even one whose inputs lead to no other leaf.
ANCHOR = torch.zeros((), requires_grad=True)

_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_TENSOR, _INT, _NONE, _LIST, _TUPLE = range(5)


def _encode(value, spec: list, leaves: list) -> None:
    """Append the structure of `value` (tensors, ints, None, and lists and
    tuples of them) to `spec` as ints, and its tensors to `leaves`."""
    if isinstance(value, torch.Tensor):
        spec += [_TENSOR, _DTYPES.index(value.dtype), value.dim(),
                 *value.shape]
        leaves.append(value)
    elif isinstance(value, int):
        spec += [_INT, int(value)]
    elif value is None:
        spec.append(_NONE)
    elif isinstance(value, (list, tuple)):
        spec += [_TUPLE if isinstance(value, tuple) else _LIST, len(value)]
        for v in value:
            _encode(v, spec, leaves)
    else:
        raise TypeError(f"cannot exchange a {type(value).__name__}")


def _decode(spec: Sequence[int], pos: int, take):
    """The value `_encode` wrote at `spec[pos:]` and the position after
    it; `take(dtype, shape)` supplies each tensor."""
    code = spec[pos]
    if code == _TENSOR:
        ndim = spec[pos + 2]
        shape = tuple(spec[pos + 3:pos + 3 + ndim])
        return take(_DTYPES[spec[pos + 1]], shape), pos + 3 + ndim
    if code == _INT:
        return spec[pos + 1], pos + 2
    if code == _NONE:
        return None, pos + 1
    items = []
    pos += 2
    for _ in range(spec[pos - 1]):
        v, pos = _decode(spec, pos, take)
        items.append(v)
    return (tuple(items) if code == _TUPLE else items), pos


_ITEMSIZE = {dt: torch.empty((), dtype=dt).element_size() for dt in _DTYPES}


def _nbytes(dtype, shape) -> int:
    n = _ITEMSIZE[dtype]
    for s in shape:
        n *= s
    return n


# The groups `form_groups` made, by their processes (sorted).  Every process
# forms the same ones in the same order, so a set of processes names one
# group on each of them.
_GROUPS: Dict[Tuple[int, ...], object] = {}


def _process_of(device) -> int:
    return dist.get_rank() if is_local(device) else device.process


def processes_of(devices: Sequence) -> Tuple[int, ...]:
    """The processes (sorted) that hold the ranks `devices`."""
    if not spans_processes(devices):
        return (dist.get_rank() if dist.is_initialized() else 0,)
    return tuple(sorted({_process_of(d) for d in devices}))


def _group(procs: Tuple[int, ...]):
    """The group of the processes `procs`: the default group when they are
    all the processes there are."""
    if procs == tuple(range(dist.get_world_size())):
        return None
    if procs not in _GROUPS:
        raise RuntimeError(
            f"no group of processes {list(procs)}: a mesh whose axes cross "
            "some processes but not all comes from "
            "distributed.make_global_mesh, which forms its groups")
    return _GROUPS[procs]


def form_groups(mesh: "Mesh") -> dict:
    """One `dist.new_group` for each set of processes that a row or a
    column of `mesh`, or the whole mesh, spans, when that is more than one
    process and fewer than all; {processes: group}.  Every process of the
    default group must call it with the same mesh at the same point of its
    program (each group is formed by all of them, in one order, also by
    those outside it); a set met before reuses its group."""
    if not dist.is_initialized():
        return {}
    world = tuple(range(dist.get_world_size()))
    axes = [mesh.tile_devices(d) for d in range(mesh.data)] \
        + [mesh.data_devices(t) for t in range(mesh.tile)] \
        + [list(mesh.devices)]
    sets = []
    for devices in axes:
        procs = processes_of(devices)
        if 1 < len(procs) < len(world) and procs not in sets:
            sets.append(procs)
    for procs in sets:
        if procs not in _GROUPS:
            _GROUPS[procs] = dist.new_group(list(procs))
    return {procs: _GROUPS[procs] for procs in sets}


def _buffer_device() -> torch.device:
    """Where the exchange's buffers live: the host for gloo, the current
    card for NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _exchange(messages: Sequence[tuple], flag: int = 0,
              procs: Optional[Tuple[int, ...]] = None):
    """One exchange between the processes `procs` (default: all), on their
    group.  `messages` are (process, src, dst, spec, leaves): `spec` a
    structure from `_encode` and `leaves` its tensors, for `process` (this
    one's own included).  Three `all_to_all_single` calls: the int64
    header lengths, the headers (`flag`, the message count, then src, dst
    and the spec of each message), the leaves' bytes.  Returns (messages
    received as (process, src, dst, spec, leaves) in the order of the
    senders and of their lists, leaves on the buffer device; every
    process's `flag`)."""
    t_start = time.perf_counter()
    procs = tuple(range(dist.get_world_size())) if procs is None else procs
    group = _group(procs)
    slot = {p: i for i, p in enumerate(procs)}
    n = len(procs)
    buf = _buffer_device()
    heads = [[flag, 0] for _ in range(n)]
    blobs = [[] for _ in range(n)]
    for proc, src, dst, spec, leaves in messages:
        heads[slot[proc]][1] += 1
        heads[slot[proc]] += [src, dst, len(spec), *spec]
        blobs[slot[proc]] += leaves
    n_out = [len(h) for h in heads]
    n_in = torch.empty(n, dtype=torch.int64, device=buf)
    dist.all_to_all_single(n_in, torch.tensor(n_out, dtype=torch.int64,
                                              device=buf), group=group)
    n_in = n_in.tolist()
    got = torch.empty(sum(n_in), dtype=torch.int64, device=buf)
    dist.all_to_all_single(
        got, torch.tensor([v for h in heads for v in h], dtype=torch.int64,
                          device=buf), n_in, n_out, group=group)
    got = got.tolist()

    # What arrives from each process: its messages' specs and their bytes.
    flags, records, b_in, pos = [], [], [], 0
    for k, proc in enumerate(procs):
        head = got[pos:pos + n_in[k]]
        pos += n_in[k]
        flags.append(head[0])
        at, size = 2, 0
        for _ in range(head[1]):
            src, dst, n_spec = head[at:at + 3]
            spec = head[at + 3:at + 3 + n_spec]
            at += 3 + n_spec
            shapes = []
            _decode(spec, 0, lambda dt, sh: shapes.append((dt, sh)))
            size += sum(_nbytes(dt, sh) for dt, sh in shapes)
            records.append((proc, src, dst, spec, shapes))
        b_in.append(size)
    as_bytes = lambda t: t.detach().contiguous().reshape(-1).view(
        torch.uint8).to(buf)
    b_out = [sum(t.numel() * t.element_size() for t in blob) for blob in blobs]
    flat = [as_bytes(t) for blob in blobs for t in blob]
    payload = torch.cat(flat) if flat else torch.empty(0, dtype=torch.uint8,
                                                       device=buf)
    recv = torch.empty(sum(b_in), dtype=torch.uint8, device=buf)
    dist.all_to_all_single(recv, payload, b_in, b_out, group=group)
    me = slot[dist.get_rank()]
    sent = 8 * (n - 1 + sum(n_out) - n_out[me]) + sum(b_out) - b_out[me]

    out, off = [], 0
    for proc, src, dst, spec, shapes in records:
        leaves = []
        for dt, sh in shapes:
            t = torch.empty(sh, dtype=dt, device=buf)
            n = t.numel() * t.element_size()
            t.reshape(-1).view(torch.uint8).copy_(recv[off:off + n])
            leaves.append(t)
            off += n
        out.append((proc, src, dst, spec, leaves))
    _traffic(3, sent, t_start)
    return out, flags


class _Exchange(torch.autograd.Function):
    """`_exchange` under autograd: forward(plan, ANCHOR, *leaves) -> (the
    leaves received, each on its destination rank's device, then a token).
    `plan` holds the messages' (process, src, dst, spec, leaf count) and the
    devices of the ranks; the forward records what arrived in it.  The
    exchange is differentiable when any process sends a leaf that needs a
    gradient (the header's flag); its backward then sends the gradient of
    every floating leaf received back to its sender (zeros where none
    arrived) and returns the gradients of the leaves sent.  The token is a
    zero scalar: `_tie` makes this process's outputs of the collective
    depend on it, so the backward runs on every process that uses any of
    them, also on one that received nothing."""

    @staticmethod
    def forward(ctx, plan, anchor, *leaves):
        messages, at = [], 0
        for proc, src, dst, spec, n in plan["send"]:
            messages.append((proc, src, dst, spec, list(leaves[at:at + n])))
            at += n
        got, flags = _exchange(messages, int(any(ctx.needs_input_grad[2:])),
                               plan["procs"])
        devices = plan["devices"]
        outs, received = [], []
        for proc, src, dst, spec, ls in got:
            received.append((proc, src, dst, spec, len(ls)))
            outs += [t.to(devices[dst]) for t in ls]
        plan["received"] = received
        token = torch.zeros((), device=plan["token_device"])
        ctx.plan = plan
        ctx.shapes = [(t.dtype, t.shape, t.device) for t in outs]
        ctx.sent = [(t.dtype, t.device) for t in leaves]
        if not any(flags):
            ctx.mark_non_differentiable(*outs, token)
        return (*outs, token)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        back, at = [], 0
        for proc, src, dst, spec, n in plan["received"]:
            gs = []
            for (dt, sh, dev), g in zip(ctx.shapes[at:at + n],
                                        grads[at:at + n]):
                if dt.is_floating_point:
                    gs.append(torch.zeros(sh, dtype=dt, device=dev)
                              if g is None else g)
            at += n
            spec_g, leaves_g = [], []
            _encode(gs, spec_g, leaves_g)
            back.append((proc, dst, src, spec_g, leaves_g))
        got, _ = _exchange(back, procs=plan["procs"])
        # One message comes back for each message sent.  They arrive grouped
        # by the process that returns them, not in the order sent, so each
        # is found by its (src, dst) pair, which names one message.
        returned = {(d, s): iter(ls) for _, s, d, _, ls in got}
        out, at = [], 0
        for proc, src, dst, spec, n in plan["send"]:
            ls = returned[src, dst]
            for dt, dev in ctx.sent[at:at + n]:
                out.append(next(ls).to(dev) if dt.is_floating_point
                           else None)
            at += n
        return (None, None, *out)


class _Tie(torch.autograd.Function):
    """forward(token, *xs) -> views of xs that depend on `token`."""

    @staticmethod
    def forward(ctx, token, *xs):
        ctx.token_device = token.device
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (torch.zeros((), device=ctx.token_device), *grads)


def _map_tensors(fn, v):
    """`v` (tensors in lists, tuples and named tuples) with `fn` applied to
    each tensor."""
    if isinstance(v, torch.Tensor):
        return fn(v)
    if isinstance(v, (list, tuple)):
        items = [_map_tensors(fn, x) for x in v]
        return type(v)(*items) if hasattr(v, "_fields") else type(v)(items)
    return v


def _tie(values: list, token) -> list:
    """`values` (one per rank, None for other processes' ranks) with every
    floating tensor tied to the exchange's `token`."""
    if not token.requires_grad:
        return values
    leaves = []

    def collect(t):
        if t.is_floating_point():
            leaves.append(t)
        return t

    _map_tensors(collect, values)
    if not leaves:
        return values
    tied = iter(_Tie.apply(token, *leaves))
    return _map_tensors(lambda t: next(tied) if t.is_floating_point() else t,
                        values)


def _route(sends: Sequence[tuple], devices: Sequence,
           differentiable: bool = True):
    """Deliver the values `sends` = [(src, dst, value)] (src a rank of this
    process, dst one of another's) over the axis `devices`, through the
    group of the axis's processes.  Returns ({(src, dst): value} for the
    values that arrive here, each on its dst rank's device; the token for
    `_tie`)."""
    plan = {"send": [], "devices": list(devices),
            "procs": processes_of(devices),
            "token_device": devices[local_ranks(devices)[0]]}
    leaves = []
    for src, dst, value in sends:
        spec, ls = [], []
        _encode(value if differentiable else _map_tensors(
            torch.Tensor.detach, value), spec, ls)
        plan["send"].append((devices[dst].process, src, dst, spec, len(ls)))
        leaves += ls
    if differentiable and torch.is_grad_enabled():
        *outs, token = _Exchange.apply(plan, ANCHOR, *leaves)
    else:
        with torch.no_grad():
            *outs, token = _Exchange.apply(plan, ANCHOR, *leaves)
    got, it = {}, iter(outs)
    for _, src, dst, spec, n in plan["received"]:
        got[src, dst] = _decode(spec, 0, lambda dt, sh: next(it))[0]
    return got, token


def _first_ranks(devices: Sequence) -> Dict[int, int]:
    """Each process's first rank on the axis."""
    first = {}
    for r, d in enumerate(devices):
        first.setdefault(_process_of(d), r)
    return first


def _gather_values(xs: Sequence, devices: Sequence,
                   differentiable: bool = True):
    """Every rank's value of `xs` as this process sees it (its own ranks'
    as they are, the others' received once a process on its first rank's
    device), and the token."""
    mine = local_ranks(devices)
    first = _first_ranks(devices)
    me = dist.get_rank()
    got, token = _route([(r, first[q], xs[r]) for r in mine
                         for q in first if q != me], devices, differentiable)
    return [xs[r] if r in mine else got[r, first[me]]
            for r in range(len(devices))], token


# ---------------------------------------------------------------------------
# The collectives.
# ---------------------------------------------------------------------------

def gather_ranks(xs: Sequence, devices: Sequence) -> list:
    """Every rank's value of `xs` (tensors, ints, None, and lists and
    tuples of them; None for another process's rank), detached: the other
    processes' ranks' through one exchange of the axis's group, on the
    device of this process's first rank of the axis.  `xs` itself when the
    axis lies in this process."""
    if not spans_processes(devices):
        return list(xs)
    return _gather_values(xs, devices, differentiable=False)[0]


def all_to_all(xs: Sequence[Sequence], devices: Sequence) -> List[list]:
    """`xs[r][d]` is what rank r sends to rank d; returns `out[d][r]`, what
    rank d received from rank r (a transpose of the list of lists)."""
    n = len(devices)
    if not spans_processes(devices):
        return [[_to(xs[r][d], devices[d]) for r in range(n)]
                for d in range(n)]
    mine = local_ranks(devices)
    got, token = _route([(r, d, xs[r][d]) for r in mine for d in range(n)
                         if d not in mine], devices)
    return _tie([[got[r, d] if (r, d) in got else _to(xs[r][d], devices[d])
                  for r in range(n)] if d in mine else None
                 for d in range(n)], token)


def ppermute(xs: Sequence, perm: Sequence[Tuple[int, int]],
             devices: Sequence) -> list:
    """Rank `dst` receives `xs[src]` for every (src, dst) of `perm`; a rank
    that no pair names as destination receives zeros of its own value's
    shape (as `jax.lax.ppermute` gives)."""
    sources = dict((dst, src) for src, dst in perm)
    if len(sources) != len(perm) or len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a partial permutation")
    if not spans_processes(devices):
        return [_to(xs[sources[d]], devices[d]) if d in sources
                else torch.zeros_like(xs[d]) for d in range(len(devices))]
    mine = local_ranks(devices)
    got, token = _route([(s, d, xs[s]) for s, d in perm
                         if s in mine and d not in mine], devices)
    out = [None] * len(devices)
    for d in mine:
        if d not in sources:
            out[d] = torch.zeros_like(xs[d])
        else:
            s = sources[d]
            out[d] = got[s, d] if (s, d) in got else _to(xs[s], devices[d])
    return _tie(out, token)


def all_gather(xs: Sequence, devices: Sequence, dim: int = 0) -> list:
    """Every rank receives the ranks' tensors concatenated along `dim`; a
    tuple of tensors a rank gathers field by field."""
    if isinstance(xs[local_ranks(devices)[0]], tuple):
        if spans_processes(devices):
            vals, token = _gather_values(xs, devices)
            return _tie(_cat_fields(vals, devices, dim), token)
        return _cat_fields(xs, devices, dim)
    if not spans_processes(devices):
        return [torch.cat([x.to(dev) for x in xs], dim=dim)
                for dev in devices]
    vals, token = _gather_values(xs, devices)
    return _tie([torch.cat([x.to(dev) for x in vals], dim=dim)
                 if is_local(dev) else None for dev in devices], token)


def _cat_fields(xs: Sequence[tuple], devices: Sequence, dim: int) -> list:
    """`all_gather` of tuples, field by field, on the local ranks: the
    gathers of one field on every rank, then the next field's."""
    first = xs[local_ranks(devices)[0]]
    fields = [[torch.cat([x[f].to(dev) for x in xs], dim=dim)
               if is_local(dev) else None for dev in devices]
              for f in range(len(first))]
    build = (lambda items: type(first)(*items)) if hasattr(first, "_fields") \
        else tuple
    return [build([field[i] for field in fields]) if is_local(dev) else None
            for i, dev in enumerate(devices)]


def psum(xs: Sequence[torch.Tensor], devices: Sequence) -> list:
    """Every rank receives the sum over the ranks, added in rank order.
    Across processes the other processes' terms arrive detached, so the
    gradient of the sum reaches this process's terms only."""
    if spans_processes(devices):
        xs, _ = _gather_values(xs, devices, differentiable=False)
    out = []
    for dev in devices:
        if not is_local(dev):
            out.append(None)
            continue
        total = xs[0].to(dev)
        for x in xs[1:]:
            total = total + x.to(dev)
        out.append(total)
    return out


def pmean(xs: Sequence[torch.Tensor], devices: Sequence) -> list:
    """Every rank receives the mean over the ranks."""
    return [None if x is None else x / len(devices)
            for x in psum(xs, devices)]


# ---------------------------------------------------------------------------
# Between the processes, outside the collectives of an axis.
# ---------------------------------------------------------------------------

def gather_processes(value, device=None,
                     processes: Optional[Tuple[int, ...]] = None) -> list:
    """Every process's `value` (tensors, ints, None, and lists and tuples
    of them), in the order of `processes` (default: all, through the
    default group; else through their group, of which this process is
    one), without autograd; the others' tensors on `device` (default: the
    exchange's buffer device).  One process alone gets [value]."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [value]
    procs = tuple(range(dist.get_world_size())) if processes is None \
        else tuple(processes)
    me = dist.get_rank()
    spec, leaves = [], []
    _encode(_map_tensors(torch.Tensor.detach, value), spec, leaves)
    got, _ = _exchange([(q, me, q, spec, leaves) for q in procs if q != me],
                       procs=procs)
    out = [None] * len(procs)
    out[procs.index(me)] = value
    for proc, _, _, sp, ls in got:
        it = iter(ls if device is None else [t.to(device) for t in ls])
        out[procs.index(proc)] = _decode(sp, 0, lambda dt, sh: next(it))[0]
    return out


def all_reduce_sum(tensors: Sequence[Optional[torch.Tensor]],
                   processes: Tuple[int, ...]) -> list:
    """The sums over the processes `processes` of float32
    `tensors` (one `dist.all_reduce` of one flat buffer on their group,
    staged through the host under gloo); None stays None."""
    live = [t for t in tensors if t is not None]
    if not live:
        return list(tensors)
    t_start = time.perf_counter()
    flat = torch.cat([t.reshape(-1) for t in live]).to(_buffer_device())
    dist.all_reduce(flat, group=_group(tuple(processes)))
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.device))
        at += t.numel()
    _traffic(1, flat.numel() * flat.element_size(), t_start)
    return out
