"""The collectives of the sharded paths, over ``torch.distributed``: exactly
what the reference's ``shard_map`` bodies call.

==================  ===============================  ===========================
reference           here                             used by
==================  ===============================  ===========================
``lax.ppermute``    :func:`ppermute` (a ring hop)    the bucket exchange
``lax.all_to_all``  :func:`all_to_all`               corpus-sharded dist keys,
                                                     ``exchange_bucket_tables``
``lax.all_gather``  :func:`all_gather` (tiled)       frontiers, gathered rows,
                                                     ZeRO-3 leaves, K/V blocks
``lax.psum_scatter`` :func:`reduce_scatter`          leaf gradients, table rows
``lax.pmin``        :func:`pmin`                     adjacency slices, checks
``lax.psum``        :func:`psum`                     termination bit, stats,
                                                     loss sums, node buffers
``lax.axis_index``  :func:`axis_index`               block offsets
(replicated draw)   :func:`broadcast`                RandomGraph(S)
==================  ===============================  ===========================

Each takes the mesh and the physical axes it spans (``sharding.mesh_axes``)
and runs over the process group of this rank's slice of those axes; ranks
are addressed by their index along the axes, so ``ppermute(t, mesh, axes,
j)`` sends to index (me + j) % D and receives from (me - j) % D, the
reference's ``perm = [(s, (s + j) % D)]``.

Gradients: ``all_gather``, ``reduce_scatter``, ``all_to_all`` and ``psum``
are differentiable. On a tensor that requires grad (and with grad on) each
runs as an autograd Function whose backward is its transpose over the same
ranks: an all_gather's is a reduce-scatter, a reduce-scatter's an
all_gather, an all_to_all's the inverse exchange (the same call), a psum's a
psum. That is the gradient of the sum over the ranks of what each rank
differentiates: a rank that repeats another's work must weight its part of
the objective down (``distributed/fsdp.py``). The backward's collectives are
counted like any other.

A meta tensor (the dry run's step, ``launch/dryrun.py``) gets an output
of the shape and dtype the collective gives and sends nothing: the mesh
may be a production grid with no process group behind it
(``launch.mesh.make_production_mesh``). Nothing is counted for it.

Under ``gloo`` every CUDA tensor goes through a pinned host buffer, copied
by this layer, for every collective. Gloo's send/recv take CPU tensors only;
its all_reduce, broadcast, all_gather and all_to_all_single take CUDA
tensors (probed on an H100 by ``chip_smoke.py``'s sharded phase) and stage
them through host memory themselves. The layer stages them all, one way,
and counts every byte; the staging is the path, not a retry after an
error. Under ``nccl`` tensors go to the collective as they are.

:class:`CommStats` (``mesh.stats``) counts, per collective: calls, payload
bytes this rank put on the wire (``sent_bytes``; a ring hop's block, the
(D - 1)/D of an all_to_all that leaves the rank, the own block times
D - 1 for an all_gather, the tensor for an all_reduce) and the bytes copied
from the card into pinned host memory for it (``staged_bytes``; as many
come back), and times each call: CUDA events around it on a CUDA tensor,
the host clock otherwise.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.obs import trace as T


@dataclasses.dataclass
class CommStats:
    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    sent_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    staged_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    host_s: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    events: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(list))

    def reset(self) -> None:
        for c in (self.calls, self.sent_bytes, self.staged_bytes, self.host_s):
            c.clear()
        self.events.clear()

    def seconds(self, op: str) -> float:
        """Time inside ``op`` so far: the CUDA events' intervals (it
        synchronises the card) plus host-timed calls."""
        evs = self.events.get(op, [])
        if evs:
            evs[-1][1].synchronize()
        return self.host_s[op] + sum(a.elapsed_time(b) for a, b in evs) / 1e3

    def summary(self) -> dict:
        ops = sorted(set(self.calls))
        return {op: {"calls": self.calls[op], "sent_bytes": self.sent_bytes[op],
                     "staged_bytes": self.staged_bytes[op], "seconds": self.seconds(op)}
                for op in ops}


class _Call:
    """Accounting of one collective: timing, staging in and out."""

    def __init__(self, mesh, op: str, like: torch.Tensor):
        self.stats, self.op = mesh.stats, op
        self.stage = mesh.backend == "gloo" and like.is_cuda
        self.cuda = like.is_cuda

    def __enter__(self):
        self.stats.calls[self.op] += 1
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        else:
            self.tm = T.timed(f"comm/{self.op}").__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev[1].record()
            self.stats.events[self.op].append(self.ev)
        else:
            self.tm.__exit__(*exc)
            self.stats.host_s[self.op] += self.tm.seconds
        return False

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor to hand the collective: ``t`` itself, or its pinned
        host copy, complete before this returns."""
        if not self.stage:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        self.stats.staged_bytes[self.op] += t.numel() * t.element_size()
        return host

    def buffer(self, like: torch.Tensor, shape=None) -> torch.Tensor:
        """A receive buffer: on the device, or pinned on the host."""
        shape = like.shape if shape is None else shape
        if self.stage:
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def back(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        return t.to(device, non_blocking=True) if self.stage else t

    def sent(self, nbytes: int) -> None:
        self.stats.sent_bytes[self.op] += nbytes


def _slice(mesh, axes):
    group, ranks = mesh.group(tuple(axes))
    return group, ranks, ranks.index(mesh.rank)


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major over them)."""
    return _slice(mesh, axes)[2]


def axis_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pack(ts) -> torch.Tensor:
    """Tensors -> one flat uint8 buffer, each piece at an 8-byte aligned
    offset (so every view taken back is aligned)."""
    parts = []
    for t in ts:
        b = t.contiguous().view(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % 8:
            parts.append(b.new_zeros(8 - b.numel() % 8))
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)


def _unpack(buf: torch.Tensor, like) -> list:
    out, at = [], 0
    for t in like:
        nb = _nbytes(t)
        out.append(buf[at:at + nb].view(t.dtype).view(t.shape))
        at += nb + (-nb) % 8
    return out


def ppermute(tensors, mesh, axes, shift: int):
    """One ring hop: send ``tensors`` (a tensor, or a tuple of tensors and
    Nones, of the same shapes and dtypes on every rank) to index
    (me + shift) % D and return what index (me - shift) % D sent here, in
    the same structure."""
    single = isinstance(tensors, torch.Tensor)
    ts = (tensors,) if single else tuple(tensors)
    live = [t for t in ts if t is not None]
    if live and live[0].is_meta:
        out = tuple(None if t is None else torch.empty_like(t) for t in ts)
        return out[0] if single else out
    group, ranks, me = _slice(mesh, axes)
    d = len(ranks)
    if d == 1 or shift % d == 0 or not live:
        return tensors
    buf = _pack(live)
    with _Call(mesh, "ppermute", buf) as c:
        send = c.out(buf)
        recv = c.buffer(send)
        ops = [dist.P2POp(dist.isend, send, ranks[(me + shift) % d], group),
               dist.P2POp(dist.irecv, recv, ranks[(me - shift) % d], group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        c.sent(sum(_nbytes(t) for t in live))
        got = iter(_unpack(c.back(recv, buf.device), live))
    out = tuple(None if t is None else next(got) for t in ts)
    return out[0] if single else out


def _all_to_all(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    d = axis_size(mesh, axes)
    if t.shape[0] != d:
        raise ValueError(f"all_to_all needs a leading axis of {d} blocks, got {tuple(t.shape)}")
    if d == 1:
        return t
    if t.is_meta:
        return torch.empty_like(t)
    group, ranks, me = _slice(mesh, axes)
    t = t.contiguous()
    with _Call(mesh, "all_to_all", t) as c:
        send = c.out(t)
        recv = c.buffer(send)
        dist.all_to_all_single(recv, send, group=group)
        c.sent(_nbytes(t) * (d - 1) // d)
        return c.back(recv, t.device)


def all_to_all(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` (D, ...): block s goes to index s; returns (D, ...) whose block
    s is what index s sent here (``lax.all_to_all(split_axis=0,
    concat_axis=0, tiled=False)``). Differentiable: the exchange is its own
    inverse, so the backward is the same call on the gradient."""
    axes = tuple(axes)
    if _differentiable(t, mesh, axes):
        return _AllToAll.apply(t, mesh, axes)
    return _all_to_all(t, mesh, axes)


def _all_gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    d = axis_size(mesh, axes)
    if d == 1:
        return t
    if t.is_meta:
        return t.new_empty((d * t.shape[0], *t.shape[1:]))
    group, ranks, me = _slice(mesh, axes)
    t = t.contiguous()
    with _Call(mesh, "all_gather", t) as c:
        send = c.out(t)
        parts = [c.buffer(send) for _ in range(d)]
        dist.all_gather(parts, send, group=group)
        c.sent(_nbytes(t) * (d - 1))
        return c.back(torch.cat(parts), t.device)


_LOW = (torch.bfloat16, torch.float16)    # summed in f32 by the gloo reduce-scatter


def _reduce_scatter(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    d = axis_size(mesh, axes)
    if d == 1:
        return t
    if t.shape[0] % d:
        raise ValueError(f"reduce_scatter needs a leading dim divisible by {d}, "
                         f"got {tuple(t.shape)}")
    n = t.shape[0] // d
    if t.is_meta:
        return t.new_empty((n, *t.shape[1:]))
    group, ranks, me = _slice(mesh, axes)
    t = t.contiguous()
    with _Call(mesh, "reduce_scatter", t) as c:
        send = c.out(t)
        if mesh.backend == "nccl":
            recv = c.buffer(send, (n, *t.shape[1:]))
            dist.reduce_scatter_tensor(recv, send, group=group)
            c.sent(_nbytes(t) * (d - 1) // d)
            return c.back(recv, t.device)
        # gloo: every index's block me through an all_to_all, summed here in
        # index order (in f32 for a low-precision tensor)
        recv = c.buffer(send)
        dist.all_to_all_single(recv, send, group=group)
        c.sent(_nbytes(t) * (d - 1) // d)
        parts = c.back(recv, t.device).view(d, n, *t.shape[1:])
    acc = parts[0].to(torch.float32) if t.dtype in _LOW else parts[0].clone()
    for i in range(1, d):
        acc += parts[i]
    return acc.to(t.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_gather(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axes), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce_scatter(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_to_all(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.axes), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(t, mesh, axes, dist.ReduceOp.SUM, "psum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM, "psum"), None, None


def _differentiable(t: torch.Tensor, mesh, axes) -> bool:
    return t.requires_grad and torch.is_grad_enabled() and axis_size(mesh, axes) > 1


def _on_dim(fn, t: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` (a collective over dim 0) applied along ``dim``."""
    if dim % max(t.dim(), 1) == 0:
        return fn(t)
    return fn(t.movedim(dim, 0)).movedim(0, dim)


def all_gather(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Every index's ``t`` concatenated along ``dim``, in index order
    (``lax.all_gather(tiled=True)``); every rank's ``t`` has one shape.
    Differentiable: the backward reduce-scatters along ``dim``."""
    axes = tuple(axes)
    if _differentiable(t, mesh, axes):
        return _on_dim(lambda x: _AllGather.apply(x, mesh, axes), t, dim)
    return _on_dim(lambda x: _all_gather(x, mesh, axes), t, dim)


def reduce_scatter(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The sum over the indices of ``t``, split along ``dim`` into D equal
    blocks of which this index keeps its own (``lax.psum_scatter(tiled=True)``).
    Under NCCL one ``reduce_scatter_tensor``; under gloo an all_to_all and a
    sum in index order. Differentiable: the backward all-gathers."""
    axes = tuple(axes)
    if _differentiable(t, mesh, axes):
        return _on_dim(lambda x: _ReduceScatter.apply(x, mesh, axes), t, dim)
    return _on_dim(lambda x: _reduce_scatter(x, mesh, axes), t, dim)


def broadcast(t: torch.Tensor, mesh, axes, root: int = 0) -> torch.Tensor:
    """Index ``root``'s ``t`` on every rank (the others pass a tensor of the
    same shape and dtype to receive into)."""
    if axis_size(mesh, axes) == 1:
        return t
    if t.is_meta:
        return torch.empty_like(t)
    group, ranks, me = _slice(mesh, axes)
    t = t.contiguous()
    with _Call(mesh, "broadcast", t) as c:
        buf = c.out(t) if me == root else c.buffer(t)
        dist.broadcast(buf, ranks[root], group=group)
        c.sent(_nbytes(t) if me == root else 0)
        return c.back(buf, t.device)


def _all_reduce(t: torch.Tensor, mesh, axes, op, name: str) -> torch.Tensor:
    if axis_size(mesh, axes) == 1:
        return t
    if t.is_meta:
        return torch.empty_like(t)
    group, ranks, _ = _slice(mesh, axes)
    with _Call(mesh, name, t) as c:
        buf = c.out(t.contiguous())
        buf = buf.clone() if buf is t else buf
        dist.all_reduce(buf, op=op, group=group)
        c.sent(_nbytes(t))
        return c.back(buf, t.device)


def pmin(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise minimum over the indices (a new tensor)."""
    return _all_reduce(t, mesh, axes, dist.ReduceOp.MIN, "pmin")


def pmax(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise maximum over the indices (a new tensor)."""
    return _all_reduce(t, mesh, axes, dist.ReduceOp.MAX, "pmax")


def psum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise sum over the indices (a new tensor). Differentiable: the
    backward psums the gradient (each rank's result feeds its own part of
    the objective)."""
    axes = tuple(axes)
    if _differentiable(t, mesh, axes):
        return _PSum.apply(t, mesh, axes)
    return _all_reduce(t, mesh, axes, dist.ReduceOp.SUM, "psum")
