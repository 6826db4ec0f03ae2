"""Autograd-aware collectives, built from ``all_reduce`` alone.

The mesh's collectives (``parallel/mesh.py``) as ``torch.autograd.Function``s
over an ``AxisGroup``. Every one is a sum all-reduce, so the same code runs
over NCCL and over gloo, which takes only ``broadcast`` and ``all_reduce``
on CUDA tensors: a gather places this rank's part in zeros and sums. The
sums run in fp32 (a bf16 part is widened and narrowed back exactly).

Which backward a collective takes depends on how the ranks use its output:

- ``all_reduce``: the ranks use the sum for different rows (BatchNorm and
  GroupNorm statistics, halos): the backward sums the ranks' gradients.
- ``copy_to``/``reduce_from``, the Megatron pair: the computation after
  them is replicated on every rank of the group (the loss is the same on
  every "model" rank). ``copy_to`` is the identity forward and sums the
  gradient; ``reduce_from`` sums forward and passes the gradient through.
- ``all_gather``: a gather whose ranks use different parts of the result
  sums the gradient and keeps this rank's part; with ``replicated`` (the
  logits before the replicated CTC loss) it keeps this rank's part alone.

``broadcast_`` (no autograd) hands every rank of a group its first
rank's tensors: the rows a data line trains on.

A group of one rank, or None, makes every collective the identity.
``traffic`` counts the all-reduce and broadcast calls this process makes
and the bytes they carry.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F


class Traffic:
    """Collective calls and the bytes they carry, since ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls, self.bytes = 0, 0

    def snapshot(self):
        return {"calls": self.calls, "bytes": self.bytes}


traffic = Traffic()


def _trivial(group):
    return group is None or group.group is None


def _all_reduce(buf, group, op=dist.ReduceOp.SUM):
    traffic.calls += 1
    traffic.bytes += buf.numel() * buf.element_size()
    dist.all_reduce(buf, op=op, group=group.group)


def _broadcast(buf, group):
    traffic.calls += 1
    traffic.bytes += buf.numel() * buf.element_size()
    dist.broadcast(buf, src=group.ranks[0], group=group.group)


def broadcast_(tensors, group):
    """Every rank of ``group`` gets its first rank's ``tensors`` (the same
    number, dtypes and ranks of dimensions on every rank; the shapes may
    differ): a list of tensors, this rank's own on the first rank. No
    autograd."""
    if _trivial(group) or not tensors:
        return tensors
    with torch.no_grad():
        shapes = torch.tensor([n for t in tensors for n in t.shape], dtype=torch.int64,
                              device=tensors[0].device)
        _broadcast(shapes, group)
        shapes = shapes.tolist()
        out = []
        for t in tensors:
            shape, shapes = shapes[:t.dim()], shapes[t.dim():]
            buf = t.contiguous() if group.index == 0 else t.new_empty(shape)
            _broadcast(buf, group)
            out.append(buf)
    return out


def _sum(x, group):
    """A new tensor: the sum of ``x`` over ``group``, in ``x``'s dtype."""
    buf = x.detach().to(torch.float32 if x.is_floating_point() else x.dtype,
                        memory_format=torch.contiguous_format, copy=True)
    _all_reduce(buf, group)
    return buf.to(x.dtype)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x, group):
    """Sum over ``group``; the backward sums the gradients."""
    return x if _trivial(group) else _AllReduce.apply(x, group)


def copy_to(x, group):
    """Identity forward; the backward sums the gradients over ``group``."""
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Sum over ``group``; the backward passes the gradient through."""
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def all_gather(x, dim, group, sizes=None, replicated=False):
    """The concatenation along ``dim`` of every rank's ``x``, in rank order;
    ``sizes`` lists each rank's length along ``dim`` (equal by default).
    The backward keeps this rank's part of the summed gradient, or with
    ``replicated`` of its own gradient."""
    if _trivial(group):
        return x
    sizes = list(sizes) if sizes is not None else [x.shape[dim]] * group.size
    if sizes[group.index] != x.shape[dim]:
        raise ValueError(f"rank {group.index} holds {x.shape[dim]} along dim {dim}, "
                         f"sizes say {sizes[group.index]}")
    before, after = sum(sizes[:group.index]), sum(sizes[group.index + 1:])
    dim = dim % x.dim()
    pad = [0, 0] * (x.dim() - 1 - dim) + [before, after]
    placed = F.pad(x, pad)
    return reduce_from(placed, group) if replicated else all_reduce(placed, group)


def halo(x, pad, group, sizes):
    """(B, T_local, C) -> (B, pad + T_local + pad, C): ``x`` with the
    ``pad`` frames before it and after it in the sequence split over
    ``group`` (``sizes``: each rank's frames), zeros past the sequence's
    ends. Each rank contributes its first and last min(pad, T_local)
    frames; a neighbour holding fewer than ``pad`` frames is passed over to
    the next. Differentiable: the frames' gradients return to their ranks."""
    if _trivial(group):
        return F.pad(x, (0, 0, pad, pad))
    B, n, C = x.shape
    e = min(pad, n)
    edges = torch.stack([F.pad(x[:, :e], (0, 0, 0, pad - e)),       # head, left-aligned
                         F.pad(x[:, n - e:], (0, 0, pad - e, 0))])  # tail, right-aligned
    slots = [torch.zeros_like(edges)] * group.size
    slots[group.index] = edges
    edges = all_reduce(torch.stack(slots), group)  # (ranks, 2, B, pad, C)
    r = group.index
    left = [edges[i, 1, :, pad - min(pad, sizes[i]):] for i in range(r)]
    right = [edges[i, 0, :, :min(pad, sizes[i])] for i in range(r + 1, group.size)]
    left = torch.cat([x.new_zeros(B, pad, C)] + left, 1)[:, -pad:]
    right = torch.cat(right + [x.new_zeros(B, pad, C)], 1)[:, :pad]
    return torch.cat([left, x, right], 1)


def all_reduce_(tensors, group, op="sum", bucket_elements=1 << 22):
    """In place, no autograd: each tensor of ``tensors`` summed (or with
    ``op="max"`` maximized) over ``group``, packed into flat fp32 buckets
    of at most ``bucket_elements``. Returns ``tensors``."""
    if _trivial(group) or not tensors:
        return tensors
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    bucket, count = [], 0
    with torch.no_grad():
        for i, t in enumerate(tensors):
            bucket.append(t)
            count += t.numel()
            if count >= bucket_elements or i == len(tensors) - 1:
                flat = torch.cat([b.reshape(-1).float() for b in bucket])
                _all_reduce(flat, group, reduce_op)
                for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, count = [], 0
    return tensors
