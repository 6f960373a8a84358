"""The collectives of the sharded modules, on one mesh axis.

Counterparts of the ``jax.lax`` collectives that ``dvt_circuits_tpu/parallel``
calls inside ``shard_map``, with their semantics (``tiled=True`` where JAX
passes it), over an ``Axis``'s process group: NCCL on the card, Gloo on the
CPU.  Every rank of the axis calls each one in the same order.  An axis of
one rank without a group (a range of one in the table-parallel prover) makes
each an identity.  Only names that every recent ``torch.distributed`` has
are used: ``all_to_all_single``, the list ``all_gather``, ``all_reduce``,
``batch_isend_irecv`` and the object collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Axis


def all_to_all(x: torch.Tensor, ax: Axis, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all: ``split_axis`` is cut into ``ax.size`` equal
    chunks, chunk i goes to rank i of the axis, and the chunks received are
    concatenated along ``concat_axis`` in rank order."""
    d = ax.size
    if x.shape[split_axis] % d:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split over {d} ranks")
    if ax.group is None:
        return x
    shape = list(x.shape)
    shape[split_axis : split_axis + 1] = [d, shape[split_axis] // d]
    # NCCL takes equal, contiguous splits along the first axis
    send = x.reshape(shape).movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    out = recv.movedim(0, concat_axis)
    shape = list(out.shape)
    shape[concat_axis : concat_axis + 2] = [shape[concat_axis] * shape[concat_axis + 1]]
    return out.reshape(shape)


def all_gather(x: torch.Tensor, ax: Axis, axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in rank order: stacked on a new ``axis``, or with
    ``tiled`` concatenated along it."""
    if ax.group is None:
        return x if tiled else x.unsqueeze(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ppermute(x: torch.Tensor, ax: Axis, perm) -> torch.Tensor:
    """``perm``: (source, destination) pairs of axis indices.  Each rank
    sends ``x`` to its destination and returns what its source sent
    (zeros where none did)."""
    me = ax.index
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    x = x.contiguous()
    out = torch.zeros_like(x)
    if src == me:
        out.copy_(x)
    ops = []
    if dst is not None and dst != me:
        ops.append(dist.P2POp(dist.isend, x, ax.ranks[dst], ax.group))
    if src is not None and src != me:
        ops.append(dist.P2POp(dist.irecv, out, ax.ranks[src], ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of every rank's ``x`` (int64 sums are exact)."""
    if ax.group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ax.group)
    return out


def all_gather_object(obj, ax: Axis) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if ax.group is None:
        return [obj]
    out = [None] * ax.size
    dist.all_gather_object(out, obj, group=ax.group)
    return out


def broadcast_object(obj, ax: Axis, src: int):
    """Rank ``src`` (an axis index)'s picklable ``obj``, on every rank."""
    if ax.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=ax.ranks[src], group=ax.group)
    return box[0]
