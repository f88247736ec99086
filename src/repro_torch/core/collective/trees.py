"""Binomial reduction trees over a process group (port of
``repro/core/collective/trees.py``).

The reference builds them from ``lax.ppermute`` over a mesh axis; here the
axis is a ``torch.distributed`` ``ProcessGroup`` (NCCL on CUDA, gloo on the
CPU) and a rank's place on it is its rank in the group. Gloo's transport
sends and receives host memory only (handed a CUDA tensor, its TCP pair
fails with ``Bad address``), so gloo ranks whose tensors are on a card
(ranks sharing one card) stage each exchange through two pinned host
buffers, reused by every round; the sums and masks stay on the card. The
schedule is the
reference's: every round is one exchange in which each rank ``i`` sends its
accumulator to ``(i - stride) % n`` and receives from ``(i + stride) % n``
(reduce phase; the broadcast phase the other way round), issued as one
``batch_isend_irecv``. Which ranks aggregate or take the received value
depends only on ``rel = (rank - root) % n``, a host integer here, so the
masks cost no device work. A blockwise multi-root allreduce shares each
round's one exchange across all blocks, so the number of exchanges stays
2 * ceil(log2 n) whatever the number of blocks.

``ring_allreduce`` is reduce-scatter then all-gather; ``hierarchical`` does
the reduce-scatter and all-gather inside the inner group and an allreduce of
the scattered shards across the outer group.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup


def _rounds(n: int) -> int:
    return max(1, math.ceil(math.log2(n)))


def _staged(x: torch.Tensor, group: ProcessGroup) -> bool:
    """Whether an exchange of ``x`` over ``group`` goes through host
    buffers: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host_pair(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A send and a receive buffer on the host shaped like ``x`` (pinned
    where ``x`` is on the card)."""
    return tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
                 for _ in range(2))


def _shift(acc: torch.Tensor, group: ProcessGroup, n: int,
           offset: int, recv: Optional[torch.Tensor] = None,
           host: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> torch.Tensor:
    """Send ``acc`` to group rank ``(i + offset) % n`` and return what rank
    ``(i - offset) % n`` sent (into ``recv`` when given): ``lax.ppermute``
    with the pairs ``(i, (i + offset) % n)``. With ``host``
    (:func:`_host_pair`), ``acc`` is copied into its send buffer, the
    exchange runs on the two host buffers and what arrived is copied into
    ``recv``."""
    i = dist.get_rank(group)
    acc = acc.contiguous()
    recv = torch.empty_like(acc) if recv is None else recv
    send, into = (acc, recv) if host is None else host
    if host is not None:
        send.copy_(acc)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (i + offset) % n), group),
           dist.P2POp(dist.irecv, into,
                      dist.get_global_rank(group, (i - offset) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host is not None:
        recv.copy_(into)
    return recv


def tree_reduce_broadcast(x: torch.Tensor, group: ProcessGroup,
                          axis_size: int, root: int) -> torch.Tensor:
    """Allreduce ``x`` over ``group`` with a binomial tree rooted at group
    rank ``root``: ceil(log2 n) aggregation rounds toward the root, then the
    recorded tree is traversed in reverse to broadcast (paper §3.1.1-§3.1.2).
    """
    if axis_size == 1:
        return x
    rel = (dist.get_rank(group) - root) % axis_size
    acc = x
    host = _host_pair(x) if _staged(x, group) else None
    R = _rounds(axis_size)
    for j in range(R):                      # reduce: sums climb to rel = 0
        stride = 1 << j
        shifted = _shift(acc, group, axis_size, -stride, host=host)
        if rel % (stride * 2) == 0 and rel + stride < axis_size:
            acc = acc + shifted
    for j in reversed(range(R)):            # broadcast: retrace in reverse
        stride = 1 << j
        shifted = _shift(acc, group, axis_size, stride, host=host)
        if rel % (stride * 2) == stride and rel - stride >= 0:
            acc = shifted
    return acc


def _block_mask(flags, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(flags, dtype=torch.bool, device=like.device)[:, None]


def multi_root_tree_allreduce(x: torch.Tensor, group: ProcessGroup,
                              axis_size: int, roots: Sequence[int],
                              inplace: bool = False) -> torch.Tensor:
    """Blockwise multi-tree allreduce — the Canary schedule.

    ``x`` (any shape) is flattened and split into ``len(roots)`` blocks;
    block ``k`` is reduced along the tree rooted at ``roots[k]``. All blocks
    share each round's single exchange (it does not depend on the root; only
    the aggregation masks differ).

    The rounds accumulate in place, into one block buffer, through one
    receive buffer reused by every round: a round's ``where(mask, acc +
    shifted, acc)`` is the sum written into the receive buffer, then
    selected into the accumulator (the reference's expression, which XLA
    fuses into one buffer). The accumulator is ``x``'s own storage when
    ``inplace`` (the caller gives ``x`` up), else a copy.
    """
    return _multi_root(x, group, axis_size, roots, inplace,
                       staged=_staged(x, group))


def _multi_root(x: torch.Tensor, group: ProcessGroup, axis_size: int,
                roots: Sequence[int], inplace: bool = False,
                staged: bool = False) -> torch.Tensor:
    """:func:`multi_root_tree_allreduce`, each exchange through host
    buffers (:func:`_host_pair`, one pair for every round) when
    ``staged``."""
    if axis_size == 1:
        return x
    k = len(roots)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % k
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    elif not inplace or not flat.is_contiguous():
        flat = flat.clone()
    acc = flat.view(k, -1)
    idx = dist.get_rank(group)
    rel = [(idx - r) % axis_size for r in roots]
    recv = torch.empty_like(acc)
    host = _host_pair(acc) if staged else None
    R = _rounds(axis_size)
    for j in range(R):
        stride = 1 << j
        _shift(acc, group, axis_size, -stride, recv, host)
        receives = _block_mask([r % (stride * 2) == 0 and r + stride
                                < axis_size for r in rel], acc)
        torch.where(receives, recv.add_(acc), acc, out=acc)
    for j in reversed(range(R)):
        stride = 1 << j
        _shift(acc, group, axis_size, stride, recv, host)
        takes = _block_mask([r % (stride * 2) == stride and r - stride >= 0
                             for r in rel], acc)
        torch.where(takes, recv, acc, out=acc)
    out = acc.reshape(-1)
    if pad:
        out = out[:flat.shape[0] - pad]
    return out.reshape(x.shape)


def _rs_dtype(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Upcast bfloat16 around a reduction on gloo, the CPU backend, as the
    reference does on XLA:CPU (whose bf16 reduce-scatter crashes); NCCL
    reduces bfloat16 natively, as the TPU does."""
    if dist.get_backend(group) == "gloo" and x.dtype == torch.bfloat16:
        return x.to(torch.float32)
    return x


def psum(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in ``x``'s dtype (``lax.psum`` with
    the same bfloat16 upcast as :func:`_rs_dtype`)."""
    y = _rs_dtype(x, group)
    y = y.clone() if y is x else y
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


# reduce_scatter_tensor and all_gather_into_tensor exist in every torch this
# port runs on; newer releases deprecate them with a FutureWarning per call.
def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor,
                    group: ProcessGroup) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, inp, group=group)


def _all_gather(out: torch.Tensor, inp: torch.Tensor,
                group: ProcessGroup) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, inp, group=group)


def _scatter_reduce_gather(x: torch.Tensor, inner: ProcessGroup,
                           outer: Optional[ProcessGroup]) -> torch.Tensor:
    flat = _rs_dtype(x.reshape(-1), inner)
    n = dist.get_world_size(inner)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    scattered = torch.empty(flat.shape[0] // n, dtype=flat.dtype,
                            device=flat.device)
    _reduce_scatter(scattered, flat.contiguous(), inner)
    if outer is not None:
        scattered = psum(scattered, outer)
    gathered = torch.empty_like(flat)
    _all_gather(gathered, scattered, inner)
    if pad:
        gathered = gathered[:flat.shape[0] - pad]
    return gathered.reshape(x.shape).to(x.dtype)


def ring_allreduce(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Bandwidth-optimal reduce-scatter + all-gather (the paper's host-based
    ring reference), via the backend's native collectives."""
    return _scatter_reduce_gather(x, group, None)


def hierarchical_allreduce(x: torch.Tensor, inner: ProcessGroup,
                           outer: ProcessGroup) -> torch.Tensor:
    """Two-level reduction: reduce-scatter inside the pod, allreduce of the
    scattered shards across pods, all-gather inside the pod. The in-switch
    aggregation analogue: intra-pod traffic is aggregated *before* it crosses
    the (scarcer) cross-pod links, which see only 1/pod_size of the bytes."""
    return _scatter_reduce_gather(x, inner, outer)
