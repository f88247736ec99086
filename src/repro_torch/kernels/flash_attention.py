"""Causal / full GQA flash attention and its gradient (port of
``repro/kernels/flash_attention.py``).

The compute hot spot of every attention architecture: the port's
``chunked_attention`` (a sequence of at least ``attn_chunk_threshold``
tokens, in a prefill or a training step) goes through it. On a CUDA tensor
the wrapper launches the kernel of ``csrc/flash_attention.cu`` (bf16 on the
tensor cores through ``wgmma``, fed by TMA; f32 on FP32 FMA); on a CPU
tensor it runs :func:`.ref.flash_attention_ref`.

The kernel picks its own tiles (bf16: 192 q rows at head_dim 64, else 128,
by 128 keys, 64 at head_dim 192; f32: 64 by 64), takes any sequence length
and reads q, k, v through their strides (TMA tensor maps for bf16), so a
``(B, S, H, D)`` activation transposed to ``(B, H, S, D)`` is not copied.

Where q, k or v needs a gradient, the call goes through
:class:`FlashAttentionFunction`: its forward also stores each row's float32
log-sum-exp, and its backward is :func:`flash_attention_bwd`, the three
kernels of ``csrc/flash_attention_bwd.cu`` on CUDA (the Pallas kernel has no
backward; the reference differentiates its jnp ``chunked_attention``), or
:func:`.ref.flash_attention_bwd_ref` on the CPU.

The forward and the backward are operators of the ``repro_torch`` library,
``repro_torch::flash_attention_fwd`` and ``repro_torch::flash_attention_bwd``
(plain ``torch.library.Library`` operators with a CPU and a CUDA kernel and
no Python autograd layer: the gradient is :class:`FlashAttentionFunction`'s),
so that a trace over fake tensors (the dry run, :mod:`repro_torch.launch.
dryrun`) can pass through them without a kernel: each has a fake that
returns empty tensors of the real route's shapes, dtypes and layout and
touches no data; a FLOP formula for ``torch.utils.flop_counter`` (4 D
operations a live (query, key) pair forward, the backward's five products
10 D); and DTensor sharding strategies (batch sharded; heads sharded where
q's and k's head counts both divide every group of mesh dims they may be
split over; else replicated). Every real call launches the same kernels as
a direct call, and only real launches are counted.
"""
from __future__ import annotations

import ctypes
import math
from itertools import combinations
from typing import Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

_FLASH_FN = {torch.bfloat16: "repro_flash_attention_bf16",
             torch.float32: "repro_flash_attention_f32"}
_FLASH_BWD_FN = {torch.bfloat16: "repro_flash_attention_bwd_bf16",
                 torch.float32: "repro_flash_attention_bwd_f32"}
HEAD_DIMS = (64, 128, 192)     # the head sizes the kernel is built for


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, S, D) and k, v (B, KV, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[2:] != (S, D) or k.shape[1] == 0 \
            or H % k.shape[1]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")


def _strides_fit(t: torch.Tensor) -> bool:
    """The strides of a TMA tensor map: a unit head_dim stride, and every
    other stride of an extent above 1 a positive multiple of 16 bytes (so
    no broadcast)."""
    size = t.element_size()
    return t.stride(-1) == 1 and all(
        s > 0 and s * size % 16 == 0
        for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it through its strides (and
    its base is on 16 bytes), else a contiguous copy."""
    ok = _strides_fit(t) and t.data_ptr() % 16 == 0
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _fake_kernel_view(t: torch.Tensor) -> torch.Tensor:
    """:func:`_kernel_view`'s layout without reading an address: a fake
    tensor has none, and the caching allocator aligns every block."""
    return t if _strides_fit(t) else t.contiguous()


def _check_cuda(q: torch.Tensor, *others: torch.Tensor) -> None:
    """Every tensor on q's CUDA device, in q's dtype, which the kernels
    take; a head_dim they are built for; a shape inside their grid."""
    if q.device.type != "cuda":
        raise ValueError(f"q must be on the CPU or a CUDA device, not "
                         f"{q.device}")
    for t in others:
        if t.device != q.device:
            raise ValueError(f"q on {q.device}, another input on {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash attention takes tensors of one dtype, "
                            f"got {q.dtype} and {t.dtype}")
    if q.dtype not in _FLASH_FN:
        raise TypeError(f"flash attention takes float32 or bfloat16 on "
                        f"CUDA, got {q.dtype}")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if S >= 2 ** 31 or H >= 65536 or B >= 65536:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernels' grid")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: int, with_lse: bool):
    """``(out, lse)``: the forward kernel's output in q's layout and, with
    ``with_lse``, the float32 ``(B, H, S)`` log-sum-exp of every row (else
    ``None``, and the kernel stores none)."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        return flash_attention_ref(q, k, v, causal=causal,
                                   window=window), None
    _check_cuda(q, k, v)
    B, H, S, D = q.shape
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        fn = getattr(_build.library(), _FLASH_FN[q.dtype])
        lse_ptr = None if lse is None else lse.data_ptr()   # null: no store
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse_ptr, strides, B, H, k.shape[1],
                        S, D, int(causal), int(window), 1.0 / math.sqrt(D),
                        torch.cuda.current_stream().cuda_stream),
                     "flash_attention")
    flash_attention.launches += 1
    return out, lse


def _check_bwd(q, k, v, out, lse, dout) -> None:
    _check_shapes(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != q.shape[:3]:
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} "
                         f"and lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")


def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              causal: bool, window: int):
    _check_bwd(q, k, v, out, lse, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                       window=window)
    _check_cuda(q, k, v, out, dout)
    if lse.device != q.device or lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32 on {q.device}, got "
                        f"{lse.dtype} on {lse.device}")
    B, H, S, D = q.shape
    q, k, v, out, dout = (_kernel_view(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, out, dout, dq, dk, dv)
    strides = (ctypes.c_int64 * 24)(*(s for t in tensors
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        fn = getattr(_build.library(), _FLASH_BWD_FN[q.dtype])
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), strides, B, H, k.shape[1], S, D,
                        int(causal), int(window), 1.0 / math.sqrt(D),
                        torch.cuda.current_stream().cuda_stream),
                     "flash_attention_bwd")
    flash_attention_bwd.launches += 3
    return dq, dk, dv


# ------------------------------------------------------------ custom ops
def _no_lse(q: torch.Tensor) -> torch.Tensor:
    """The forward's second output when it stores no log-sum-exp."""
    return q.new_empty((0,), dtype=torch.float32)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
# ``window`` is the first scalar: DTensor keys its sharding cache on the
# arguments from the first int on
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, int window, "
            "bool causal, bool with_lse) -> (Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
            "Tensor lse, Tensor dout, int window, bool causal) "
            "-> (Tensor, Tensor, Tensor)")


def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, causal: bool, with_lse: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of :func:`_forward`; ``lse`` is empty without
    ``with_lse``."""
    out, lse = _forward(q, k, v, causal, window, with_lse)
    return out, (_no_lse(q) if lse is None else lse)


@torch.library.register_fake("repro_torch::flash_attention_fwd")
def _(q, k, v, window, causal, with_lse):
    _check_shapes(q, k, v)
    B, H, S, _ = q.shape
    if q.device.type == "cuda":
        _check_cuda(q, k, v)
        out = torch.empty_like(_fake_kernel_view(q))
    else:                                 # the plain version's contiguous out
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else _no_lse(q))
    return out, lse


def _bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                window: int, causal: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`_backward`."""
    return _backward(q, k, v, out, lse, dout, causal, window)


@torch.library.register_fake("repro_torch::flash_attention_bwd")
def _(q, k, v, out, lse, dout, window, causal):
    _check_bwd(q, k, v, out, lse, dout)
    if q.device.type == "cuda":
        _check_cuda(q, k, v, out, dout)
        return tuple(torch.empty_like(_fake_kernel_view(t)) for t in (q, k, v))
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v))


for _key in ("CPU", "CUDA"):
    _LIB.impl("flash_attention_fwd", _fwd_kernel, _key)
    _LIB.impl("flash_attention_bwd", _bwd_kernel, _key)
flash_attention_fwd_op = torch.ops.repro_torch.flash_attention_fwd.default
flash_attention_bwd_op = torch.ops.repro_torch.flash_attention_bwd.default


def live_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that the mask keeps: key ``j`` for
    query ``i`` where ``j <= i`` if ``causal`` and ``j > i - window`` if
    ``window > 0`` (each query keeps itself)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    if causal:          # min(i + 1, window) keys each
        return window * (window + 1) // 2 + (S - window) * window
    return S * S - (S - window) * (S - window + 1) // 2


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, window, causal, with_lse, *args,
               **kwargs) -> int:
    """q k^T and p v: 4 D operations a live pair."""
    B, H, S, D = q_shape
    return 4 * B * H * D * live_pairs(S, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, *args, **kwargs) -> int:
    """s = q k^T again, dp = do v^T, dv = p^T do, dq = ds k and
    dk = ds^T q: five products, 10 D operations a live pair."""
    window, causal = args[5], args[6]
    B, H, S, D = q_shape
    return 10 * B * H * D * live_pairs(S, causal, window)


def _heads_split(mesh, H: int, KV: int) -> bool:
    """Whether q's ``H`` and k's ``KV`` heads may be sharded over any group
    of ``mesh``'s dims whose size is at most ``KV`` (DTensor drops a split
    into more shards than heads): each group's size must divide both, so
    every rank's q and k keep ``H % KV == 0``."""
    sizes = mesh.shape
    for r in range(1, len(sizes) + 1):
        for dims in combinations(sizes, r):
            n = math.prod(dims)
            if n <= KV and (H % n or KV % n):
                return False
    return True


def _shard_dims(q, k) -> list:
    """The dims of (B, H, S, D) the ops may be sharded on: the batch, and
    the heads where :func:`_heads_split` allows."""
    return [0, 1] if _heads_split(q.mesh, q.shape[1], k.shape[1]) else [0]


@register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
def _fwd_sharding(q, k, v, window, causal, with_lse):
    rules = [([Replicate(), Replicate()], [Replicate()] * 3 + [None] * 3)]
    for d in _shard_dims(q, k):
        lse = Shard(d) if with_lse else Replicate()    # an empty lse: every
        rules.append(([Shard(d), lse], [Shard(d)] * 3 + [None] * 3))
    return rules                                       # rank holds the same


@register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
def _bwd_sharding(q, k, v, out, lse, dout, window, causal):
    rules = [([Replicate()] * 3, [Replicate()] * 6 + [None] * 2)]
    for d in _shard_dims(q, k):
        rules.append(([Shard(d)] * 3, [Shard(d)] * 6 + [None] * 2))
    return rules


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """``(dq, dk, dv)`` of :func:`flash_attention` from its output ``out``,
    its float32 ``(B, H, S)`` log-sum-exp ``lse`` and the output's gradient
    ``dout``, each in the layout of q, k and v.

    On CUDA: three launches of ``csrc/flash_attention_bwd.cu`` (the row
    sums delta, then dk and dv, then dq), each counted in
    ``flash_attention_bwd.launches``; on the CPU,
    :func:`.ref.flash_attention_bwd_ref`. Through the operator
    ``repro_torch::flash_attention_bwd``.
    """
    return flash_attention_bwd_op(q, k, v, out, lse, dout, window, causal)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient: the forward saves q, k, v, the
    output and the log-sum-exp; the backward is :func:`flash_attention_bwd`.
    Under ``torch.utils.checkpoint`` the forward runs again in the backward
    pass to rebuild what it saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_fwd_op(q, k, v, window, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: ``(B, H, S, D)``; k, v: ``(B, KV, S, D)``, ``H % KV == 0`` ->
    ``(B, H, S, D)`` in q's dtype.

    ``window > 0`` also masks keys at or before ``qpos - window``. On CUDA
    the output has q's memory layout (``empty_like``), so the transpose of a
    ``(B, S, H, D)`` activation comes back as one. Where an input needs a
    gradient (and gradients are on), the call records
    :class:`FlashAttentionFunction` for the backward pass.
    """
    _check_shapes(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q must be on the CPU or a CUDA device, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return flash_attention_fwd_op(q, k, v, window, causal, False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
