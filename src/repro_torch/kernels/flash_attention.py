"""Causal / full GQA flash attention (port of
``repro/kernels/flash_attention.py``).

The compute hot spot of every attention architecture: the port's
``chunked_attention`` (a prefill of at least ``attn_chunk_threshold``
tokens) goes through it. On a CUDA tensor the wrapper launches the kernel of
``csrc/flash_attention.cu`` (bf16 on the tensor cores through ``wgmma``,
fed by TMA; f32 on FP32 FMA); on a CPU tensor it runs
:func:`.ref.flash_attention_ref`.

The kernel picks its own tiles (bf16: 192 q rows at head_dim 64, else 128,
by 128 keys, 64 at head_dim 192; f32: 64 by 64), takes any sequence length
and reads q, k, v through their strides (TMA tensor maps for bf16), so a
``(B, S, H, D)`` activation transposed to ``(B, H, S, D)`` is not copied.
It has no backward: inputs that require a gradient are refused on CUDA.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref

_FLASH_FN = {torch.bfloat16: "repro_flash_attention_bf16",
             torch.float32: "repro_flash_attention_f32"}
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


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it through its strides, else a
    contiguous copy. The strides are those of a TMA tensor map: a unit
    head_dim stride, the base on 16 bytes, and every other stride of an
    extent above 1 a positive multiple of 16 bytes (so no broadcast)."""
    size = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s > 0 and s * size % 16 == 0
                  for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: ``(B, H, S, D)``; k, v: ``(B, KV, S, D)``, ``H % KV == 0`` ->
    ``(B, H, S, D)`` in q's dtype.

    ``window > 0`` also masks keys at or before ``qpos - window``. On CUDA
    the output has q's memory layout (``empty_like``), so the transpose of a
    ``(B, S, H, D)`` activation comes back as one.
    """
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"q must be on the CPU or a CUDA device, not "
                         f"{q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in _FLASH_FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype on CUDA, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError("flash_attention has no backward kernel "
                                  "(the reference's has none either); the "
                                  "train slice decides the gradient path")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if S >= 2 ** 31 or H >= 65536 or B >= 65536:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        fn = getattr(_build.library(), _FLASH_FN[q.dtype])
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), strides, B, H, k.shape[1], S, D,
                        int(causal), int(window), 1.0 / math.sqrt(D),
                        torch.cuda.current_stream().cuda_stream),
                     "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
