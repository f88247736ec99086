"""Fixed-point quantize / dequantize (port of ``repro/kernels/fixedpoint.py``).

The paper (§6) notes programmable switches have no FPUs, so in-network
allreduce payloads are converted to fixed point before hitting the fabric.
Integer accumulation is associative, so a dynamic tree gives bit-identical
sums whatever shape each block took.

On a CUDA tensor the wrappers launch the kernels of ``csrc/fixedpoint.cu``
(elementwise grid-stride, 16-byte loads, scale read from a device buffer);
on a CPU tensor they run the plain versions of :mod:`.ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import dequantize_ref, quantize_ref, scale_tensor

_QUANTIZE_FN = {torch.float32: "repro_quantize_f32",
                torch.bfloat16: "repro_quantize_bf16"}


def check_cuda_tensor(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be on the CPU or a CUDA device, "
                         f"not {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """``int32(round_half_even(float32(x) * scale))``, elementwise.

    ``x``: float32 or bfloat16, any shape; ``scale``: a float or a 1-element
    tensor. Returns int32 of ``x``'s shape.
    """
    if x.device.type == "cpu":
        return quantize_ref(x, scale)
    check_cuda_tensor(x, "x")
    if x.dtype not in _QUANTIZE_FN:
        raise TypeError(f"quantize takes float32 or bfloat16, got {x.dtype}")
    s = scale_tensor(scale, x.device)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        fn = getattr(_build.library(), _QUANTIZE_FN[x.dtype])
        _build.check(fn(x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel(),
                        torch.cuda.current_stream().cuda_stream), "quantize")
    quantize.launches += 1
    return out


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """``float32(q) / scale``, elementwise, as an IEEE division."""
    if q.device.type == "cpu":
        return dequantize_ref(q, scale)
    check_cuda_tensor(q, "q")
    if q.dtype != torch.int32:
        raise TypeError(f"dequantize takes int32, got {q.dtype}")
    s = scale_tensor(scale, q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _build.check(_build.library().repro_dequantize(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), q.numel(),
            torch.cuda.current_stream().cuda_stream), "dequantize")
    dequantize.launches += 1
    return out


quantize.launches = 0
dequantize.launches = 0
