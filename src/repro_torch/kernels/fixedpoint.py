"""Fixed-point quantize / dequantize (port of ``repro/kernels/fixedpoint.py``).

The paper (§6) notes programmable switches have no FPUs, so in-network
allreduce payloads are converted to fixed point before hitting the fabric.
Integer accumulation is associative, so a dynamic tree gives bit-identical
sums whatever shape each block took.

On a CUDA tensor the wrappers launch the kernels of ``csrc/fixedpoint.cu``
(elementwise grid-stride, 16-byte loads, scale read from a device buffer);
on a CPU tensor they run the plain versions of :mod:`.ref`. Each goes
through an operator of the ``repro_torch`` library (``repro_torch::quantize``,
``repro_torch::dequantize``: a CPU and a CUDA kernel, and a fake), so that a
trace over fake tensors (the dry run's ``canary_fp`` step) passes through
without a kernel. They are plain ``torch.library.Library`` operators, with
no Python autograd layer: a call costs one dispatch into Python.
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
    return quantize_op(x, scale_tensor(scale, x.device))


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """``float32(q) / scale``, elementwise, as an IEEE division."""
    return dequantize_op(q, scale_tensor(scale, q.device))


def _check_quantize(x: torch.Tensor) -> None:
    check_cuda_tensor(x, "x")
    if x.dtype not in _QUANTIZE_FN:
        raise TypeError(f"quantize takes float32 or bfloat16, got {x.dtype}")


def _check_dequantize(q: torch.Tensor) -> None:
    check_cuda_tensor(q, "q")
    if q.dtype != torch.int32:
        raise TypeError(f"dequantize takes int32, got {q.dtype}")


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("quantize(Tensor x, Tensor s) -> Tensor")
_LIB.define("dequantize(Tensor q, Tensor s) -> Tensor")


def _quantize_cuda(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """:func:`quantize` on CUDA, with the scale as a float32 tensor on x's
    device."""
    _check_quantize(x)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        fn = getattr(_build.library(), _QUANTIZE_FN[x.dtype])
        _build.check(fn(x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel(),
                        torch.cuda.current_stream().cuda_stream), "quantize")
    quantize.launches += 1
    return out


@torch.library.register_fake("repro_torch::quantize")
def _(x, s):
    if x.device.type != "cpu":
        _check_quantize(x)
    return torch.empty(x.shape, dtype=torch.int32, device=x.device)


def _dequantize_cuda(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """:func:`dequantize` on CUDA, with the scale as a float32 tensor on q's
    device."""
    _check_dequantize(q)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _build.check(_build.library().repro_dequantize(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), q.numel(),
            torch.cuda.current_stream().cuda_stream), "dequantize")
    dequantize.launches += 1
    return out


@torch.library.register_fake("repro_torch::dequantize")
def _(q, s):
    if q.device.type != "cpu":
        _check_dequantize(q)
    return torch.empty(q.shape, dtype=torch.float32, device=q.device)


_LIB.impl("quantize", quantize_ref, "CPU")
_LIB.impl("quantize", _quantize_cuda, "CUDA")
_LIB.impl("dequantize", dequantize_ref, "CPU")
_LIB.impl("dequantize", _dequantize_cuda, "CUDA")
quantize_op = torch.ops.repro_torch.quantize.default
dequantize_op = torch.ops.repro_torch.dequantize.default

quantize.launches = 0
dequantize.launches = 0
