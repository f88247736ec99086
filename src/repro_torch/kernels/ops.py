"""Device selection, the shared fixed-point scale, and the quantize ->
reduce -> dequantize wrapper (port of ``repro/kernels/ops.py``)."""
from __future__ import annotations

from typing import Callable

import torch

from .fixedpoint import dequantize, quantize


def on_cuda() -> bool:
    """True when a CUDA card is present: the entry points' default device."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Asking for CUDA where there is none raises;
    nothing falls back to the CPU unless the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(f"device {str(dev)!r} asked for, but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def fixed_point_scale(gmax, *, bits: int, world: int) -> torch.Tensor:
    """Shared quantization scale: ``(2**bits - 1) / (gmax * world + 1e-30)``
    in float32, as a 0-d tensor on ``gmax``'s device.

    ``gmax`` is the global max |x| across participants; ``world`` summands
    of at most ``gmax * scale`` each cannot overflow int32. The division is
    an explicit float32 tensor division: ``python_float / tensor`` is a
    reciprocal product in PyTorch and differs from ``jnp`` in the last bit
    for some inputs, and the int32 results are bit-identical only if the
    scale is.
    """
    gmax = torch.as_tensor(gmax, dtype=torch.float32)
    num = torch.full((), 2.0 ** bits - 1.0, dtype=torch.float32,
                     device=gmax.device)      # filled there: no host copy
    return torch.div(num, gmax * world + 1e-30)


def fixed_point_allreduce_wrap(x: torch.Tensor,
                               reduce_fn: Callable[[torch.Tensor],
                                                   torch.Tensor],
                               gmax, bits: int, world: int) -> torch.Tensor:
    """Quantize -> integer reduce -> dequantize (paper §6 switch arithmetic).

    Integer addition is associative, so the result is bit-identical for any
    dynamic tree shape.
    """
    scale = fixed_point_scale(torch.as_tensor(gmax, device=x.device),
                              bits=bits, world=world)
    q = quantize(x, scale)
    return dequantize(reduce_fn(q), scale).to(x.dtype)
