"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version (:mod:`.ref`).

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel (built from ``csrc/`` at first use by
:mod:`._build`) or raises. Each wrapper counts its launches in a
``launches`` attribute.
"""
from .fixedpoint import dequantize, quantize
from .flash_attention import flash_attention
from .ops import fixed_point_allreduce_wrap, fixed_point_scale, on_cuda
from .packet_accum import accumulate_dtype, packet_accumulate

WRAPPERS = (quantize, dequantize, packet_accumulate, flash_attention)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches since the last reset}``."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["WRAPPERS", "accumulate_dtype", "dequantize",
           "fixed_point_allreduce_wrap", "fixed_point_scale",
           "flash_attention", "launch_counts", "on_cuda", "packet_accumulate",
           "quantize", "reset_launch_counts"]
