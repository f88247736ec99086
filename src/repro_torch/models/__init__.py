"""Model zoo (port of ``repro/models``): the configs and registry (copies),
the layers, the MoE layer (:mod:`.moe`), the Mamba-2 layer (:mod:`.mamba2`)
and the decoder stack (:mod:`.transformer`).

Exports the reference's names. The encoder-decoder models raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""
from .config import ModelConfig
from .registry import get_config, list_archs
from .mamba2 import (Mamba2, mamba2_decode_step, mamba2_forward,
                     mamba2_init_cache, ssd_chunked)
from .moe import MoE, moe_forward
from .transformer import (Transformer, decode_step, forward, init_cache,
                          init_params, layer_period, prepare_cross_cache)

__all__ = ["Mamba2", "ModelConfig", "MoE", "Transformer", "decode_step",
           "forward", "get_config", "init_cache", "init_params",
           "layer_period", "list_archs", "mamba2_decode_step",
           "mamba2_forward", "mamba2_init_cache", "moe_forward",
           "prepare_cross_cache", "ssd_chunked"]
