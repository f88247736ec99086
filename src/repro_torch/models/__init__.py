"""Model zoo (port of ``repro/models``): the configs and registry (copies),
the layers and the dense decoder (:mod:`.transformer`).

Exports the reference's names. MoE, SSM and encoder-decoder models raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""
from .config import ModelConfig
from .registry import get_config, list_archs
from .transformer import (Transformer, decode_step, forward, init_cache,
                          init_params, layer_period, prepare_cross_cache)

__all__ = ["ModelConfig", "Transformer", "decode_step", "forward",
           "get_config", "init_cache", "init_params", "layer_period",
           "list_archs", "prepare_cross_cache"]
