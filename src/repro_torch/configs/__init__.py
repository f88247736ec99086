"""Architecture configs (one module per assigned architecture).

Each module exposes ``full()`` — the exact published configuration — and
``smoke()`` — a reduced same-family variant (<=2 layers, d_model<=512,
<=4 experts) for CPU tests. ``repro_torch.models.registry`` indexes them.
"""
from . import (deepseek_moe_16b, glm4_9b, jamba_v0_1_52b, llama3_2_1b,
               mamba2_130m, nemotron_4_340b, qwen2_7b, qwen2_moe_a2_7b,
               qwen2_vl_2b, whisper_large_v3)

ARCH_MODULES = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "nemotron-4-340b": nemotron_4_340b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "glm4-9b": glm4_9b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "mamba2-130m": mamba2_130m,
    "whisper-large-v3": whisper_large_v3,
    "llama3.2-1b": llama3_2_1b,
    "qwen2-7b": qwen2_7b,
}

ARCH_NAMES = list(ARCH_MODULES)
