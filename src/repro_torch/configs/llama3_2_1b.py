"""Llama 3.2 1B — small dense GQA decoder [hf:meta-llama/Llama-3.2-1B].

16 layers, d_model 2048, 32 heads (kv 8, head_dim 64), d_ff 8192,
vocab 128256, RoPE theta 500000.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        arch_type="dense",
        num_layers=16,
        d_model=2048,
        vocab_size=128256,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        activation="swiglu",
        rope_theta=500000.0,
        tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="llama3.2-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, remat=False,
    )
