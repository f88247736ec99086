"""Qwen2 7B — dense GQA decoder with QKV bias [arXiv:2407.10671].

28 layers, d_model 3584, 28 heads (kv 4), d_ff 18944, vocab 152064.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        arch_type="dense",
        num_layers=28,
        d_model=3584,
        vocab_size=152064,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        activation="swiglu",
        qkv_bias=True,
        rope_theta=1000000.0,
        source="arXiv:2407.10671",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="qwen2-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        qkv_bias=True, remat=False,
    )
