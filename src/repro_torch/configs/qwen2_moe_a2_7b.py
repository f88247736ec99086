"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B]. 24 layers, d_model 2048, MHA 16 heads,
expert hidden 1408, shared hidden 5632, vocab 151936.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        arch_type="moe",
        num_layers=24,
        d_model=2048,
        vocab_size=151936,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=5632,                # shared-expert hidden (4 shared, fused)
        activation="swiglu",
        qkv_bias=True,
        moe_experts=60,
        moe_top_k=4,
        moe_shared_experts=4,
        moe_d_ff=1408,
        moe_every=1,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="qwen2-moe-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=64, d_ff=256, vocab_size=512,
        moe_experts=4, moe_top_k=2, moe_shared_experts=1, moe_d_ff=128,
        remat=False,
    )
