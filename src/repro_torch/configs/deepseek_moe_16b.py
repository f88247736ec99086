"""DeepSeekMoE 16B — fine-grained expert segmentation with shared experts
[arXiv:2401.06066]. 28 layers, d_model 2048, MHA 16 heads, 64 routed experts
top-6 + 2 shared experts (expert hidden 1408), vocab 102400.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        num_layers=28,
        d_model=2048,
        vocab_size=102400,
        num_heads=16,
        num_kv_heads=16,          # MHA
        head_dim=128,
        d_ff=2816,                # 2 shared experts x 1408, fused
        activation="swiglu",
        moe_experts=64,
        moe_top_k=6,
        moe_shared_experts=2,
        moe_d_ff=1408,
        moe_every=1,
        source="arXiv:2401.06066",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="deepseek-moe-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=64, d_ff=256, vocab_size=512,
        moe_experts=4, moe_top_k=2, moe_shared_experts=1, moe_d_ff=128,
        remat=False,
    )
