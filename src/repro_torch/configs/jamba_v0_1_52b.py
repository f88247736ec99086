"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887].

32 layers; one attention layer per 8 (the rest Mamba); MoE (16 experts,
top-2) on every other layer. GQA kv=8, d_ff 14336, vocab 65536.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        num_layers=32,
        d_model=4096,
        vocab_size=65536,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        activation="swiglu",
        rope_mode="none",          # Jamba uses no positional embeddings
        moe_experts=16,
        moe_top_k=2,
        moe_d_ff=14336,
        moe_every=2,
        moe_offset=1,
        attn_every=8,
        attn_offset=4,             # attention mid-period, as in the paper
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        source="arXiv:2403.19887",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="jamba-smoke", num_layers=4, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        moe_experts=4, moe_top_k=2, moe_d_ff=512, moe_every=2, moe_offset=1,
        attn_every=2, attn_offset=1, ssm_state=16, ssm_chunk=16,
        remat=False,
    )
