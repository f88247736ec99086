"""Qwen2-VL 2B — VLM language decoder with M-RoPE [arXiv:2409.12191].

28 layers, d_model 1536, 12 heads (kv 2), d_ff 8960, vocab 151936. The
vision encoder is a STUB per the assignment: ``input_specs`` provides
precomputed patch embeddings (B, num_patches, d_model) that are prepended to
the token embeddings; M-RoPE handles the 3-D (t, h, w) positions.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        num_layers=28,
        d_model=1536,
        vocab_size=151936,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        activation="swiglu",
        qkv_bias=True,
        rope_mode="mrope",
        mrope_sections=(16, 24, 24),
        frontend="vision_stub",
        num_patches=256,
        source="arXiv:2409.12191",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="qwen2-vl-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        mrope_sections=(8, 12, 12), num_patches=8, remat=False,
    )
