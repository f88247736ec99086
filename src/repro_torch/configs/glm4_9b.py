"""GLM-4 9B — dense decoder with extreme GQA (kv=2) and RoPE
[hf:THUDM/glm-4-9b]. 40 layers, d_model 4096, 32 heads, d_ff 13696,
vocab 151552.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        arch_type="dense",
        num_layers=40,
        d_model=4096,
        vocab_size=151552,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        activation="swiglu",
        rope_theta=10000.0,
        source="hf:THUDM/glm-4-9b",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="glm4-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, remat=False,
    )
