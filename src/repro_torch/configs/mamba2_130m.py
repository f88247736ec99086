"""Mamba-2 130M — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060]. 24 layers, d_model 768, state 128, expand 2,
head_dim 64, vocab 50280. No FFN blocks (pure Mamba stack).
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        arch_type="ssm",
        num_layers=24,
        d_model=768,
        vocab_size=50280,
        d_ff=0,                  # mamba2 stacks have no MLP blocks
        rope_mode="none",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="mamba2-smoke", num_layers=2, d_model=256, vocab_size=512,
        ssm_state=32, ssm_chunk=16, remat=False,
    )
