"""Nemotron-4 340B — dense GQA decoder with squared-ReLU MLPs
[arXiv:2402.16819]. 96 layers, d_model 18432, 96 heads (kv 8), d_ff 73728,
vocab 256000.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        arch_type="dense",
        num_layers=96,
        d_model=18432,
        vocab_size=256000,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        activation="squared_relu",
        rope_theta=10000.0,
        source="arXiv:2402.16819",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="nemotron-smoke", num_layers=2, d_model=384, num_heads=6,
        num_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=512, remat=False,
    )
