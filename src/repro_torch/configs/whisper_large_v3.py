"""Whisper large-v3 — encoder-decoder ASR backbone [arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model 1280, 20 heads (MHA), d_ff 5120,
vocab 51866. The mel-spectrogram + conv frontend is a STUB per the
assignment: ``input_specs`` provides 1500 precomputed frame embeddings
(B, 1500, d_model) consumed by the encoder. long_500k is skipped for this
arch (enc-dec full attention; see DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        arch_type="audio",
        num_layers=32,             # decoder layers
        encoder_layers=32,
        encoder_seq=1500,
        d_model=1280,
        vocab_size=51866,
        num_heads=20,
        num_kv_heads=20,           # MHA
        head_dim=64,
        d_ff=5120,
        activation="gelu",
        rope_mode="standard",      # adaptation: RoPE replaces learned abs-pos
        frontend="audio_stub",
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="whisper-smoke", num_layers=2, encoder_layers=2, encoder_seq=32,
        d_model=256, num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512,
        vocab_size=512, remat=False,
    )
