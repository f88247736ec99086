"""Model configuration.

One frozen dataclass drives every architecture in the zoo (dense / MoE / SSM /
hybrid / VLM / audio). Each assigned architecture has a module in
``repro_torch.configs`` that instantiates this with the exact published sizes and a
``smoke()`` reduced variant for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int

    # ---- attention -----------------------------------------------------------
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_mode: str = "standard"    # standard | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # pairs per t/h/w
    sliding_window: int = 0        # 0 = full attention; >0 = window size
    attn_chunk: int = 1024         # online-softmax block size for long seqs
    attn_chunk_threshold: int = 4096  # use chunked attention when S >= this

    # ---- feed-forward ----------------------------------------------------------
    d_ff: int = 0                  # dense MLP / shared-expert hidden size
    activation: str = "swiglu"     # swiglu | squared_relu | gelu

    # ---- MoE -------------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0              # routed-expert hidden size
    moe_every: int = 1             # MoE on layers with i % moe_every == moe_offset
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_impl: str = "auto"         # auto | dense | ep  (ep = shard_map expert parallel)

    # ---- SSM (Mamba-2 / SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    attn_every: int = 0            # hybrid: attention on i % attn_every == attn_offset
    attn_offset: int = 0

    # ---- encoder-decoder / multimodal stubs --------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0           # whisper: 1500 post-conv frames
    frontend: str = "none"         # none | audio_stub | vision_stub
    num_patches: int = 0           # VLM: stub patch-embedding prefix length

    # ---- numerics / compilation ---------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: bool = True
    scan_layers: bool = True

    # ---- provenance ---------------------------------------------------------------
    source: str = ""               # paper / model-card citation

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        """Mixer kind of decoder layer ``i``: 'attn' or 'ssm'."""
        if self.arch_type == "ssm":
            return "ssm"
        if self.arch_type == "hybrid" and self.attn_every > 0:
            return "attn" if i % self.attn_every == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.moe_experts <= 0:
            return False
        return i % self.moe_every == self.moe_offset

    def supports_decode(self) -> bool:
        return True  # every zoo member is (or contains) a decoder

    def supports_long_decode(self) -> bool:
        """long_500k eligibility (see DESIGN.md §5)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        if self.is_encoder_decoder:
            return False  # whisper: out of design envelope — skip, documented
        return True       # dense/vlm archs run it via the sliding-window variant

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def long_context_variant(self, window: int = 8192) -> "ModelConfig":
        """Sliding-window variant used for long_500k on full-attention archs."""
        if self.arch_type in ("ssm", "hybrid") or self.sliding_window:
            return self
        return self.with_(sliding_window=window,
                          name=f"{self.name}-sw{window}")

    # parameter-count estimate (embedding + per-layer), used for 6ND roofline
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        enc_layers = self.encoder_layers
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                qkv = d * (self.num_heads + 2 * self.num_kv_heads) * hd
                total += qkv + self.num_heads * hd * d
            else:
                di, n = self.ssm_d_inner, self.ssm_state
                total += d * (2 * di + 2 * n * (di // self.ssm_head_dim) * 0 + 2 * di) \
                    + 2 * di * n + di * d  # in/out proj + B/C/dt params (approx)
            if self.layer_is_moe(i):
                total += self.moe_experts * 3 * d * self.moe_d_ff
                total += self.moe_shared_experts * 3 * d * self.moe_d_ff \
                    if not self.d_ff else 3 * d * self.d_ff
                total += d * self.moe_experts  # router
            else:
                mult = 3 if self.activation == "swiglu" else 2
                total += mult * d * self.d_ff
            total += 2 * d  # norms
        for _ in range(enc_layers):
            qkv = d * (self.num_heads + 2 * self.num_kv_heads) * hd
            total += qkv + self.num_heads * hd * d
            mult = 3 if self.activation == "swiglu" else 2
            total += mult * d * self.d_ff + 2 * d
            if self.is_encoder_decoder:  # decoder cross-attention
                total += qkv + self.num_heads * hd * d
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top-k + shared only)."""
        if self.moe_experts <= 0:
            return self.param_count()
        full = self.param_count()
        inactive_frac_layers = 0
        for i in range(self.num_layers):
            if self.layer_is_moe(i):
                inactive = (self.moe_experts - self.moe_top_k) * 3 \
                    * self.d_model * self.moe_d_ff
                inactive_frac_layers += inactive
        return full - inactive_frac_layers
