"""From a :class:`~repro.models.config.ModelConfig` to gradient traffic.

Data-parallel training synchronizes one gradient per parameter every
iteration. DDP-style implementations do not allreduce per tensor: they pack
gradients into fixed-size *buckets* in reverse layer order — the order the
backward pass produces them — and launch one allreduce per bucket as soon as
its last gradient is ready, overlapping communication with the rest of the
backward pass. This module derives that structure analytically:

* :func:`grad_segments` — per-layer gradient sizes (parameters, routed-expert
  parameters, per-token *active* parameters) in backward completion order:
  LM head first, decoder layers last→first, encoder layers (whisper) after
  the decoder, input embedding last. The decomposition mirrors
  ``ModelConfig.param_count()`` term by term and is pinned to it exactly by
  ``tests/workload/test_model_comm.py`` over every registered architecture.
* :func:`pack_buckets` — DDP-style packing into a :class:`CommPlan`: fill a
  bucket in backward order until it reaches ``bucket_bytes``, then close it.
  A segment larger than ``bucket_bytes`` is split into bucket-sized chunks
  first (real DDP packs at tensor granularity, so one big layer spans
  several buckets); every chunk of a segment carries the segment's release
  point, since its gradients only all exist once that layer's backward is
  done. Gradient dtype defaults to the model's compute dtype.

MoE expert sharding: with ``expert_sharding=False`` (classic DDP) every rank
holds every expert and routed-expert gradients ride the same data-parallel
allreduce. With ``True`` (expert parallelism, ``moe_impl="ep"``) each rank
owns a shard of the experts — expert gradients are reduced inside the
expert group by the layer's all-to-alls, *not* by the DP allreduce — so they
are excluded from the buckets and reported as ``expert_grad_bytes``.

Everything here is pure arithmetic on the config — no jax, no simulator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ...models.config import ModelConfig

# Gradients are exchanged in the model's compute dtype (bf16 training keeps
# bf16 grads on the wire; fp32 master copies live in the optimizer).
GRAD_DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


@dataclass(frozen=True)
class GradSegment:
    """Gradients released by one backward step (one layer / head / embed).

    ``order`` is the backward completion order (0 = first gradients out).
    ``params`` are data-parallel-replicated parameters whose gradients ride
    the DP allreduce; ``expert_params`` are routed-expert parameters (see
    module docstring); ``active_params`` are the per-token *activated*
    parameters, used to attribute FLOPs to this segment
    (``sum(active_params) == cfg.active_param_count()``).
    """

    name: str
    order: int
    params: int
    expert_params: int
    active_params: int

    @property
    def total_params(self) -> int:
        return self.params + self.expert_params


@dataclass(frozen=True)
class GradBucket:
    """One DDP gradient bucket == one allreduce job.

    ``last_order`` is the backward order of the latest segment in the bucket:
    the bucket's allreduce can launch once that segment's backward completes.
    """

    index: int
    bytes: int
    params: int
    segments: Tuple[str, ...]
    last_order: int


@dataclass(frozen=True)
class CommPlan:
    """A model's complete per-iteration gradient-communication plan."""

    model: str
    dtype_bytes: int
    bucket_bytes: int
    expert_sharding: bool
    segments: Tuple[GradSegment, ...]
    buckets: Tuple[GradBucket, ...]
    total_grad_bytes: int          # DP-allreduced bytes (sum of bucket bytes)
    expert_grad_bytes: int         # excluded by expert sharding (0 otherwise)

    def summary(self) -> str:
        return (f"{self.model}: {len(self.segments)} segments -> "
                f"{len(self.buckets)} buckets x <= ~{self.bucket_bytes} B, "
                f"dp_grad={self.total_grad_bytes} B "
                f"expert_sharded={self.expert_grad_bytes} B")


def grad_dtype_bytes(cfg: ModelConfig,
                     grad_dtype: Optional[str] = None) -> int:
    dt = grad_dtype if grad_dtype is not None else cfg.dtype
    try:
        return GRAD_DTYPE_BYTES[dt]
    except KeyError:
        raise ValueError(f"unknown gradient dtype {dt!r}; known: "
                         f"{sorted(GRAD_DTYPE_BYTES)}") from None


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qkv = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    return qkv + cfg.num_heads * hd * d


def _ssm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return d * (2 * di + 2 * di) + 2 * di * n + di * d


def _dense_mlp_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.activation == "swiglu" else 2
    return mult * cfg.d_model * cfg.d_ff


def grad_segments(cfg: ModelConfig) -> Tuple[GradSegment, ...]:
    """Per-segment gradient sizes in backward completion order.

    Mirrors ``ModelConfig.param_count()`` exactly:
    ``sum(s.total_params) == cfg.param_count()`` and
    ``sum(s.active_params) == cfg.active_param_count()``.
    """
    d, v = cfg.d_model, cfg.vocab_size
    segs = []
    order = 0
    # LM head gradients come out first (loss -> logits -> output projection).
    # Tied embeddings accumulate into the embedding gradient instead, which
    # is only complete once the backward reaches the input embedding.
    if not cfg.tie_embeddings:
        segs.append(GradSegment("head", order, v * d, 0, v * d))
        order += 1
    for i in reversed(range(cfg.num_layers)):
        if cfg.layer_kind(i) == "attn":
            mixer = _attn_params(cfg)
        else:
            mixer = _ssm_params(cfg)
        params = mixer + 2 * d                      # + norms
        expert = 0
        active = 0
        if cfg.layer_is_moe(i):
            expert = cfg.moe_experts * 3 * d * cfg.moe_d_ff
            # shared experts (fused into d_ff when set) + router stay dense
            params += cfg.moe_shared_experts * 3 * d * cfg.moe_d_ff \
                if not cfg.d_ff else 3 * d * cfg.d_ff
            params += d * cfg.moe_experts
            active = params + cfg.moe_top_k * 3 * d * cfg.moe_d_ff
        else:
            params += _dense_mlp_params(cfg)
            active = params
        segs.append(GradSegment(f"layer{i}", order, params, expert, active))
        order += 1
    # Encoder backward (whisper) runs after the decoder's. param_count()
    # folds the decoder cross-attention into the encoder loop; mirror that.
    for i in reversed(range(cfg.encoder_layers)):
        params = _attn_params(cfg) + _dense_mlp_params(cfg) + 2 * d
        if cfg.is_encoder_decoder:
            params += _attn_params(cfg)             # decoder cross-attention
        segs.append(GradSegment(f"enc{i}", order, params, 0, params))
        order += 1
    segs.append(GradSegment("embed", order, v * d, 0, v * d))
    return tuple(segs)


def pack_buckets(cfg: ModelConfig, *, bucket_bytes: int,
                 grad_dtype: Optional[str] = None,
                 expert_sharding: bool = False) -> CommPlan:
    """Pack :func:`grad_segments` into DDP-style buckets (module docstring)."""
    if bucket_bytes <= 0:
        raise ValueError("bucket_bytes must be positive")
    db = grad_dtype_bytes(cfg, grad_dtype)
    segments = grad_segments(cfg)
    buckets = []
    cur_bytes, cur_params, cur_names, cur_last = 0, 0, [], -1
    expert_bytes = 0

    def close() -> None:
        nonlocal cur_bytes, cur_params, cur_names, cur_last
        buckets.append(GradBucket(index=len(buckets), bytes=cur_bytes,
                                  params=cur_params,
                                  segments=tuple(cur_names),
                                  last_order=cur_last))
        cur_bytes, cur_params, cur_names, cur_last = 0, 0, [], -1

    for seg in segments:
        dp_params = seg.params
        if expert_sharding:
            expert_bytes += seg.expert_params * db
        else:
            dp_params += seg.expert_params
        if dp_params == 0:
            continue
        # split a segment bigger than the bucket cap into bucket-sized
        # chunks (DDP packs per tensor; one big layer spans several buckets)
        n_chunks = max(1, -(-dp_params * db // bucket_bytes))
        base, rem = divmod(dp_params, n_chunks)
        for c in range(n_chunks):
            chunk_params = base + (1 if c < rem else 0)
            name = seg.name if n_chunks == 1 else f"{seg.name}#{c}"
            cur_bytes += chunk_params * db
            cur_params += chunk_params
            cur_names.append(name)
            cur_last = seg.order
            if cur_bytes >= bucket_bytes:
                close()
    if cur_names:
        close()
    return CommPlan(model=cfg.name, dtype_bytes=db, bucket_bytes=bucket_bytes,
                    expert_sharding=expert_sharding, segments=segments,
                    buckets=tuple(buckets),
                    total_grad_bytes=sum(b.bytes for b in buckets),
                    expert_grad_bytes=expert_bytes)


def total_dp_grad_bytes(cfg: ModelConfig, *, grad_dtype: Optional[str] = None,
                        expert_sharding: bool = False) -> int:
    """Total bytes the DP allreduce moves per iteration (no bucketing)."""
    db = grad_dtype_bytes(cfg, grad_dtype)
    total = 0
    for seg in grad_segments(cfg):
        total += seg.params + (0 if expert_sharding else seg.expert_params)
    return total * db
