"""Serving engine (port of ``repro/serving/engine.py``): batched prefill +
decode with a KV cache.

``serve_step`` (one token for the whole batch against a fixed-size cache) is
the decode unit; the ``Engine`` class wraps it with a token-stepping prefill
and a greedy generation loop, and ``prefill_fn`` is the bulk prefill
``forward`` (which reaches the flash-attention kernel on prompts of at least
``attn_chunk_threshold`` tokens). Everything runs under
``torch.inference_mode()``. The engine runs on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..kernels.ops import resolve_device
from ..models import decode_step, forward, init_cache, init_params
from ..models.config import ModelConfig


@dataclass
class ServeConfig:
    model: ModelConfig
    batch: int
    max_len: int
    temperature: float = 0.0   # 0 = greedy


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens1) -> (next_tokens, logits, cache)."""
    def serve_step(params, cache, tokens1):
        logits, cache = decode_step(params, cache, tokens1, cfg)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache
    return serve_step


class Engine:
    """Minimal batched serving loop over the model."""

    def __init__(self, sc: ServeConfig, params=None, seed: int = 0,
                 device=None):
        self.sc = sc
        cfg = sc.model
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, device=self.device)
        self.params = params.to(self.device)
        self.cache = init_cache(cfg, sc.batch, sc.max_len, device=self.device)
        self.step_fn = torch.inference_mode()(make_serve_step(cfg))
        self.prefill_fn = torch.inference_mode()(
            lambda p, toks, kw: forward(p, toks, cfg, **kw))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, prompts: torch.Tensor, frames=None) -> torch.Tensor:
        """Teacher-forced prefill; fills the KV cache by stepping tokens.

        For attention-only models a bulk prefill would be a single forward;
        stepping keeps one code path valid for SSM/hybrid caches too (decode
        correctness is what the examples demonstrate).
        """
        if frames is not None:
            raise NotImplementedError("frames feed the encoder, not ported "
                                      "yet (ROADMAP.md queue 1, item 10)")
        prompts = prompts.to(self.device)
        last = None
        for t in range(prompts.shape[1]):
            last, _, self.cache = self.step_fn(self.params, self.cache,
                                               prompts[:, t:t + 1])
        return last

    def generate(self, prompts: torch.Tensor, new_tokens: int,
                 frames=None) -> Tuple[torch.Tensor, Dict[str, float]]:
        """Greedy generation: ``(tokens (B, new_tokens), stats)``; the times
        end in a device synchronize."""
        self._sync()
        t0 = time.perf_counter()
        nxt = self.prefill(prompts, frames=frames)
        self._sync()
        t_prefill = time.perf_counter() - t0
        out = [nxt]
        t1 = time.perf_counter()
        for _ in range(new_tokens - 1):
            nxt, _, self.cache = self.step_fn(self.params, self.cache, nxt)
            out.append(nxt)
        tokens = torch.cat(out, dim=1)
        self._sync()
        t_decode = time.perf_counter() - t1
        stats = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tok_per_s": (new_tokens - 1) * prompts.shape[0]
            / max(t_decode, 1e-9),
        }
        return tokens, stats
