"""Serving launcher: batched greedy generation on the card (or, with
``--device cpu``, on the CPU).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 16 --new-tokens 32
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.models import get_config
from repro_torch.serving import Engine, ServeConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--sliding-window", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, args.variant)
    if args.sliding_window:
        cfg = cfg.long_context_variant(args.sliding_window)
    engine = Engine(ServeConfig(model=cfg, batch=args.batch,
                                max_len=args.max_len), device=args.device)
    gen = torch.Generator(device=engine.device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32,
                            device=engine.device)
    tokens, stats = engine.generate(prompts, args.new_tokens)
    print(f"generated {tuple(tokens.shape)} tokens")
    print(f"prefill {stats['prefill_s']*1e3:.0f}ms  "
          f"decode {stats['decode_tok_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
