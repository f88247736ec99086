"""Batched serving demo on the PyTorch port: prefill + greedy decode with a
KV cache on a reduced Qwen2, plus a Mamba-2 (SSM state cache) and a
sliding-window long-context variant.

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]

``examples/serve_decode.py`` on the port's ``Engine``, on the card unless
``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.models import get_config  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402


def demo(arch: str, device: str, sliding_window: int = 0) -> None:
    cfg = get_config(arch, "smoke")
    if sliding_window:
        cfg = cfg.long_context_variant(sliding_window)
    engine = Engine(ServeConfig(model=cfg, batch=4, max_len=128),
                    device=device)
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=gen,
                            dtype=torch.int32).to(engine.device)
    tokens, stats = engine.generate(prompts, new_tokens=24)
    print(f"{cfg.name:24s} out={tuple(tokens.shape)} "
          f"decode={stats['decode_tok_per_s']:7.1f} tok/s "
          f"prefill={stats['prefill_s']*1e3:6.0f} ms")
    assert tuple(tokens.shape) == (4, 24)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    demo("qwen2-7b", args.device)
    demo("mamba2-130m", args.device)
    demo("llama3.2-1b", args.device, sliding_window=16)
    print("serving OK")


if __name__ == "__main__":
    main()
