"""Quickstart on the PyTorch port: train a reduced Llama-3.2 on synthetic
data for 200 steps.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The public API end to end, as ``examples/quickstart.py`` drives the JAX
package: config registry -> init -> train_step -> trainer loop, on the card
unless ``--device cpu``. Loss should drop from ~ln(V) to well below it (the
synthetic stream is learnable position-hash structure + memorization).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_with_warmup  # noqa: E402
from repro_torch.train import TrainConfig, Trainer, TrainerConfig  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    cfg = get_config("llama3.2-1b", "smoke")
    steps = args.steps
    tc = TrainConfig(
        model=cfg,
        optimizer=AdamWConfig(lr=3e-3, schedule=cosine_with_warmup(
            3e-3, warmup_steps=10, total_steps=steps)),
    )
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=8, seq_len=64)
    trainer = Trainer(TrainerConfig(train=tc, data=data, steps=steps,
                                    log_every=25), device=args.device)
    hist = trainer.run()
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    assert hist[-1]["loss"] < hist[0]["loss"], "training failed to learn"
    print("quickstart OK")


if __name__ == "__main__":
    main()
