"""Train a reduced DeepSeekMoE on the PyTorch port with the Canary gradient
allreduce over an 8-way data-parallel mesh (8 gloo ranks, one process
each), comparing grad-sync strategies: plain all-reduce (auto) vs ring vs
Canary dynamic trees vs fixed-point Canary.

    PYTHONPATH=src python examples/train_moe_canary_torch.py [--device cpu]

``examples/train_moe_canary.py`` on the port: every rank builds the (8, 1)
``(data, model)`` mesh and runs the trainer under its
``ParallelContext``; the ranks share the card (gloo carries the
collectives) unless ``--device cpu``.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel import (ParallelContext,  # noqa: E402
                                  parallel_context)
from repro_torch.train import (Mesh, TrainConfig, Trainer,  # noqa: E402
                               TrainerConfig)

RANKS = 8


def rank_main(rank: int, grad_sync: str, steps: int, device: str,
              tmp: str) -> None:
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // RANKS))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=RANKS, rank=rank)
    try:
        cfg = get_config("deepseek-moe-16b", "smoke")
        tc = TrainConfig(model=cfg, optimizer=AdamWConfig(lr=5e-3),
                         grad_sync=grad_sync, canary_blocks=8)
        data = DataConfig(vocab_size=cfg.vocab_size, global_batch=16,
                          seq_len=32)
        ctx = ParallelContext(mesh=make_host_mesh(RANKS, 1,
                                                  device_type=device),
                              data_axes=("data",), model_axis="model")
        with parallel_context(ctx):
            trainer = Trainer(TrainerConfig(train=tc, data=data, steps=steps,
                                            log_every=0), mesh=Mesh.of(ctx),
                              device=device)
            history = trainer.run()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "losses.json"), "w") as f:
            json.dump([h["loss"] for h in history], f)


def run(grad_sync: str, steps: int, device: str) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(grad_sync, steps, device, tmp),
                 nprocs=RANKS, join=True)
        with open(os.path.join(tmp, "losses.json")) as f:
            return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card; pass --device cpu")
    results = {}
    for mode in ("auto", "ring", "canary", "canary_fp"):
        losses = run(mode, args.steps, args.device)
        results[mode] = losses
        print(f"{mode:10s} loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    # every strategy implements the same mathematical allreduce: loss curves
    # must agree closely (fixed-point within quantization error)
    ref = np.array(results["auto"])
    for mode in ("ring", "canary"):
        np.testing.assert_allclose(np.array(results[mode]), ref, rtol=2e-2,
                                   atol=2e-2)
    np.testing.assert_allclose(np.array(results["canary_fp"]), ref, rtol=5e-2,
                               atol=5e-2)
    print("all grad-sync strategies converge identically — OK")


if __name__ == "__main__":
    main()
