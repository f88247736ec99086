"""Training launcher (port of ``repro/launch/train.py``).

``--arch <id> --variant smoke`` trains a reduced config on synthetic data;
``--variant full`` the published widths. It runs on the card unless
``--device cpu``. The world is ``--data-parallel`` x ``--model-parallel``
ranks, one process each (``torch.multiprocessing``, a ``file://``
rendezvous in a temporary directory): NCCL on CUDA, one card a rank; gloo
on the CPU. Every rank builds the ``(data, model)`` mesh
(:func:`~repro_torch.launch.mesh.make_host_mesh`; rank ``d * model + m``
at ``(d, m)``), installs the parallel context and runs the
:class:`~repro_torch.train.Trainer` under it, as the reference's launcher
does: the weights are replicated, the MoE layers take their
expert-parallel forms over the model group, and the gradients are
averaged over the data group. Every run, one rank included, forms a
process group, so the explicit ``--grad-sync`` modes always run their
collective.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --variant smoke --steps 100 --grad-sync canary --device cpu \
        --data-parallel 2
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2-moe-a2.7b --variant smoke --device cpu \
        --data-parallel 2 --model-parallel 2
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.data import DataConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelConfig, get_config
from repro_torch.optim import AdamWConfig, cosine_with_warmup
from repro_torch.parallel import ParallelContext, parallel_context
from repro_torch.train import Mesh, TrainConfig, Trainer, TrainerConfig


def make_trainer(args: argparse.Namespace, world: int, device: torch.device,
                 cfg: Optional[ModelConfig] = None
                 ) -> Tuple[Trainer, ParallelContext]:
    """This rank's :class:`Trainer` and the parallel context to run it
    under: the ``(world / --model-parallel, --model-parallel)`` mesh over
    the default process group, which every rank must have joined. ``cfg``
    defaults to ``--arch``'s ``--variant``."""
    cfg = cfg or get_config(args.arch, args.variant)
    sched = cosine_with_warmup(args.lr, warmup_steps=max(1, args.steps // 20),
                               total_steps=args.steps)
    tc = TrainConfig(model=cfg,
                     optimizer=AdamWConfig(lr=args.lr, schedule=sched),
                     grad_sync=args.grad_sync,
                     canary_blocks=args.canary_blocks)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch,
                      seq_len=args.seq)
    trainer_cfg = TrainerConfig(
        train=tc, data=data, steps=args.steps,
        log_every=args.log_every if dist.get_rank() == 0 else 0,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        replan_every=args.replan_every)
    mesh = make_host_mesh(world // args.model_parallel, args.model_parallel,
                          device_type=device.type)
    ctx = ParallelContext(mesh=mesh, data_axes=("data",), model_axis="model")
    return Trainer(trainer_cfg, mesh=Mesh.of(ctx), device=device), ctx


def _rank_main(rank: int, args: argparse.Namespace, world: int,
               init_file: str) -> None:
    """One rank: join the group, build the mesh and context, train, report
    from rank 0."""
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:   # ranks share the host's cores
        device, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        trainer, ctx = make_trainer(args, world, device)
        with parallel_context(ctx):
            history = trainer.run()
    finally:
        dist.destroy_process_group()
    if rank:
        return
    first, last = history[0]["loss"], history[-1]["loss"]
    dp, tp = world // args.model_parallel, args.model_parallel
    print(f"loss: {first:.4f} -> {last:.4f} over {args.steps} steps "
          f"({args.grad_sync}, {dp} data-parallel rank{'s' if dp > 1 else ''}"
          f" on {device.type}" + (f", {tp} model-parallel ranks each)"
                                  if tp > 1 else ")"))
    if args.history_out:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(history, f)


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-sync", default="auto",
                    choices=["auto", "canary", "canary_fp", "ring",
                             "hierarchical"])
    ap.add_argument("--canary-blocks", type=int, default=16)
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="0 = every card over --model-parallel (1 on the "
                         "CPU)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--replan-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    resolve_device(args.device)
    cards = torch.cuda.device_count() if args.device == "cuda" else 1
    mp_ = args.model_parallel
    world = (args.data_parallel or max(1, cards // mp_)) * mp_
    if args.device == "cuda" and world > cards:
        raise ValueError(f"{world} ranks (data x model parallel) need "
                         f"{world} cards, this machine has {cards}")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        if world == 1:
            _rank_main(0, args, 1, init_file)
        else:
            mp.spawn(_rank_main, args=(args, world, init_file), nprocs=world,
                     join=True)


if __name__ == "__main__":
    main()
