"""What a training step holds at its peak on the card, by allocation site,
for each ``--grad-sync`` mode: one warm step of the port's trainer in a
one-rank NCCL group, the allocator's trace of the next step replayed to
its peak, the blocks live there summed by the first frame of the port's
code that made them.

Usage (on a machine with a card)::

    PYTHONPATH=src python scripts/train_peak_sites.py --arch llama3.2-1b \\
        --batch 1 --seq 8192 --modes auto,canary_fp

Prints, a mode at a time, the step's ``max_memory_allocated()``, the
replayed peak and the largest sites at it, then each site's difference
from the first mode's.
"""
import argparse
import tempfile
from collections import Counter

import torch
import torch.distributed as dist

from repro_torch.launch.memtrace import blocks_at_peak


def sites_at_peak(before, after) -> tuple:
    """``(peak bytes, Counter of bytes by site)`` of the blocks live at the
    peak of the trace between two snapshots."""
    peak, live = blocks_at_peak(before, after)
    sites = Counter()
    for n, where in live.values():
        sites[where] += n
    return peak, sites


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--modes", default="auto,canary_fp")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    from repro_torch.data import DataConfig
    from repro_torch.models import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, Trainer, TrainerConfig,
                                   make_mesh)
    cfg = get_config(args.arch, "full")
    gib = 2 ** 30
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh()
            for mode in args.modes.split(","):
                trainer = Trainer(TrainerConfig(
                    train=TrainConfig(model=cfg, optimizer=AdamWConfig(),
                                      grad_sync=mode),
                    data=DataConfig(vocab_size=cfg.vocab_size,
                                    global_batch=args.batch,
                                    seq_len=args.seq, seed=0),
                    steps=2, log_every=0), mesh=mesh, seed=0, device="cuda")
                step, seen = trainer.step_fn, {}

                def traced(*a, step=step, seen=seen):
                    if not seen.get("warm"):
                        seen["warm"] = True
                        return step(*a)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    torch.cuda.memory._record_memory_history(
                        context="alloc", stacks="python",
                        max_entries=1_000_000)
                    seen["before"] = torch.cuda.memory._snapshot()
                    out = step(*a)
                    torch.cuda.synchronize()
                    seen["after"] = torch.cuda.memory._snapshot()
                    torch.cuda.memory._record_memory_history(enabled=None)
                    seen["peak"] = torch.cuda.max_memory_allocated()
                    return out
                trainer.step_fn = traced
                trainer.run()
                peak, sites = sites_at_peak(seen["before"], seen["after"])
                found[mode] = sites
                print(f"{mode}: max_memory_allocated {seen['peak'] / gib:.3f}"
                      f" GiB, replayed peak {peak / gib:.3f} GiB; at it: "
                      + "; ".join(f"{w} {n / 2**20:.1f} MiB"
                                  for w, n in sites.most_common(args.top)),
                      flush=True)
                del trainer, seen
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    modes = list(found)
    for mode in modes[1:]:
        diff = Counter(found[mode])
        diff.subtract(found[modes[0]])
        print(f"{mode} - {modes[0]} at the peak: " + "; ".join(
            f"{w} {n / 2**20:+.1f} MiB" for w, n in sorted(
                diff.items(), key=lambda kv: -abs(kv[1]))[:args.top] if n),
            flush=True)


if __name__ == "__main__":
    main()
