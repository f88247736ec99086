"""Training loop (port of ``repro/train/trainer.py``): data pipeline +
train_step + congestion-oracle feedback + checkpointing.

With a :class:`~.train_step.Mesh`, every rank runs its own
:class:`Trainer` on its data rank's slice of each batch (under a parallel
context the mesh is the context's data groups, and the model ranks of a
data rank share its rows). The oracle plans trees over the data group;
its feedback is the slowest rank's step time, agreed by an all-reduce over
every rank, so every rank plans the same roots. The weights are the same
on every rank, so only rank 0 writes checkpoints.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..checkpoint import save_checkpoint
from ..core.collective import CongestionOracle
from ..data import DataConfig, batch_at
from ..kernels.ops import resolve_device
from ..models.layers import torch_dtype
from .train_step import Mesh, TrainConfig, init_train_state, make_train_step


@dataclass
class TrainerConfig:
    train: TrainConfig
    data: DataConfig
    steps: int = 50
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    replan_every: int = 0     # >0: re-plan canary roots from oracle feedback


class Trainer:
    """Runs on the card unless ``device="cpu"``; ``seed`` seeds the
    parameters' generator on that device."""

    def __init__(self, cfg: TrainerConfig, mesh: Optional[Mesh] = None,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params, self.opt_state = init_train_state(cfg.train, gen,
                                                       device=self.device)
        self.oracle: Optional[CongestionOracle] = None
        if cfg.train.grad_sync in ("canary", "canary_fp") and mesh is not None:
            self.oracle = CongestionOracle(axis_size=mesh.inner_size,
                                           num_blocks=cfg.train.canary_blocks)
        self._build_step()
        self.history: List[Dict[str, float]] = []

    def _build_step(self):
        self.tc = self.cfg.train
        if self.oracle is not None:
            self.tc = dataclasses.replace(
                self.tc, canary_roots=tuple(self.oracle.plan()))
        self.step_fn = make_train_step(self.tc, mesh=self.mesh)

    def make_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """This rank's slice of the global batch of ``step``, on the
        trainer's device."""
        B = self.cfg.data.global_batch
        rows = (0, B) if self.mesh is None else self.mesh.batch_slice(B)
        np_batch = batch_at(self.cfg.data, step, batch_slice=rows)
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in np_batch.items()}
        mcfg, n = self.cfg.train.model, rows[1] - rows[0]
        stub = {"audio_stub": ("frames", mcfg.encoder_seq),
                "vision_stub": ("patches", mcfg.num_patches)}
        if mcfg.frontend in stub:
            key, length = stub[mcfg.frontend]
            batch[key] = torch.full((n, length, mcfg.d_model), 0.02,
                                    dtype=torch_dtype(mcfg.dtype),
                                    device=self.device)
        return batch

    def _slowest(self, seconds: float) -> float:
        """The largest of every rank's ``seconds``."""
        if self.mesh is None or dist.get_world_size() == 1:
            return seconds
        t = torch.tensor([seconds], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

    def run(self) -> List[Dict[str, float]]:
        cfg = self.cfg
        for step in range(cfg.steps):
            batch = self.make_batch(step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # host sync
            dt = time.perf_counter() - t0
            metrics["step"] = step
            metrics["step_time_s"] = dt
            self.history.append(metrics)
            if self.oracle is not None:
                self.oracle.feedback(self._slowest(dt))
                if cfg.replan_every and (step + 1) % cfg.replan_every == 0:
                    self._build_step()   # adopt the re-planned roots
            if cfg.log_every and step % cfg.log_every == 0:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"acc {metrics.get('accuracy', 0):.4f} {dt*1e3:.0f}ms")
            if cfg.checkpoint_dir and cfg.checkpoint_every and \
                    (step + 1) % cfg.checkpoint_every == 0 and \
                    (self.mesh is None or dist.get_rank() == 0):
                save_checkpoint(cfg.checkpoint_dir, step + 1, self.params,
                                self.opt_state)
        return self.history
