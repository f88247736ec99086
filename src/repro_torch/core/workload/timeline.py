"""Backward-pass timeline: when does each gradient bucket become ready?

The backward pass is modeled as one roofline-estimated compute segment per
:class:`~.model_comm.GradSegment`, executed in backward order. A bucket's
allreduce can launch the moment its last segment finishes — that release
time becomes the bucket job's ``arrival_ns`` in the simulator, so the
packet-level run sees exactly the staggered, compute-overlapped traffic a
DDP trainer emits.

Roofline model (per segment, per device):

* FLOPs — the 6ND split: forward ``2 * active_params * tokens``, backward
  ``4 * active_params * tokens`` (``model_flops_per_step`` in
  ``repro.launch.analysis`` uses the same 6ND/2ND accounting; the per-segment
  attribution is by active parameters, so segment FLOPs sum to the
  whole-model figure).
* bytes — weights read + gradients written (backward: weight read, grad
  write, weight-grad write ~ 3x params) plus activation traffic
  (~``4 * tokens * d_model`` reads/writes per segment).
* ``time = max(flops / (peak * mfu), bytes / hbm_bw)`` — compute- or
  memory-bound, whichever binds.

Hardware defaults are the NVIDIA H100 SXM constants of
``repro_torch.launch.mesh`` (pinned equal by
``tests/test_torch_workload.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ...launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from ...models.config import ModelConfig

from .model_comm import CommPlan


@dataclass(frozen=True)
class HostSpec:
    """Roofline device model for one data-parallel rank."""

    peak_flops: float = PEAK_FLOPS_BF16   # per-card peak (bf16, dense)
    hbm_bw: float = HBM_BW                # bytes/s
    mfu: float = 0.4                      # achieved fraction of peak FLOPs

    def segment_ns(self, flops: float, mem_bytes: float) -> float:
        compute_s = flops / (self.peak_flops * self.mfu)
        memory_s = mem_bytes / self.hbm_bw
        return max(compute_s, memory_s) * 1e9


@dataclass(frozen=True)
class ComputeSegment:
    """One backward-pass segment on the modeled timeline."""

    name: str
    order: int
    start_ns: float
    end_ns: float
    flops: float


@dataclass(frozen=True)
class IterationTimeline:
    """Compute-side timeline of one training iteration (no communication)."""

    forward_ns: float
    backward_ns: float
    segments: Tuple[ComputeSegment, ...]        # backward order
    bucket_release_ns: Tuple[float, ...]        # absolute, one per bucket

    @property
    def compute_ns(self) -> float:
        """Pure compute time: forward + backward, zero exposed comm."""
        return self.forward_ns + self.backward_ns


def build_timeline(cfg: ModelConfig, plan: CommPlan, *, seq: int,
                   global_batch: int, dp_hosts: int,
                   host: Optional[HostSpec] = None) -> IterationTimeline:
    """Schedule ``plan``'s segments on the roofline device model.

    ``dp_hosts`` is the data-parallel degree: each rank computes over
    ``global_batch / dp_hosts`` sequences, and each bucket is allreduced
    across all ``dp_hosts`` ranks.
    """
    if dp_hosts <= 0 or seq <= 0 or global_batch <= 0:
        raise ValueError("seq, global_batch and dp_hosts must be positive")
    host = host or HostSpec()
    tokens = seq * global_batch / dp_hosts
    db = plan.dtype_bytes

    # forward: 2ND over the whole model (segment order does not matter here)
    fwd_flops = sum(2.0 * s.active_params * tokens for s in plan.segments)
    fwd_bytes = sum(2.0 * s.total_params * db
                    + 2.0 * tokens * cfg.d_model * db for s in plan.segments)
    forward_ns = host.segment_ns(fwd_flops, fwd_bytes)

    # backward: per-segment 4ND, laid out sequentially in backward order
    segments = []
    t = 0.0
    end_by_order = {}
    for s in plan.segments:
        flops = 4.0 * s.active_params * tokens
        mem = 3.0 * s.total_params * db + 4.0 * tokens * cfg.d_model * db
        dur = host.segment_ns(flops, mem)
        segments.append(ComputeSegment(name=s.name, order=s.order,
                                       start_ns=t, end_ns=t + dur,
                                       flops=flops))
        t += dur
        end_by_order[s.order] = segments[-1].end_ns
    backward_ns = t

    releases = tuple(forward_ns + end_by_order[b.last_order]
                     for b in plan.buckets)
    return IterationTimeline(forward_ns=forward_ns, backward_ns=backward_ns,
                             segments=tuple(segments),
                             bucket_release_ns=releases)
