"""Congestion oracle: block -> tree(root) assignment planning.

The paper picks paths per packet from switch queue depths. A compiled XLA
program cannot re-route per packet, so the TPU adaptation moves the decision
one level up (DESIGN.md §4, changed assumption 2): between steps, the planner
re-assigns reduction blocks to tree roots using

* an **analytic link-load model** of binomial trees on a ring (hop ``j`` of a
  tree rooted at ``r`` crosses the ring links in ``[r - 2^(j+1), r - 2^j)``
  with weight 1), and
* **measured step-time feedback** (multiplicative weights over candidate
  assignments) standing in for queue-occupancy telemetry.

``round_robin`` (the paper's §3.1.3 policy) is the faithful baseline;
``balanced`` is the congestion-aware refinement.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


def round_robin_roots(num_blocks: int, axis_size: int) -> List[int]:
    """Paper §3.1.3: 'the hosts could select the roots in a round-robin way'."""
    return [k % axis_size for k in range(num_blocks)]


def tree_link_load(root: int, axis_size: int) -> np.ndarray:
    """Ring-link load (per direction) of one binomial tree rooted at ``root``.

    Hop ``j`` sends partials from relative index ``2^j + m*2^(j+1)`` to
    ``m*2^(j+1)``; on a ring each such transfer crosses ``2^j`` consecutive
    links. Returns an (axis_size,) array of link weights.
    """
    load = np.zeros(axis_size)
    rounds = max(1, math.ceil(math.log2(axis_size)))
    for j in range(rounds):
        stride = 1 << j
        senders = [s for s in range(stride, axis_size, 2 * stride)]
        for rel in senders:
            src = (root + rel) % axis_size
            # data travels from src toward src - stride (down-ring)
            for step in range(stride):
                load[(src - 1 - step) % axis_size] += 1.0
    return load * 2.0  # broadcast retraces the same links in reverse


@dataclass
class CongestionOracle:
    """Stateful planner. ``plan()`` returns the root per block; ``feedback()``
    folds a measured step time back into the estimate."""

    axis_size: int
    num_blocks: int
    policy: str = "balanced"            # round_robin | balanced
    external_load: Optional[np.ndarray] = None  # modeled non-collective traffic
    _weights: np.ndarray = field(default=None, repr=False)  # type: ignore
    _history: List[float] = field(default_factory=list)

    def __post_init__(self):
        if self._weights is None:
            self._weights = np.ones(self.axis_size)

    def plan(self) -> List[int]:
        if self.policy == "round_robin":
            return round_robin_roots(self.num_blocks, self.axis_size)
        # balanced: greedy min-max assignment over modeled link load
        base = np.zeros(self.axis_size)
        if self.external_load is not None:
            base = base + np.asarray(self.external_load, dtype=float)
        per_root = [tree_link_load(r, self.axis_size) * self._weights[r]
                    for r in range(self.axis_size)]
        total = base.copy()
        roots: List[int] = []
        for _ in range(self.num_blocks):
            best, best_peak = 0, float("inf")
            for r in range(self.axis_size):
                peak = float(np.max(total + per_root[r]))
                if peak < best_peak - 1e-12:
                    best, best_peak = r, peak
            roots.append(best)
            total += per_root[best]
        return roots

    def feedback(self, step_time_s: float) -> None:
        """Multiplicative-weights update: a slower-than-median step inflates
        the weight of the roots used most recently, discouraging them."""
        self._history.append(step_time_s)
        if len(self._history) < 3:
            return
        med = float(np.median(self._history[-16:]))
        ratio = step_time_s / max(med, 1e-12)
        # uniform decay toward 1 keeps the oracle stable
        self._weights = np.clip(self._weights * (0.9 + 0.1 * ratio), 0.5, 2.0)
