"""Training losses (port of ``repro/train/losses.py``): cross-entropy with
an optional z-loss and mask."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, z_loss: float = 0.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (B, S, V) float, labels (B, S) int. Stable fp32 reduction."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    # the label's logit stays (B, S, 1) until the subtraction: on logits
    # sharded over the vocabulary (a DTensor) the gather is a masked partial
    # sum, which DTensor reduces correctly only in the gather's own shape
    ll = torch.gather(lg, -1, labels[..., None].to(torch.int64))
    nll = (lse[..., None] - ll)[..., 0]
    if z_loss > 0.0:
        nll = nll + z_loss * torch.square(lse)
    hit = (lg.argmax(-1) == labels).to(torch.float32)
    if mask is not None:
        mask = mask.to(torch.float32)
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
        acc = (hit * mask).sum() / denom
    else:
        loss = nll.mean()
        acc = hit.mean()
    return loss, {"loss": loss, "accuracy": acc}
