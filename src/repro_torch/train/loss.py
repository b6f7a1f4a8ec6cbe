"""Next-token cross-entropy with masking and z-loss (port of
``repro/train/loss.py``).

The log-softmax runs in f32 regardless of logits dtype, as the reference's
(XLA computes it there, outside any Pallas kernel). ``ignore_index`` (-1)
masks padding tokens out of both the loss and the denominator.
"""
from __future__ import annotations

from typing import Tuple

import torch

IGNORE_INDEX = -1


def cross_entropy_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) integers, IGNORE_INDEX = masked
    *,
    z_loss_coeff: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean loss, token count)."""
    logits = logits.float()
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)  # (B, S)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - picked
    if z_loss_coeff:
        nll = nll + z_loss_coeff * torch.square(lse)
    n = torch.clamp(mask.sum(), min=1)
    loss = torch.where(mask, nll, 0.0).sum() / n
    return loss, n
