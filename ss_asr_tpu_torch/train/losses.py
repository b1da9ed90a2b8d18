"""Loss functions with the reference's normalisation.

Port of ``ss_asr_tpu/train/losses.py`` (the ASR half): per-position
cross-entropy with pad id 0 ignored, summed per utterance and divided by the
full target's non-pad count.
"""

from __future__ import annotations

import torch


def masked_nll_per_utt(
    logits: torch.Tensor, labels: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Per-utterance length-normalised NLL [B].

    logits [B, L, V]; labels [B, L] (pad 0 is ignored); y [B, >= L], the
    full target row whose ``sum(y != 0)`` (at least 1) divides the sum."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    mask = (labels != 0).to(logits.dtype)
    denom = torch.clamp((y != 0).sum(-1).to(logits.dtype), min=1.0)
    return (nll * mask).sum(-1) / denom


def masked_ce_per_utt(
    logits: torch.Tensor, labels: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """The ASR train loss: the batch mean of ``masked_nll_per_utt``."""
    return masked_nll_per_utt(logits, labels, y).mean()
