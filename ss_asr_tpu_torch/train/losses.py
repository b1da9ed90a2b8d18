"""Loss functions with the reference's normalisation.

Port of ``ss_asr_tpu/train/losses.py``: per-position cross-entropy with
pad id 0 ignored, summed per utterance and divided by the full target's
non-pad count (ASR, TAE); smooth-L1 over the batch's longest utterance
(SAE); binary cross-entropy on sigmoid outputs (ADV); the char-LM's
cross-entropy summed over the chunk (``chunk_ce``).
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


def chunk_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The char-LM loss: cross-entropy summed over the chunk, meaned over the
    batch, no ignore index.  logits [B, L, V]; labels [B, L]."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return nll.sum(-1).mean()


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def masked_smooth_l1_mean(pred: torch.Tensor, target: torch.Tensor, t_valid) -> torch.Tensor:
    """The SAE loss: smooth-L1 summed over the first ``t_valid`` frames (the
    batch's longest utterance; zeros past each sample's own length included)
    of every sample, divided by ``B * t_valid * F``.  pred / target [B, T, F]
    float32 (the targets reach log(eps) = -36 on silence: the exact beta = 1
    form, no reduced precision)."""
    B, T, F = pred.shape
    mask = (torch.arange(T, device=pred.device) < t_valid)[None, :, None].to(pred.dtype)
    return (smooth_l1(pred, target) * mask).sum() / (B * t_valid * F)


def bce(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on sigmoid *outputs*, clipped at 1e-7, batch mean."""
    eps = 1e-7
    s = scores.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(s) + (1.0 - targets) * torch.log(1.0 - s)).mean()
