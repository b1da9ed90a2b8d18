"""SpecAugment: frequency and time masks on the log-mel features of the ASR
train step.

Port of ``ss_asr_tpu/ops/augment.py`` (Park et al. 2019, with the adaptive
time masks of Park et al. 2020).  Config-gated by the ``asr.augment``
section (absent = identity):

    asr:
      augment:
        n_freq_masks: 2
        freq_mask_width: 8     # mask width ~ U[0, F]
        n_time_masks: 2
        time_mask_width: 16    # mask width ~ U[0, T]
        adaptive_size_ratio: 0.0    # p_S: per-utterance time width cap = floor(p_S * len)
        adaptive_number_ratio: 0.0  # p_M: active time masks = min(n_time_masks, floor(p_M * len))

Masked regions take each utterance's mean over its valid frames; padding
frames stay exactly zero; time-mask starts fall within each utterance's
length.  The JAX package draws its uniforms inside the jitted step with
``jax.random``, whose streams cannot be reproduced here, so the four
uniform draws are inputs (``draws``): widths and starts of the frequency
masks, [B, n_freq_masks] each, then widths and starts of the time masks,
[B, n_time_masks] each (the order of ``jax.random.split`` there).  Without
them ``draw_uniforms`` takes them from a ``torch.Generator`` on the host.
Plain PyTorch ops on the tensors' device; no host sync.  The JAX function
reaches no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    n_freq_masks: int = 2
    freq_mask_width: int = 8
    n_time_masks: int = 2
    time_mask_width: int = 16
    #: p_S: when > 0, per-utterance time-mask width cap = floor(p_S * len)
    adaptive_size_ratio: float = 0.0
    #: p_M: when > 0, active time masks = min(n_time_masks, floor(p_M * len))
    adaptive_number_ratio: float = 0.0

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "Optional[SpecAugmentConfig]":
        if not d:
            return None
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            # a typo'd key would train with defaults the user tried to change
            raise ValueError(
                f"unknown asr.augment key(s) {sorted(unknown)}; valid keys: {sorted(known)}")
        cfg = cls(**d)
        for k in ("adaptive_size_ratio", "adaptive_number_ratio"):
            v = getattr(cfg, k)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"asr.augment.{k} must be in [0, 1], got {v}")
        return cfg


def _floor_ratio(p: float, lens: torch.Tensor) -> torch.Tensor:
    """floor(p * lens) as int32.  A float32 product can land one ulp below
    an exact integer (float32(0.13) * 900 = 116.99999...): the nudge of
    1e-3 before the floor keeps floor(p * len)."""
    return torch.floor(p * lens.to(torch.float32) + 1e-3).to(torch.int32)


def _interval_mask(u_width: torch.Tensor, u_start: torch.Tensor, max_widths: torch.Tensor,
                   size: int, limits: torch.Tensor,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, size] bool: True where any of the rows' intervals covers the
    position.  Widths = floor(u_width * (max_widths + 1)) capped at
    max_widths; starts = floor(u_start * max(limits - width, 1));
    ``active`` [B] keeps each row's first active[b] intervals."""
    n_masks = u_width.shape[1]
    widths = (u_width * (max_widths[:, None] + 1).to(u_width.dtype)).to(torch.int32)
    widths = torch.minimum(widths, max_widths[:, None])  # u == 1.0
    if active is not None:
        keep = torch.arange(n_masks, device=widths.device)[None, :] < active[:, None]
        widths = torch.where(keep, widths, torch.zeros_like(widths))
    span = torch.clamp(limits[:, None] - widths, min=1)
    starts = (u_start * span.to(u_start.dtype)).to(torch.int32)
    pos = torch.arange(size, device=widths.device)[None, :, None]
    covered = (pos >= starts[:, None, :]) & (pos < (starts + widths)[:, None, :])
    return covered.any(dim=-1)


def draw_uniforms(B: int, cfg: SpecAugmentConfig, generator: Optional[torch.Generator],
                  device) -> Draws:
    """The four uniform draws on the host from ``generator``, moved to ``device``."""
    shapes = [(B, cfg.n_freq_masks)] * 2 + [(B, cfg.n_time_masks)] * 2
    return tuple(torch.rand(s, generator=generator).to(device) for s in shapes)


def spec_augment(x: torch.Tensor, x_lens: torch.Tensor, cfg: SpecAugmentConfig,
                 draws: Optional[Draws] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``x`` [B, T, F] with valid lengths ``x_lens`` [B] -> the masked
    features; ``draws`` as ``draw_uniforms`` returns them (drawn from
    ``generator`` when None)."""
    B, T, F = x.shape
    if draws is None:
        draws = draw_uniforms(B, cfg, generator, x.device)
    fw, fs, tw, ts = (d.to(device=x.device, dtype=torch.float32) for d in draws)
    valid_t = (torch.arange(T, device=x.device)[None, :] < x_lens[:, None])[:, :, None]
    denom = torch.clamp(x_lens.to(x.dtype), min=1.0)[:, None]
    fill = (x * valid_t).sum(dim=1) / denom  # [B, F]

    lens_i = x_lens.to(torch.int32)
    fmask = _interval_mask(fw, fs, torch.full((B,), cfg.freq_mask_width, dtype=torch.int32,
                                              device=x.device),
                           F, torch.full((B,), F, dtype=torch.int32, device=x.device))[:, None, :]
    if cfg.adaptive_size_ratio > 0.0:
        t_widths = _floor_ratio(cfg.adaptive_size_ratio, lens_i)
    else:
        t_widths = torch.full((B,), cfg.time_mask_width, dtype=torch.int32, device=x.device)
    t_active = None
    if cfg.adaptive_number_ratio > 0.0:
        t_active = torch.clamp(_floor_ratio(cfg.adaptive_number_ratio, lens_i),
                               max=cfg.n_time_masks)
    tmask = _interval_mask(tw, ts, t_widths, T, lens_i, active=t_active)[:, :, None]
    out = torch.where(fmask | tmask, fill[:, None, :], x)
    # padding frames stay exactly zero (the length-recovery contract downstream)
    return torch.where(valid_t, out, x)
