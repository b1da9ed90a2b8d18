"""Per-timestep MLP discriminator for adversarial listener training.

Port of ``ss_asr_tpu/models/discriminator.py``: Linear(in, 256) -> ReLU ->
Linear(256, 256) -> ReLU -> Linear(256, 1) -> sigmoid, applied to every time
step of the text encoder's output ("real") or the listener's ("fake").
``Discriminator.state_dict()`` has the reference's keys ``core.{0,2,4}.*``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    in_dim: int = 512
    hidden_dim: int = 256

    @classmethod
    def from_dict(cls, d: dict) -> "DiscriminatorConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        self.core = nn.Sequential(
            nn.Linear(cfg.in_dim, cfg.hidden_dim), nn.ReLU(),
            nn.Linear(cfg.hidden_dim, cfg.hidden_dim), nn.ReLU(),
            nn.Linear(cfg.hidden_dim, 1))


def discriminate(p: Discriminator, x: torch.Tensor) -> torch.Tensor:
    """[B, S, in_dim] -> [B, S] sigmoid scores in (0, 1)."""
    return torch.sigmoid(p.core(x))[..., 0]
