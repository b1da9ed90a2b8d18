"""Character-level language model (2x GRU) for shallow fusion.

Port of ``ss_asr_tpu/models/charlm.py`` (decode-time stepping).
``CharLM.state_dict()`` has the reference CharLM's keys (and those of
``export_charlm``): ``emb.weight``, ``layer_{1,2}.*`` (GRU cells), ``out.*``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.vocab import VOCAB_SIZE


@dataclasses.dataclass(frozen=True)
class CharLMConfig:
    vocab_size: int = VOCAB_SIZE
    hidden_size: int = 128

    @classmethod
    def from_dict(cls, d: dict) -> "CharLMConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class CharLM(nn.Module):
    def __init__(self, cfg: CharLMConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.emb = nn.Embedding(cfg.vocab_size, h)
        self.layer_1 = nn.GRUCell(h, h)
        self.layer_2 = nn.GRUCell(h, h)
        self.out = nn.Linear(h, cfg.vocab_size)


def init_state(batch: int, cfg: CharLMConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros(batch, cfg.hidden_size, device=device)
    return (z, z)


def step(
    p: CharLM, ids: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One LM step: ids [B] -> (logits [B, V], new state)."""
    h1, h2 = state
    h1 = rnn.gru_step(p.layer_1, rnn.embed(p.emb, ids), h1)
    h2 = rnn.gru_step(p.layer_2, h1, h2)
    return rnn.linear(p.out, h2), (h1, h2)
