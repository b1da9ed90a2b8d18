"""Character-level language model (2x GRU) for shallow fusion.

Port of ``ss_asr_tpu/models/charlm.py``: decode-time stepping, the
teacher-forced unroll with scheduled sampling (training, alignment and
rescoring read it) and free-running generation.  The random draws of both
are inputs or come from an explicit ``torch.Generator`` (``jax.random``'s
streams cannot be reproduced).
``CharLM.state_dict()`` has the reference CharLM's keys (and those of
``export_charlm``): ``emb.weight``, ``layer_{1,2}.*`` (GRU cells), ``out.*``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops import rnn
from ss_asr_tpu_torch.vocab import SOS_ID, VOCAB_SIZE


@dataclasses.dataclass(frozen=True)
class CharLMConfig:
    vocab_size: int = VOCAB_SIZE
    hidden_size: int = 128
    tf_rate: float = 0.9

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


def init_state(batch: int, cfg: CharLMConfig, device,
               dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros(batch, cfg.hidden_size, device=device, dtype=dtype)
    return (z, z)


def step(
    p: CharLM, ids: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One LM step: ids [B] -> (logits [B, V], new state)."""
    h1, h2 = state
    h1 = rnn.gru_step(p.layer_1, rnn.embed(p.emb, ids), h1)
    h2 = rnn.gru_step(p.layer_2, h1, h2)
    return rnn.linear(p.out, h2), (h1, h2)


def teacher_forced_unroll(
    p: CharLM, labels: torch.Tensor, tf_draws: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None, first_input: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unroll with scheduled sampling: labels [B, L] -> logits [B, L, V].

    The input at step 0 is ``first_input`` (SOS by default); after step t
    the unroll feeds ``labels[:, t]`` where ``tf_draws[t]`` is 1 and the
    argmax of ``logits + gumbel[t]`` where it is 0.  Without ``tf_draws``
    every step feeds the label; without ``gumbel`` the noise is zero.  The
    choice is a ``torch.where`` on the ids, so draws on the card cost no
    host sync."""
    B, L = labels.shape
    dev = labels.device
    ids = first_input if first_input is not None else torch.full((B,), SOS_ID, dtype=torch.long,
                                                                 device=dev)
    state = init_state(B, p.cfg, dev, p.out.weight.dtype)
    out = []
    for t in range(L):
        logits, state = step(p, ids.long(), state)
        out.append(logits)
        if tf_draws is None:
            ids = labels[:, t]
        else:
            noise = gumbel[t] if gumbel is not None else 0.0
            ids = torch.where(tf_draws[t] > 0.5, labels[:, t].long(),
                              torch.argmax(logits + noise, dim=-1))
    return torch.stack(out, dim=1)


@torch.no_grad()
def generate(
    p: CharLM, cfg: CharLMConfig, generator: Optional[torch.Generator], length: int,
    temp: float = 0.8, start_ids: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Free-running generation with temperature sampling -> [length] ids
    (prompt not included), on the LM's device.

    ``start_ids`` [S] is the prompt (``[SOS]`` by default): its first S - 1
    ids are consumed, then each step feeds the last id and samples the next
    as ``argmax(logits / temp + gumbel[t])``, the Gumbel-max form of
    ``jax.random.categorical``.  ``gumbel`` [length, V] is drawn from
    ``generator`` unless given.  The loop keeps the ids on the device: no
    host sync per character."""
    dev = p.out.weight.device
    if start_ids is None:
        start_ids = torch.tensor([SOS_ID], dtype=torch.long)
    start_ids = start_ids.to(dev).long()
    if gumbel is None:
        gumbel = las.gumbel_noise((length, cfg.vocab_size), generator)
    gumbel = gumbel.to(dev)
    state = init_state(1, cfg, dev, p.out.weight.dtype)
    for i in range(start_ids.shape[0] - 1):
        _, state = step(p, start_ids[i : i + 1], state)
    ids = start_ids[-1:]
    out = []
    for t in range(length):
        logits, state = step(p, ids, state)
        ids = torch.argmax(logits / temp + gumbel[t], dim=-1)
        out.append(ids)
    return torch.cat(out).to(torch.int32) if out else torch.zeros(0, dtype=torch.int32, device=dev)
