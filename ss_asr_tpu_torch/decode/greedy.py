"""Batched greedy decoding with optional char-LM shallow fusion.

Port of ``ss_asr_tpu/decode/greedy.py`` (``greedy_decode``,
``fused_decode_from_memory``, ``greedy_decode_early_exit`` and
``_finalize``; the three return the same tokens).  At each step the emitted id is the argmax of
``log_softmax(ASR logits) + lm_weight * log_softmax(LM logits)`` (the LM
term only with an LM), it is fed back, and decoding stops at EOS or after
``max_steps``.  The step loop is ``ops.kernels.decode.greedy_decode``: the
CUDA kernel on the card, the plain early-exit loop on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops.kernels.decode import greedy_decode as greedy_decode_ids
from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID


def _finalize(toks: torch.Tensor, max_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens with EOS and all after it set to SOS, lengths = chars
    before the first EOS, or max_steps without one)."""
    is_eos = toks == EOS_ID
    any_eos = is_eos.any(dim=1)
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
    lengths = torch.where(any_eos, first_eos, torch.full_like(first_eos, max_steps)).to(torch.int32)
    pos = torch.arange(max_steps, device=toks.device)[None, :]
    toks = torch.where(pos < lengths[:, None], toks, torch.full_like(toks, SOS_ID))
    return toks, lengths


def fused_decode_from_memory(
    model: las.LAS,
    enc_h: torch.Tensor,
    enc_lens: torch.Tensor,
    max_steps: int,
    lm: Optional[charlm_mod.CharLM] = None,
    lm_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode from listener memory enc_h [B, S, D] -> (tokens [B, max_steps]
    int32, lengths [B] int32): ``lengths`` counts the characters before
    EOS; EOS and what follows are SOS (0), which ``Mapper.translate``
    strips."""
    comp_h = las.attention_precompute(model.attention, enc_h)
    toks = greedy_decode_ids(model, enc_h, comp_h, enc_lens, max_steps,
                             lm if lm_weight != 0.0 else None, lm_weight)
    return _finalize(toks, max_steps)


def greedy_decode(
    model: las.LAS,
    x: torch.Tensor,
    x_lens: torch.Tensor,
    max_steps: int = 200,
    lm: Optional[charlm_mod.CharLM] = None,
    lm_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fbanks [B, T, feat] -> (tokens [B, max_steps] int32, lengths [B])."""
    enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
    return fused_decode_from_memory(model, enc_h, enc_lens, max_steps, lm, lm_weight)


#: the JAX package's early-exit variant: the same tokens
greedy_decode_early_exit = greedy_decode
