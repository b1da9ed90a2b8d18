"""Two-pass n-best rescoring with the char LM.

Port of ``ss_asr_tpu/decode/rescore.py``: decode the n-best frontier once
(``beam_decode_nbest``, ideally with ``lm_weight=0`` so its scores are
purely acoustic), score every hypothesis with the LM once, then re-rank
under any number of weights on the host.  The LM term is the summed
log-probability of the hypothesis' characters plus its terminal EOS,
conditioned SOS-first, so ``asr_score + w * lm_score`` ranks by what a
w-weighted fused decode maximises, restricted to the n-best.  Plain PyTorch
(the JAX package has no kernel here).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.vocab import EOS_ID


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def lm_score(lm: charlm_mod.CharLM, toks: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """LM log-probability of token rows (characters + terminal EOS).

    toks [..., L] int (pad-filled, no EOS); lens [...] character counts.
    Returns [...] float32; a row of length 0 scores the bare EOS."""
    shape = toks.shape[:-1]
    L = toks.shape[-1]
    flat = toks.reshape(-1, L).astype(np.int64)
    flat_lens = lens.reshape(-1).astype(np.int64)
    # the terminal EOS at each row's length; L bucketed to 16, as JAX does
    padded = np.zeros((flat.shape[0], _round_up(L + 1, 16)), dtype=np.int64)
    padded[:, :L] = flat
    padded[np.arange(flat.shape[0]), flat_lens] = EOS_ID
    dev = lm.emb.weight.device
    ids = torch.as_tensor(padded, device=dev)
    with torch.inference_mode():
        logp = torch.log_softmax(charlm_mod.teacher_forced_unroll(lm, ids), dim=-1)
        per_char = torch.gather(logp, 2, ids[:, :, None])[..., 0]
        mask = torch.arange(ids.shape[1], device=dev)[None, :] <= torch.as_tensor(
            flat_lens, device=dev)[:, None]
        out = (per_char * mask).sum(dim=-1)
    return out.cpu().numpy().astype(np.float32).reshape(shape)


def rescore_nbest(
    toks: np.ndarray, lens: np.ndarray, asr_scores: np.ndarray, lm: charlm_mod.CharLM,
    weights: Iterable[float],
) -> Dict[float, Tuple[np.ndarray, np.ndarray]]:
    """Re-rank an n-best list ([B, n, L], [B, n], [B, n] as
    ``beam_decode_nbest`` returns them) under several LM weights with ONE LM
    pass -> ``{weight: (best [B] index into n, fused scores [B, n])}``."""
    lm_scores = lm_score(lm, toks, lens)
    out = {}
    for w in weights:
        fused = asr_scores + float(w) * lm_scores
        out[float(w)] = (np.argmax(fused, axis=-1), fused)
    return out
