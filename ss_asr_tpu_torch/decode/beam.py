"""Batched beam-search decoding with char-LM shallow fusion.

Port of ``ss_asr_tpu/decode/beam.py`` (``beam_decode``,
``beam_decode_nbest``, ``_backtrack``).  K hypotheses per utterance advance
together; each step's fused scores are ``log_softmax(ASR) + lm_weight *
log_softmax(LM)`` (the LM term only with an LM), summed over the
hypothesis, with an optional length normalisation at the end.  The
frontier loop is ``ops.kernels.beam.beam_device``: the CUDA kernel on the
card, ``beam_scan_plain`` beside it (the port of ``_beam_scan``) on the
CPU.  Both stop once every beam is done, which gives the fixed-trip scan's
results (a finished beam extends by SOS at no cost, so later steps cannot
reorder the frontier).  The backtrack over (parent, token) pointers runs
on the host, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.ops.kernels.beam import beam_device
from ss_asr_tpu_torch.vocab import EOS_ID


def _beam_frontier(model, x, x_lens, K, max_steps, lm, lm_weight, length_norm):
    """Listener + frontier -> numpy (toks [T,B,K], parents, scores [B,K])."""
    use_lm = lm is not None and lm_weight != 0.0
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
        comp_h = las.attention_precompute(model.attention, enc_h)
        toks, parents, scores, _, hyp_len = beam_device(
            model, enc_h, comp_h, enc_lens, K, max_steps, lm if use_lm else None, lm_weight)
        toks, parents, scores, hyp_len = (t.cpu().numpy() for t in (toks, parents, scores,
                                                                    hyp_len))
    if length_norm:
        scores = scores / np.maximum(hyp_len, 1)
    return toks, parents, scores


def _trace(toks, parents, b, k):
    """The token sequence ending in beam k of row b, cut at its first EOS."""
    seq = []
    for t in range(toks.shape[0] - 1, -1, -1):
        seq.append(int(toks[t, b, k]))
        k = int(parents[t, b, k])
    seq.reverse()
    clean = []
    for c in seq:  # frozen-beam pads only ever follow the EOS
        if c == EOS_ID:
            break
        clean.append(c)
    return clean


def _backtrack(toks, parents, final_scores, max_steps):
    """Host-side pointer chase: the best beam per sample -> (tokens
    [B, max_steps] pad-filled, lengths [B])."""
    _, B, _ = toks.shape
    out = np.zeros((B, max_steps), dtype=np.int32)
    lengths = np.zeros((B,), dtype=np.int32)
    for b in range(B):
        # finished beams already paid their EOS cost, so the highest score wins
        clean = _trace(toks, parents, b, int(np.argmax(final_scores[b])))
        lengths[b] = len(clean)
        out[b, : len(clean)] = clean
    return out, lengths


def beam_decode(
    model: las.LAS, x: torch.Tensor, x_lens: torch.Tensor, beam_size: int = 8,
    max_steps: int = 200, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
    length_norm: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """fbanks [B, T, feat] -> (tokens [B, max_steps] int32 pad-filled,
    lengths [B]).  ``length_norm`` picks the final hypothesis by score /
    length instead of the raw sum of log-probs."""
    toks, parents, scores = _beam_frontier(model, x, x_lens, beam_size, max_steps, lm,
                                           lm_weight, length_norm)
    return _backtrack(toks, parents, scores, max_steps)


def beam_decode_nbest(
    model: las.LAS, x: torch.Tensor, x_lens: torch.Tensor, beam_size: int = 8,
    max_steps: int = 200, lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
    length_norm: bool = False, n_best: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The whole frontier, for rescoring: ``(tokens [B, n, max_steps],
    lengths [B, n], scores [B, n])`` with ``n = min(n_best or beam_size,
    beam_size)`` hypotheses per sample, by descending (optionally
    length-normalised) score."""
    if n_best is not None and n_best < 1:
        raise ValueError(f"n_best must be >= 1, got {n_best}")
    n = beam_size if n_best is None else min(n_best, beam_size)
    toks, parents, scores = _beam_frontier(model, x, x_lens, beam_size, max_steps, lm,
                                           lm_weight, length_norm)
    B = toks.shape[1]
    out = np.zeros((B, n, max_steps), dtype=np.int32)
    lengths = np.zeros((B, n), dtype=np.int32)
    out_scores = np.zeros((B, n), dtype=np.float32)
    for b in range(B):
        for j, k in enumerate(np.argsort(-scores[b])[:n]):
            clean = _trace(toks, parents, b, int(k))
            lengths[b, j] = len(clean)
            out[b, j, : len(clean)] = clean
            out_scores[b, j] = scores[b, k]
    return out, lengths, out_scores
