"""Forced alignment, per-character timestamps, and hypothesis confidence.

Port of ``ss_asr_tpu/decode/align.py``.  Timing comes from a
forced-alignment pass: the attend-and-spell loop re-runs teacher-forced on
the decoded characters (``models.las.attend_and_spell``, whose loop is the
K9 kernel on the card), and each step's attention argmax is that
character's encoder frame.  The listener reduces time 8x at a 10 ms hop, so
encoder frame f starts at ``f * 8 * 0.010`` s.  Confidence is the same
pass's per-character log-probability under the decode-time distribution
(ASR log-softmax, plus ``lm_weight`` times the LM's when fusion was on),
summed (score) and averaged over the length (avg_logprob).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ss_asr_tpu_torch.models import charlm as charlm_mod
from ss_asr_tpu_torch.models import las
from ss_asr_tpu_torch.vocab import EOS_ID, SOS_ID

#: seconds of audio per encoder output frame: 8x pyramidal time reduction
#: at the 10 ms frontend hop
SECONDS_PER_ENC_FRAME = 8 * 0.010


@dataclasses.dataclass
class Hypothesis:
    """One decoded hypothesis with alignment and confidence.

    ``char_starts[i]`` is the start (seconds) of ``text[i]``,
    ``char_frames`` the encoder frame each character attended to most.
    ``score`` is the summed per-character log-prob under the decode-time
    (optionally LM-fused) distribution; ``avg_logprob = score / max(len,
    1)`` compares across lengths (0.0 = certain)."""

    text: str
    score: float
    avg_logprob: float
    char_starts: np.ndarray  # [n_chars] float32 seconds
    char_frames: np.ndarray  # [n_chars] int32 encoder frames
    #: per-character log-probs aligned with text (empty when the decode
    #: ran without the alignment pass — timestamps=False)
    char_logps: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.float32))

    def words(self) -> List[dict]:
        """Word spans from the character alignment, split on spaces:
        ``[{"word", "start", "end", "avg_logprob"}, ...]``.  A word ends one
        encoder frame after its last character's start; its avg_logprob is
        the mean of its characters' log-probs (the hypothesis confidence
        when the decode skipped the alignment pass)."""
        have_t = self.char_starts.shape[0] == len(self.text)
        have_p = self.char_logps.shape[0] == len(self.text)
        out: List[dict] = []
        i, n = 0, len(self.text)
        while i < n:
            if self.text[i] == " ":
                i += 1
                continue
            j = i
            while j < n and self.text[j] != " ":
                j += 1
            out.append({
                "word": self.text[i:j],
                "start": float(self.char_starts[i]) if have_t else 0.0,
                "end": (float(self.char_starts[j - 1]) + SECONDS_PER_ENC_FRAME) if have_t else 0.0,
                "avg_logprob": float(self.char_logps[i:j].mean()) if have_p else self.avg_logprob,
            })
            i = j
        return out


def force_align_from_memory(
    model: las.LAS, enc_h: torch.Tensor, enc_lens: torch.Tensor, ids: np.ndarray,
    lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Align decoded ids [B, L] (pad 0) on a listener memory ->
    ``(char_frames [B, L] int32, char_logp [B, L] float32)``; positions past
    a row's length are meaningless."""
    B, L = ids.shape
    dev = enc_h.device
    ids_t = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
    with torch.inference_mode():
        teacher = torch.cat([torch.full((B, 1), SOS_ID, dtype=torch.long, device=dev), ids_t], 1)
        logits, att = las.attend_and_spell(model, enc_h, enc_lens, L, teacher=teacher)
        logp = torch.log_softmax(logits, dim=-1)
        if lm is not None and lm_weight:
            # the LM's input at step t is the character of step t - 1 (SOS at 0)
            lm_logits = charlm_mod.teacher_forced_unroll(lm, ids_t)
            logp = logp + lm_weight * torch.log_softmax(lm_logits, dim=-1)
        char_logp = torch.gather(logp, 2, ids_t[:, :, None])[..., 0]
        char_frames = torch.argmax(att, dim=-1).to(torch.int32)
    return char_frames.cpu().numpy(), char_logp.cpu().numpy()


def force_align(
    model: las.LAS, x: torch.Tensor, x_lens: torch.Tensor, ids: np.ndarray,
    lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Align decoded ids [B, L] (pad 0) on fbanks x [B, T, feat] ->
    (char_frames [B, L], char_logp [B, L]); positions past a row's length
    are meaningless."""
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
    return force_align_from_memory(model, enc_h, enc_lens, ids, lm, lm_weight)


def force_align_nbest(
    model: las.LAS, x: torch.Tensor, x_lens: torch.Tensor, ids: np.ndarray,
    lm: Optional[charlm_mod.CharLM] = None, lm_weight: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Align an n-best list ids [B, n, L] on fbanks x [B, T, feat]: the
    listener runs once per utterance, its memory repeated n-fold ->
    (char_frames [B, n, L], char_logp [B, n, L])."""
    B, n, L = ids.shape
    with torch.inference_mode():
        enc_h, enc_lens = las.listener_apply(model.encoder, x, x_lens)
        enc_h = enc_h.repeat_interleave(n, 0)
        enc_lens = enc_lens.repeat_interleave(n, 0)
    frames, logp = force_align_from_memory(model, enc_h, enc_lens, ids.reshape(B * n, L), lm,
                                           lm_weight)
    return frames.reshape(B, n, L), logp.reshape(B, n, L)


def build_hypotheses(
    mapper, ids: np.ndarray, id_lens: np.ndarray, char_frames: np.ndarray,
    char_logp: np.ndarray,
) -> List[Hypothesis]:
    """Per-row Hypothesis records from the alignment outputs.  The text is
    built id by id so ``char_starts[i]`` is exactly ``text[i]``'s time:
    SOS/EOS ids inside the decoded span count in the score (the model
    emitted them) but make no character, as ``Mapper.translate`` drops
    them."""
    out = []
    for b in range(ids.shape[0]):
        n = int(id_lens[b])
        chars: List[str] = []
        frames: List[int] = []
        logps: List[float] = []
        for i in range(n):
            c = int(ids[b, i])
            if c in (SOS_ID, EOS_ID):
                continue
            chars.append(mapper.r_mapping[c])
            frames.append(int(char_frames[b, i]))
            logps.append(float(char_logp[b, i]))
        fr = np.asarray(frames, dtype=np.int32)
        score = float(char_logp[b, :n].sum()) if n else 0.0
        out.append(Hypothesis(
            text="".join(chars),
            score=score,
            avg_logprob=score / max(n, 1),
            char_starts=(fr * SECONDS_PER_ENC_FRAME).astype(np.float32),
            char_frames=fr,
            char_logps=np.asarray(logps, dtype=np.float32),
        ))
    return out
